#!/usr/bin/env python3
"""Drive nimblephysics_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit;
  2. build the APGD seed kernel from the checkout's CUDA source, with
     ptxas's registers and spills for each instantiation;
  3. the kernel against its plain PyTorch version, float32 on the card, on
     (a) the LCP the engine assembles for half-cheetahs on the ground and
     (b) a seeded random LCP of the same shape, with times and the bound;
     the card's whole seed (kernel + the re-attached projected-gradient
     step) against the same step on the plain version; and, which must
     miss the tolerance, the plain version with one Nesterov step fewer
     and the kernel's output without the step; the launch plan, resident
     warps per SM, the time at 4096 and 8192 worlds, and the kernel
     against its plain version and its time on the box-stack LCP (48
     contacts, n = 144, r = 18);
  4. the forward rollout: 4096 half-cheetahs, SolverConfig.throughput(),
     float32, warm-started impulses, 100 steps (as bench.py runs the JAX
     package), with the kernel's launch count over the timed call;
  5. one step on the card from the rollout's final contact state, for the
     first 256 worlds, against (a) the port's float64 CPU path and (b) the
     CPU's float32 path with the card's seed (apgd_plain + the same
     projected-gradient step), which every world must match;
  6. the default SolverConfig, forward: the kernel with its 16-sweep
     Gauss-Seidel polish (K1b) against apgd_plain + pgs_plain on the
     engine's LCP and on the seeded random LCP, with times and the bound,
     and a planted fault (the plain polish one sweep short, or with its
     last sweep in reverse row order) that must miss the tolerance, and as
     in phase 3 the plan, occupancy, 8192 worlds and the box-stack LCP;
     then the 100-step warm-started rollout at this config;
  7. training: train_step_batched (4096 worlds, horizon 50, hidden 64,
     float32) under the default config and under throughput(), one
     warm-up call (horizon 10) and one timed call each, with the kernel's launches,
     seconds per training step, fwd+bwd env-steps/s and peak memory;
  8. one short training step (64 worlds, horizon 4) on the card against
     the port's float64 CPU path from the same start and weights: the
     cosine and relative error of the policy gradient;
  9. the kernel on the box-stack path's own LCPs (the default
     SolverConfig, B = 4096, from a warm state of benchmarks/
     boxstack_bench.py's start): the 2-box (n = 72, r = 12) and 3-box
     (n = 144, r = 18) stacks, the 5-box stack's capped LCP (contact_cap
     48: n = 144, r = 30) and one island of the islands scene (n = 24,
     r = 6), warm- and cold-started; K1 and K1b against their plain
     versions, and a planted fault (a dropped contact) that must miss the
     limits; a seeded random LCP of the same shape against the plain
     version in float32 and float64; times, bounds, the launch plan,
     resident warps per SM, registers and spills; then the same on the
     10- and 20-box legs' capped LCPs (contact_cap 96: n = 288, r = 60;
     contact_cap 192: n = 576, r = 120), which take the kernel's wide
     tier (F in one CTA's shared memory, and in a cluster of two CTAs'),
     with its placement (CTAs a cluster, shared memory a CTA, worlds a
     SM, registers and spills) and a second planted fault (one in-block
     Gram term of its polish dropped), and the refusal, with its numbers
     and no launch, of the 10-box stack's uncapped LCP (n = 1320), past
     the wide tier's capacity;
 10. the box-stack rollouts (boxstack_bench.py's legs: 2 and 3 boxes, 5
     boxes under contact_cap 48; 4096 worlds, 100 warm-started steps,
     the default SolverConfig): env-steps/s, K1b launches (one a step),
     CUDA kernel launches per step, and the stack standing
     (tests/test_stacks.py's limits); on the 5-box leg the worlds with
     more penetrating slots than the cap;
 11. one 3-box step at 256 worlds from phase 10's final state, card
     float32 against the CPU's float32 path with the card's seed (every
     world) and the CPU's float64 path (a share of worlds);
 12. the islands scene (3 boxes, box-box pairs filtered off, 3 islands):
     4096 worlds, 100 steps, three K1b launches a step; one step against
     the same world solved as one LCP (contact_islands off);
 13. a short VJP through remat_step on the 2-box stack (64 worlds x 4
     steps), card float32 against the CPU's float64 path;
  then K1/K1b on jump_worm's, catapult's and the motor scenes' LCPs
 (14), their rollouts (15), training on them (16) and card vs CPU on
 their steps (17);
 18. the 10- and 20-box legs (2048 and 1024 worlds, 50 steps from
     boxstack_bench.py's start): ms a step, env-steps/s, CUDA launches a
     step, peak memory, one K1b launch a step and never the plain seed,
     states finite and the stack standing; one step of 64 worlds, card vs
     the CPU's float32 path with the card's seed;
 19. per-world body parameters (masses, COMs, scales, jittered as
     tests/test_batched.py jitters them): a half-cheetah step card vs the
     CPU's float32 path, a remat_step VJP in masses and scales card vs
     the CPU's float64 path, and state_step with masses;
 20. the single-world timestep (neural/timestep.py, float64 by default):
     tests/test_golden_values.py's pendulum accelerations and resting-box
     normal impulse on the card; a 100-step half-cheetah rollout from
     bench.py's start on the CPU in float64, and a card step from every
     10th of its states against the CPU's (with a planted fault, the LCP's
     seed alone, that must miss the impulse limit); one step of box_drop
     and of the 3-box stack; the card's own float64 and float32 rollouts
     (ms a step, CUDA launches a step; float32 held to the CPU's float32
     path and to the float64 rollout's deepest contact); a 4-step VJP in
     (q, v, control, masses), card vs CPU; and no launch of the seed
     kernel (the single-world path runs none);
 21. the BackpropSnapshot Jacobians (neural/backprop_snapshot.py, float64):
     on the half-cheetah at the rollout state of phase 20 whose
     cold-started step has the most live impulse rows, box_drop landing
     on one corner and the verification battery's sphere stack, the
     state, action, force-vel and mass-vel Jacobians and backprop_state,
     card vs CPU, with a planted fault (the impulses detached: no contact
     gradient) that must miss the limit; J^T g against backprop_state on
     the card; box_drop's state Jacobian against Ridders FD stepped on
     the card; float32 card vs CPU (printed); ms and CUDA launches of the
     forward pass, each Jacobian and backprop_state; no seed launch;
 22. the half-cheetah on a heightmap (terrain_cheetah: the model's ground
     plane replaced by 64 x 64 cells of 0.1 m, bumps up to 3 cm from the
     seed), the default SolverConfig, 4096 worlds, float32: 100 warm-up
     and 100 timed steps from bench.py's start lifted by the highest
     bump (env-steps/s, one K1b launch a step, never the plain seed, CUDA
     launches a step); K1 and K1b on the terrain LCP (n = 84, r = 9, the
     narrow tier) against the plain version in float64 with a dropped
     contact that must miss the limits, and the same on the settled LCP;
     one step from the settled state on every world (step_check): the
     card's LCP residual on the CPU's float64 LCP against the CPU
     float32 step's, and its v against the CPU's float64 update by its
     impulses, with planted faults (the gaps in z and v to the CPU's
     float32 step printed); one train_step_batched at 4096 worlds x horizon 20, and its policy
     gradient at 64 worlds card f32 vs CPU f64;
 23. at 1024 worlds, card vs CPU as phase 22's step_check: the cube
     mesh on the ground, a cube mesh on a slab under an octahedron mesh,
     a sphere, a capsule, a box and a sphere set on a sloped heightmap
     (one K1b launch a step each), the spline-driven custom joint and the
     four biomechanics joints; the single-world step in float64 on a heightmap
     and on the custom joint, card vs CPU; a state Jacobian across a live
     heightmap contact against Ridders FD on the card;
 24. trajectory optimisation (trajectory/, float64, card vs CPU at 1e-8):
     a half-cheetah MultiShot of 2 shots x 3 steps from phase 20's
     rollout state 90 (live contact rows) under its controls: loss, knot
     constraints, the loss gradient, the per-step constraint and
     final-state Jacobians, with a planted fault (the first shot's A_t and
     B_t without the contact rows' gradient); ms of the rollout, the
     gradient and the per-step Jacobians, CUDA launches of a shot and of
     one step's Jacobians; Gauss-Newton, 1 outer x 1 inner
     iteration on 2 x 2 steps; the cartpole's augmented Lagrangian (2 x 3
     iterations) and its ms a step with the gradient;
 25. MPC and SSID (realtime/, float64, card vs CPU at 1e-8): the cartpole
     MPC loop of examples/04_mpc.py (4 control steps; horizon 5, 3 Adam
     iterations a replan) moving the cart toward its target, and its
     replan thread started and stopped; SSID recovering the heavier
     cart's mass (8-step window, 10 iterations, within 8%); one
     half-cheetah optimize_plan (horizon 5, 2 iterations), with a planted
     fault (the CPU's replan with the impulses detached) that must miss;
 26. BatchedEnv (simulation/env.py) over the half-cheetah, the default
     config, float32, 4096 worlds: 50 env steps with the horizon at 25
     (every world resets at steps 25 and 50), env-steps/s, one K1b launch
     a step and never the plain seed, CUDA launches an env step; K1 and
     K1b on the env's LCP against the plain version with a dropped
     contact that must miss; one env step on every world by step_check;
     the gradient of a linear policy's 5-step return at 64 worlds, card
     f32 vs CPU f64;
 27. marker fitting (biomechanics/, float64, card vs CPU at 1e-8) on the
     bundled humanoid at full width (38 dofs, 19 bodies, 25 markers):
     256 frames of seeded synthetic mocap (poses 0.1 rad about zero, true
     scales inside the bounds, 2% of the markers occluded); the IK
     initializer, MarkerFitter's Gauss-Newton fit (10 outer x 8 IK
     iterations) and a 5-iteration Adam fit with the symmetry scale
     groups and an anthropometric prior, card vs CPU, with a planted
     fault (offsets not scaled by their body) that must miss; the fit's
     mean marker error under a limit; ms and CUDA launches of an outer
     iteration, and one IK iteration's launches at 64 and 256 frames,
     which must be equal; skeleton_height and skeleton_lowest_point with
     their scale gradients, card vs CPU; one single-world step of
     human_standing at phase 20's limits; no seed launch;
  then a JSON line per kernel and, last, {"ok": true, "device": ...}.
A timed training step is preceded by a warm-up training step of
WARMUP_STEPS steps, and phase 6's timed rollout by WARMUP_STEPS steps;
phase 20 times its float64 card step over SW_F64_TIMED steps. Each phase
prints the seconds since the start when it ends.

`python3 chip_smoke.py --only 9,18,19,20,21,22,23,24,25,26,27` runs phases
1-2 and the listed ones of 9 and 18 to 27, and prints no result line (for
iterating on them).

Matmuls run in full float32: TF32 is switched off for matmuls and cuDNN,
since F = J L^-T and the pinned solves would otherwise keep only ~3
digits and the stated float32 tolerances would not hold.

`make_engine`, `rollout_start` and `rollout` build the forward path, and
`make_box_engine`, `box_start` and `islands_world` the box-stack path;
the profiler (profile_torch_step.py) imports them from here.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

BATCH = 4096
STEPS = 100
# The horizon of the training step before a timed one, and the steps before
# a timed rollout whose final state no later check reads: they warm the
# allocator and the kernel's first launch (eager PyTorch has nothing to
# compile). Phases 4, 15 and 22 keep STEPS warm-up steps: phases 5, 17 and
# 22's step_check read the settled state after them.
WARMUP_STEPS = 10
SEED = 0
CHECK_WORLDS = 256
# Peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet): float32
# outside the tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Kernel vs plain, float32, relative to a world's impulse scale
# 1 + max|z|. Measured on the H100 (PERF.md): 2.0e-7 on the engine's LCP
# and 1.0e-6 on the random one with a warp per world (1.7e-7 and 1.1e-6
# with one thread per world); the limit is ~10x the larger. The plain
# seed with one Nesterov step fewer must land above it.
KERNEL_TOL = 1e-5
# Card f32 vs CPU f64, one step from the same state. q_next = q + dt v
# integrates the input v (parallel updates): float32 rounding only.
DQ_TOL = 1e-6
# Card vs the CPU's float32 path with the card's seed: the same algorithm
# and precision, so every world agrees to float32 rounding, impulses
# relative to 1 + max|z| and v relative to 1 + max|v| (M^-1 amplifies
# the impulses' rounding at the light distal joints). Read on the H100
# (PERF.md): 3.9e-6 and 1.1e-4; the limits are ~10x and ~4x those.
DZ_SAME = 4e-5
DV_SAME = 5e-4
# v_next, card vs the CPU float64 path: the ladder's validity test reads
# 1000 eps of the working dtype, so a world near its edge can take
# another rung in float64 than in float32, and its v differs by O(1e-2)
# or more. Read on the H100 (PERF.md): 5 of 256 worlds beyond DV_TOL,
# the largest by 7.0e-2; DV_SHARE and DV_MAX allow ~3x and ~4x that.
DV_TOL = 1e-3
DV_SHARE = 0.94
DV_MAX = 0.3
# K1b (kernel + 16 sweeps of polish) vs apgd_plain + pgs_plain, float32,
# relative to 1 + max|z|. The sweeps are sequential, so the two summation
# orders' rounding carries from row to row; on the random LCP (A = F F^T
# of rank 9 in 60 rows, z up to ~27) nothing damps it along A's null
# space. Read on the H100 (PERF.md): 4.3e-7 on the engine's LCP, 1.0e-5
# on the random one with a warp per world (2.4e-7 and 1.25e-5 with one
# thread per world); the limit is ~8x the larger. The plain polish one
# sweep short lands at 5.9e-3 and 9.2e-2.
PGS_TOL = 1e-4
# Training: bench.py's width, half its horizon of 100.
TRAIN_HORIZON = 50
HIDDEN = 64
LEARNING_RATE = 1e-3
# Phase 8: card f32 vs CPU f64 policy gradient, 64 worlds, horizon 4,
# from bench.py's start. Read on the H100 (PERF.md): |dg|/|g| 2.0e-6
# (no world takes another ladder rung in float32 there), cosine 1 to 8
# digits; the limits allow 10x the error.
GRAD_WORLDS = 64
GRAD_HORIZON = 4
GRAD_COS = 0.999999
GRAD_REL = 2e-5
# The kernel alone is also timed at 8192 worlds (the README's best batch)
# and on the box-stack LCP the JAX package names at lcp_pallas.py:207-210:
# 48 contacts of a normal and two friction rows, n = 144, rank 18.
WIDE_BATCH = 8192
BOX_CONTACTS = 48
BOX_RANK = 18
# The box-stack path: benchmarks/boxstack_bench.py's legs at 4096 worlds,
# (boxes, contact_cap); its 10- and 20-box legs are BOX_WIDE_LEGS below.
BOX_LEGS = ((2, None), (3, None), (5, 48))
# The 10- and 20-box legs (boxes, contact_cap, worlds): their capped LCPs
# (n = 288, r = 60 and n = 576, r = 120) take the kernel's wide tier. The
# 10-box stack without its cap (n = 1320) is past the wide tier's
# capacity (n <= 1024) and must be refused.
BOX_WIDE_LEGS = ((10, 96, 2048), (20, 192, 1024))
TOO_WIDE_LEG = (10, None)
# Phase 18: one step of WIDE_CHECK_WORLDS worlds of each wide leg, card vs
# the CPU's float32 path with the card's seed: impulses relative to
# 1 + max|z|, v to 1 + max|v|. Read on the H100 (PERF.md): 2.6e-7 and
# 8.5e-7 (10 boxes), 9.6e-7 and 1.4e-5 (20 boxes: the top box, 0.85 mm
# wide, has rotational inertia 1.2e-7, so M^-1 amplifies the impulses'
# rounding); the limits are ~10x the larger.
WIDE_CHECK_WORLDS = 64
WIDE_DZ_SAME = 1e-5
WIDE_DV_SAME = 1.5e-4
# Phase 19's step starts after STEPS steps under the jittered bodies, so
# that it holds the contact LCP and K1b: at least this share of its
# worlds must carry an impulse (phase 4's start read 4091/4096).
BODY_ACTIVE_SHARE = 0.75
# Phase 19's VJP from that state, card f32 against the CPU's float32 path
# with the card's seed, |dg|/|g| in every world. Set before any reading;
# read on the H100 (PERF.md): 2.5e-4 (the half-cheetah's ridged pinned
# solve amplifies rounding in the mass directions). Against the CPU float64
# path a world near a ladder rung's edge takes another rung in float32
# (phase 5), and over 4 steps of contact that moves its gradient by O(1):
# read on the H100, 39 of 64 worlds within GRAD_REL of it, for the card
# and for the CPU's own float32 path alike, so that share is shown, not
# held.
BODY_VJP_SAME = 5e-4
YAW_JITTER = 0.2
# tests/test_stacks.py's standing limits (200 steps, float64): the top
# box's height within 8e-3 of its start, every |v| below 5e-2.
STAND_DZ = 8e-3
STAND_V = 5e-2
# Phase 18 rolls the wide legs WIDE_STEPS steps (the top box of 20 moves
# 4.6e-3 in 100; PERF.md).
WIDE_STEPS = 50
# Phase 11: one 3-box step from phase 10's final state, card vs the CPU's
# float32 path with the card's seed, every world: impulses relative to
# 1 + max|z|, v to 1 + max|v|. Read on the H100 (PERF.md): 1.9e-8 and
# 1.0e-7; the limits are ~10x. Against the CPU's float64 path: every world
# within DV_TOL in v and a share of them within BOX_DV_CLOSE; read: the
# largest |dv| 7.6e-8, so all 256 within 1e-6; the share allows 2 worlds
# to take another SAT axis or ladder rung there.
BOX_DZ_SAME = 2e-7
BOX_DV_SAME = 1e-6
BOX_DV_CLOSE = 1e-6
BOX_DV_SHARE = 0.99
# Phase 12: the islanded step vs the one-LCP step on the card, relative
# as above. Read on the H100 (PERF.md): q equal, v 5.7e-8, impulses
# 9.3e-10 (the pinned solves agree; the seeds' step sizes differ); the
# limits are ~10-20x.
ISL_DQ = 1e-7
ISL_DV = 1e-6
ISL_DZ = 2e-8
# Phase 13: 2-box VJP through remat_step, card f32 vs CPU f64. Read on
# the H100 (PERF.md): cosine 1 to 8 digits, |dg|/|g| 1.3e-7; the limits
# allow ~15x the error.
VJP_COS = 0.999999
VJP_REL = 2e-6
VJP_WORLDS = 64
VJP_STEPS = 4
# Seeded random LCPs (phases 9 and 14): z is shown; held are u = F^T z
# (relative to 1 + max|u|) and the natural-map residual. Read on the H100
# (PERF.md): K1 gaps up to 8.5e-6 in u and 5.4e-6 in the residual; K1b
# (16 sweeps in float32 from an unconverged seed) up to 1.4e-3 and 1.2e-3
# on the island's shape, where z reads 6.6e-4 and the plain version moves
# 1.0e-3 between float32 and float64: u and the residual move as much as
# z, so z's drift is not along F's null space. The limits are ~7x the
# largest reading; the planted faults of phases 3, 6 and 9 land at
# 2.4e-3 to 9.2e-2 on z.
RAND_U_TOL = 1e-2
RAND_RES_TOL = 1e-2
# Phase 15: tests/test_reference_workloads.py's settling (600 steps there,
# SETTLE_STEPS here; no torque) and arm-torque (300 steps there, TORQUE_STEPS here) checks at
# SETTLE_WORLDS worlds; tests/test_motors.py's limits after STEPS steps:
# the ball's anchor within 5e-3, the weld's pose within 2e-3; the servo's
# velocity to its force-limited value, the mimic's ratio and the locked
# joint's rest to float32 rounding (read 1.9e-7, 3.0e-8 and 1.9e-9).
SETTLE_WORLDS = 256
SETTLE_STEPS = 400
TORQUE_STEPS = 100
BALL_DRIFT = 5e-3
WELD_DRIFT = 2e-3
SERVO_REL = 1e-4
MIMIC_ABS = 1e-5
LOCKED_ABS = 1e-5
# Phase 17: one step of the slice's worlds, card vs the CPU's float32 path
# with the card's seed, every world: impulses relative to 1 + max|z|, v to
# 1 + max|v|. Read on the H100 (PERF.md): up to 3.5e-6 and 1.8e-6 (the
# five-shape world; jump_worm 4.3e-7 and 6.5e-7, the ball 1.5e-7 and
# 1.8e-6); the limits are ~10x. q against the CPU's float64 path as
# DQ_TOL (read up to 3.3e-8). The no-row worlds against float64 (read
# 2.9e-8 in q, 6.0e-7 in v) and the servo VJP (read |dg|/|g| 8.9e-8,
# cosine 1 to 8 digits): the limits are ~10-35x.
SLICE_DZ_SAME = 4e-5
SLICE_DV_SAME = 2e-5
NOROW_DQ = 1e-6
NOROW_DV = 1e-5
SERVO_VJP_REL = 1e-6


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps, warmup=3):
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def apgd_bound_ms(n, r, B, iterations, pgs_sweeps=0):
    """Least time for the seed's work at the card's peaks: each input read
    once and z written once, against the float32 operations it does
    (one operator application A y = F (F^T y) + cfm y is 4nr + 2n; the
    polish forms u = F^T z and the inverse diagonal, n (4r + 3), then
    does n rows of 4r + 6 per sweep)."""
    nbytes = 4 * (n * r * B + 4 * n * B)
    av = 4 * n * r + 2 * n
    flops_world = 6 * (av + 3 * n) + (av + 2 * n) + 2 * n * r + iterations * (
        av + 12 * n
    )
    if pgs_sweeps:
        flops_world += n * (4 * r + 3) + pgs_sweeps * n * (4 * r + 6)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops_world * B / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _on(dev, x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev).contiguous()


def ptxas_report(log):
    """{(rank width, rows per lane, polish): (registers, spill-store
    bytes)} of each kernel instantiation, from nvcc -Xptxas -v; the wide
    tier's under rows per lane 0."""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"apgd_seed_kernelILi(\d+)ELi(\d+)ELb([01])E", chunk)
        w = re.search(r"apgd_wide_kernelILi(\d+)ELb([01])E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        key = ((int(m[1]), int(m[2]), m[3] == "1") if m
               else (int(w[1]), 0, w[2] == "1") if w else None)
        if key and regs:
            out[key] = (int(regs[1]), int(spill[1]) if spill else 0)
    return out


def plan_words(plan, polish=False):
    """The launch plan in words; on the wide tier with the card's
    residency (worlds a SM)."""
    if plan.tier == "wide":
        from nimblephysics_tpu_torch.batched import lcp_cuda

        ctas, sms = lcp_cuda.wide_residency(plan, polish)
        return (f"wide tier, width {plan.rank_width}, a cluster of {plan.cluster} "
                f"CTA(s) of {lcp_cuda.WIDE_THREADS} threads a world, "
                f"{plan.rows_per_cta} rows of F a CTA in shared memory, "
                f"{plan.smem_bytes} bytes of shared memory a CTA, "
                f"{ctas / plan.cluster / sms:.2f} worlds a SM")
    return (f"width {plan.rank_width}, {plan.rows_per_lane} rows a lane, "
            f"{plan.worlds_per_block} worlds a block, {plan.smem_bytes} bytes")


def contact_meta(contacts, iterations, sweeps):
    """A row plan of `contacts` contacts, each a normal row and its two
    friction rows, with default bounds."""
    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    rows = np.arange(3 * contacts)
    isf = rows % 3 > 0
    return LcpMeta(findex=np.where(isf, rows - rows % 3, -1).astype(np.int32),
                   is_friction=isf, iterations=iterations, seed_pgs_sweeps=sweeps)


def random_lcp(meta, r, B, rng, dev):
    """A seeded random LCP on meta's rows, rank r, B worlds: F 0.5 N(0, 1),
    b N(0, 1), mu 0.9 on friction rows, z0 0.1 |N(0, 1)|."""
    n = meta.n
    mu = np.where(meta.is_friction[:, None], 0.9, 0.0) * np.ones((1, B))
    return tuple(_on(dev, x) for x in (
        0.5 * rng.randn(n, r, B), rng.randn(n, B), mu,
        0.1 * np.abs(rng.randn(n, B))))


def kernel_shapes(label, meta, lcp, sweeps, tol, dev):
    """The kernel beyond the main path's call: its launch plan and resident
    warps per SM, its time at WIDE_BATCH worlds (lcp repeated), and on the
    box-stack LCP against its plain version, with that time. Kernel
    launches here are not the main path's."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    F, b, mu, z0 = lcp
    n, r, B = F.shape
    plan = lcp_cuda.seed_plan(n, r, lcp_cuda.smem_limit(F.device.index))
    warps = lcp_cuda.resident_warps(plan, sweeps > 0)
    reps = -(-WIDE_BATCH // B)
    wide = [x.repeat(*([1] * (x.dim() - 1)), reps)[..., :WIDE_BATCH].contiguous()
            for x in lcp]
    wide_ms = cuda_ms(lambda: lcp_cuda.apgd_cuda(meta, *wide, pgs_sweeps=sweeps), 20)
    box = contact_meta(BOX_CONTACTS, meta.iterations, sweeps)
    bF, bb, bmu, bz0 = random_lcp(box, BOX_RANK, B, np.random.RandomState(SEED + 3), dev)
    bplan = lcp_cuda.seed_plan(box.n, BOX_RANK, plan.smem_limit)
    z_k = lcp_cuda.apgd_cuda(box, bF, bb, bmu, bz0, pgs_sweeps=sweeps)
    z_p = lcp_cuda.seed_plain(box, bF, 0.0, bb, bmu, bz0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(z_k).all()), f"{label} box-stack output not finite")
    box_abs, box_rel = rel_err(z_k, z_p)
    box_ms = cuda_ms(lambda: lcp_cuda.apgd_cuda(box, bF, bb, bmu, bz0, pgs_sweeps=sweeps), 20)
    box_bound, _ = apgd_bound_ms(box.n, BOX_RANK, B, box.iterations, sweeps)
    print(f"{label}: plan at n={n} r={r}: width {plan.rank_width}, "
          f"{plan.rows_per_lane} rows a lane, "
          f"{plan.worlds_per_block} worlds x {plan.lanes_per_world} lanes a block, "
          f"{plan.smem_bytes} bytes of shared memory, {warps} resident warps/SM; "
          f"{wide_ms:.4f} ms at B={WIDE_BATCH}")
    print(f"{label}: box-stack LCP n={box.n} r={BOX_RANK} B={B} (width "
          f"{bplan.rank_width}, {bplan.rows_per_lane} rows a lane, "
          f"{bplan.worlds_per_block} worlds a block, "
          f"{bplan.smem_bytes} bytes, {lcp_cuda.resident_warps(bplan, sweeps > 0)} "
          f"resident warps/SM): vs plain max|dz| {box_abs:.3e}, max|dz|/(1+max|z|) "
          f"{box_rel:.3e} (tol {tol:g}); {box_ms:.4f} ms, bound {box_bound:.4f} ms")
    check(box_rel <= tol, f"{label} disagrees with its plain version on the box-stack LCP")


def make_engine(dev, solver=None, dtype=torch.float32):
    """The main path's world and engine: half-cheetah, float32, under
    `solver` (SolverConfig.throughput() when None)."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, q0, v0 = half_cheetah()
    world.solver = solver or SolverConfig.throughput()
    return world, q0, v0, BatchedEngine(world, device=dev, dtype=dtype)


def rollout_start(eng, q0, v0, rng, dev):
    """bench.py's start: q0 with root-height jitter, v0, zero impulses, and
    one seeded control held over the rollout. Returns ((q, v, z), u)."""
    q = np.tile(q0[:, None], (1, BATCH))
    q[1] += rng.uniform(-0.02, 0.02, BATCH)
    u = eng.action_to_forces(_on(dev, 0.5 * rng.randn(eng.world.action_size, BATCH)))
    carry = (_on(dev, q), _on(dev, np.tile(v0[:, None], (1, BATCH))),
             torch.zeros(eng.num_rows, BATCH, dtype=torch.float32, device=dev))
    return carry, u


def rollout(eng, carry, u, steps, body_params=None):
    """`steps` warm-started steps from carry = (q, v, z)."""
    q, v, z = carry
    for _ in range(steps):
        r = eng.step(q, v, u, z_warm=z, body_params=body_params)
        q, v, z = r.q, r.v, r.impulses
    return q, v, z


def timed_rollout(eng, carry, u, label, warmup=STEPS):
    """`warmup` warm-up steps, then STEPS timed ones with the kernel's
    launches counted; checks the state and prints the forward cell."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    carry = rollout(eng, carry, u, warmup)
    torch.cuda.synchronize()
    lcp_cuda.apgd_seed.launches = 0
    t0 = time.perf_counter()
    carry = rollout(eng, carry, u, STEPS)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = lcp_cuda.apgd_seed.launches
    qf, vf, zf = carry
    check(launches == STEPS, f"kernel launched {launches} times in {STEPS} steps")
    check(all(bool(torch.isfinite(x).all()) for x in carry), "state not finite")
    median_h = float(qf[1].median())
    check(median_h > -0.5, f"cheetahs fell through (median root height {median_h})")
    in_contact = int((zf.abs().amax(dim=0) > 0).sum())
    print(f"{label}: {STEPS} steps x {BATCH} worlds: {dt_s / STEPS * 1e3:.3f} "
          f"ms/step, {BATCH * STEPS / dt_s:.1f} env-steps/s; kernel launches "
          f"{launches}; median root height {median_h:.4f}; worlds with "
          f"impulses {in_contact}/{BATCH}")
    return carry, launches


def rel_err(got, want):
    """(max |got - want|, max over worlds of it over 1 + max|want|)."""
    d = (got - want).abs()
    return float(d.max()), float((d / (1.0 + want.abs().amax(dim=0))).max())


def reversed_sweep(meta, F, b, mu, z):
    """One pgs_plain sweep over the rows in reverse order: the planted
    fault of phase 6 when a sweep fewer stays inside the tolerance."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    perm = np.arange(meta.n)[::-1].copy()
    inv = np.argsort(perm)
    fidx = np.where(meta.findex >= 0, inv[np.maximum(meta.findex, 0)], -1)[perm]
    flip = (lambda x: None if x is None else np.asarray(x)[perm])
    rmeta = LcpMeta(findex=fidx.astype(np.int32), is_friction=meta.is_friction[perm],
                    lo_const=flip(meta.lo_const), hi_const=flip(meta.hi_const))
    p, ip = (torch.as_tensor(x, device=F.device) for x in (perm, inv))
    return lcp_cuda.pgs_plain(rmeta, F[p], 0.0, b[p], mu[p], z[p], sweeps=1)[ip]


def phase6(dev, q, v, u, random_lcp):
    """The default config's seed kernel (K1b) against its plain version,
    then the default config's forward rollout."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, q0, v0, eng = make_engine(dev, SolverConfig())
    meta = eng.meta
    sweeps = meta.seed_pgs_sweeps
    check(sweeps == 16 and meta.iterations == 32, "not the default LCP knobs")
    first = eng.step(q, v, u)
    prob = eng.lcp_problem(first.q, first.v, u)
    inputs = {
        "engine_lcp": (prob.F, prob.b.contiguous(), prob.mu.contiguous(),
                       first.impulses.contiguous()),
        "random": random_lcp,
    }
    errs = []
    for label, (F, b, mu, z0) in inputs.items():
        z_k = lcp_cuda.apgd_cuda(meta, F, b, mu, z0, pgs_sweeps=sweeps)
        z_a = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, z0)
        z_p = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, z_a, sweeps=sweeps)
        z_short = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, z_a, sweeps=sweeps - 1)
        z_rev = reversed_sweep(meta, F, b, mu, z_short)
        s_k = lcp_cuda.apgd_seed(meta, F, b, mu, z0)
        s_p = lcp_cuda.pgd_step(meta, F, 0.0, b, mu, z_p)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(z_k).all()), f"K1b output not finite ({label})")
        max_abs, max_rel = rel_err(z_k, z_p)
        _, seed_rel = rel_err(s_k, s_p)
        _, short_rel = rel_err(z_k, z_short)
        _, rev_rel = rel_err(z_k, z_rev)
        _, apgd_rel = rel_err(z_k, z_a)
        errs.append(max_abs)
        print(f"phase 6 ({label}): K1b vs apgd_plain + pgs_plain max|dz| "
              f"{max_abs:.3e}, max|dz|/(1+max|z|) {max_rel:.3e}; seed (+ step) "
              f"vs plain + step {seed_rel:.3e}; vs {sweeps - 1} sweeps "
              f"{short_rel:.3e}; vs {sweeps - 1} sweeps + one reversed "
              f"{rev_rel:.3e}; vs no polish {apgd_rel:.3e}; tol {PGS_TOL:g}")
        check(max_rel <= PGS_TOL, f"K1b disagrees with its plain version ({label})")
        check(seed_rel <= PGS_TOL, f"card seed disagrees with plain + step ({label})")
        if label == "random":
            fault = short_rel if short_rel > PGS_TOL else rev_rel
            which = "one sweep fewer" if short_rel > PGS_TOL else "a reversed last sweep"
            print(f"phase 6: planted fault: {which}, {fault:.3e} > {PGS_TOL:g}")
            check(fault > PGS_TOL, "the tolerance cannot tell a planted fault")
    F, b, mu, z0 = inputs["engine_lcp"]
    k_ms = cuda_ms(lambda: lcp_cuda.apgd_cuda(meta, F, b, mu, z0, pgs_sweeps=sweeps), 50)
    p_ms = cuda_ms(lambda: lcp_cuda.seed_plain(meta, F, 0.0, b, mu, z0), 3)
    n, r, B = F.shape
    bound_ms, bound_by = apgd_bound_ms(n, r, B, meta.iterations, sweeps)
    print(f"phase 6: K1b {k_ms:.4f} ms, plain (apgd_plain + pgs_plain) "
          f"{p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) at n={n} r={r} "
          f"B={B}, {meta.iterations} iterations + {sweeps} sweeps")
    kernel_shapes("phase 6 (K1b)", meta, inputs["engine_lcp"], sweeps, PGS_TOL, dev)
    rng = np.random.RandomState(SEED)
    carry, uu = rollout_start(eng, q0, v0, rng, dev)
    _, launches = timed_rollout(eng, carry, uu, "phase 6 (default config)", WARMUP_STEPS)
    return {
        "name": "apgd_seed_pgs",
        "route": "cuda",
        "source": "nimblephysics_tpu_torch/csrc/apgd_seed.cu",
        "replaces": "nimblephysics_tpu/batched/lcp_pallas.py:118",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def train_start(q0, v0, rng, dev, worlds=BATCH, dtype=torch.float32):
    """bench.py's start as (2nv, worlds) states, and seeded policy weights
    (0.1 N(0, 1), zero biases) as numpy."""
    q = np.tile(q0[:, None], (1, worlds))
    q[1] += rng.uniform(-0.02, 0.02, worlds)
    states = np.concatenate([q, np.tile(v0[:, None], (1, worlds))])
    nv, na = len(q0), 6
    weights = (0.1 * rng.randn(HIDDEN, 2 * nv), np.zeros((HIDDEN, 1)),
               0.1 * rng.randn(na, HIDDEN), np.zeros((na, 1)))
    return torch.as_tensor(states, dtype=dtype, device=dev), weights


def policy_grad(policy):
    return torch.cat([p.grad.reshape(-1) for p in policy.parameters()])


def cosine(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(a @ b / (a.norm() * b.norm()))


def phase7(dev):
    """train_step_batched at bench.py's width under both presets."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.convert import policy_from_arrays
    from nimblephysics_tpu_torch.parallel import train_step_batched
    from nimblephysics_tpu_torch.simulation import SolverConfig

    grads, launches = {}, {}
    for label, cfg in (("default", SolverConfig()),
                       ("throughput", SolverConfig.throughput())):
        world, q0, v0, eng = make_engine(dev, cfg)
        states, weights = train_start(q0, v0, np.random.RandomState(SEED + 1), dev)
        policy = policy_from_arrays(*weights, device=dev)
        train = train_step_batched(eng, policy, TRAIN_HORIZON, LEARNING_RATE)
        first = train_step_batched(eng, policy, WARMUP_STEPS, LEARNING_RATE)(states)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        lcp_cuda.apgd_seed.launches = 0
        t0 = time.perf_counter()
        res = train(states)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        launches[label] = lcp_cuda.apgd_seed.launches
        peak = torch.cuda.max_memory_allocated(dev)
        g = grads[label] = policy_grad(policy).clone()
        print(f"phase 7 ({label}): {BATCH} worlds x horizon {TRAIN_HORIZON}, "
              f"hidden {HIDDEN}: {dt_s:.3f} s/training step, "
              f"{BATCH * TRAIN_HORIZON / dt_s:.1f} fwd+bwd env-steps/s; kernel "
              f"launches {launches[label]}; peak memory {peak / 2**20:.1f} MiB; "
              f"loss {float(res.loss):.6f} (after a {WARMUP_STEPS}-step warm-up step "
              f"at {float(first.loss):.6f}); |grad| {float(g.norm()):.4e}")
        check(launches[label] == TRAIN_HORIZON,
              f"kernel launched {launches[label]} times in a {TRAIN_HORIZON}-step training step")
        check(bool(torch.isfinite(res.loss)) and bool(torch.isfinite(g).all()),
              f"training loss or gradient not finite ({label})")
        check(bool(torch.isfinite(res.states).all()), f"trained states not finite ({label})")
    print(f"phase 7: policy-gradient cosine, default config vs throughput(): "
          f"{cosine(grads['default'], grads['throughput']):.6f}")
    return launches


def phase8(dev):
    """One short training step on the card (float32) against the port's
    CPU float64 path, from the same start and weights."""
    from nimblephysics_tpu_torch.convert import policy_from_arrays
    from nimblephysics_tpu_torch.parallel import train_step_batched
    from nimblephysics_tpu_torch.simulation import SolverConfig

    grads = {}
    for label, d, dtype in (("card", dev, torch.float32),
                            ("cpu", torch.device("cpu"), torch.float64)):
        world, q0, v0, eng = make_engine(d, SolverConfig(), dtype=dtype)
        states, weights = train_start(q0, v0, np.random.RandomState(SEED + 2),
                                      d, GRAD_WORLDS, dtype)
        policy = policy_from_arrays(*weights, device=d, dtype=dtype)
        train_step_batched(eng, policy, GRAD_HORIZON, 0.0)(states)
        grads[label] = policy_grad(policy).double().cpu()
    g, c = grads["card"], grads["cpu"]
    cos = cosine(g, c)
    rel = float((g - c).norm() / c.norm())
    print(f"phase 8: {GRAD_WORLDS} worlds x horizon {GRAD_HORIZON}, default "
          f"config: policy gradient card f32 vs CPU f64: cosine {cos:.8f} "
          f"(bound {GRAD_COS:g}), |dg|/|g| {rel:.3e} (bound {GRAD_REL:g}), "
          f"|g| {float(c.norm()):.4e}")
    check(cos >= GRAD_COS, "card policy gradient points away from the CPU's")
    check(rel <= GRAD_REL, "card policy gradient far from the CPU's")

# -- the box-stack path (phases 9-13) ----------------------------------------

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def count_launches(fn):
    """CUDA kernel launches fn() makes, from torch.profiler's host events,
    read from its raw Kineto events (building the profiler's event tree
    takes seconds for each 100k events; a Jacobian makes ~75k launches)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == cpu and e.name() in LAUNCH_CALLS)


def make_box_engine(dev, n_boxes, cap=None, dtype=torch.float32):
    """box_stack(n_boxes) under its default SolverConfig (contact_cap
    `cap`) and its engine."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import box_stack

    world, q0, _ = box_stack(n_boxes)
    if cap is not None:
        world.solver = dataclasses.replace(world.solver, contact_cap=cap)
    return world, q0, BatchedEngine(world, device=dev, dtype=dtype)


def islands_world(n_boxes=3):
    """tests/test_islands.py's scene: box_stack with every box-box pair
    filtered off, box i at x = i, a hair into the ground; one island a
    box. Returns (world, q)."""
    from nimblephysics_tpu_torch.models import box_stack

    world, q, _ = box_stack(n_boxes)
    for i in range(n_boxes):
        for j in range(i + 1, n_boxes):
            world.collision_overrides[(i, j)] = False
        q[6 * i + 3:6 * i + 6] = (1.0 * i, 0.0, 0.2 * 0.75**i / 2 - 1e-4)
    return world, q


def box_start(eng, q0, rng, dev, worlds=None):
    """boxstack_bench.py's start: q0 in every world (BATCH unless
    `worlds`), the top box's yaw jittered uniformly in +-YAW_JITTER, at
    rest, zero impulses; and zero control. Returns ((q, v, z), u)."""
    worlds = worlds or BATCH
    nv = len(q0)
    q = np.tile(q0[:, None], (1, worlds))
    q[nv - 4] += rng.uniform(-YAW_JITTER, YAW_JITTER, worlds)
    zeros = torch.zeros(nv, worlds, dtype=eng.dtype, device=dev)
    carry = (_on(dev, q).to(eng.dtype), zeros,
             torch.zeros(eng.num_rows, worlds, dtype=eng.dtype, device=dev))
    return carry, zeros.clone()


def box_lcp(dev, boxes, cap, worlds, seed=SEED + 9, steps=5):
    """The capped LCP of a box leg after `steps` steps from box_start at
    `worlds` worlds: (meta, F, b, mu, z_warm), contiguous."""
    _, q0, eng = make_box_engine(dev, boxes, cap)
    carry, u = box_start(eng, q0, np.random.RandomState(seed), dev, worlds)
    q, v, z = rollout(eng, carry, u, steps)
    blocks, _ = eng.lcp_blocks(eng.lcp_problem(q, v, u), z)
    return [x.detach().contiguous() if torch.is_tensor(x) else x for x in blocks[0]]


def box_cases(dev):
    """(label, world, q0, engine) of the box-stack legs and the islands
    scene, float32 on the card."""
    from nimblephysics_tpu_torch.batched import BatchedEngine

    cases = []
    for nb, cap in BOX_LEGS:
        label = f"box{nb}" + (f"_cap{cap}" if cap else "")
        cases.append((label, *make_box_engine(dev, nb, cap)))
    world, q = islands_world()
    cases.append(("islands", world, q, BatchedEngine(world, device=dev)))
    return cases


def engine_lcp_check(phase, label, meta, F, b, mu, zw, report, fault=None,
                     gram_fault=False, ref64=False):
    """K1 and K1b on one of the engine's own LCPs against their plain
    versions, from its warm start zw and cold (a rollout's first step):
    errors, times, bounds and the launch plan; with fault = (what, fn),
    fn(meta, F, b, mu, z0, z_plain) gives the plain K1 and K1b outputs of
    a planted fault, which must miss both limits. The limits are relative
    to 1 + max|z|; where impulses are ~5e-3 they are ~1e-5 and 1e-4
    absolute and the warm-started seed has converged (one iteration or
    sweep fewer moves it ~1e-9), so the faults change the LCP itself.
    With gram_fault, K1b is also held against the wide tier's blocked
    polish with one in-block Gram term dropped (dropped_gram), from the
    warm and the cold start: the larger must miss PGS_TOL. With ref64,
    the plain versions (and the fault's) run in float64 on the same
    inputs, and the kernel is held against them: on an LCP whose z is not
    unique two float32 evaluations part by their own rounding
    (compare_seed_kernel.py --terrain prints the float32 gaps).
    Returns {"n", "r", "B", "impulse_max", "k1": {...}, "k1b": {...}}."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    F, b, mu, zw = (x.detach().contiguous() for x in (F, b, mu, zw))
    n, r, B = F.shape
    sweeps = meta.seed_pgs_sweeps
    check(sweeps == 16, f"{label}: not the default config")
    plan = lcp_cuda.seed_plan(n, r, lcp_cuda.smem_limit(F.device.index))
    row = {"n": n, "r": r, "B": B}
    errs = {}
    ref = (lambda x: x.double()) if ref64 else (lambda x: x)
    for start, z0 in (("warm", zw), ("cold", torch.zeros_like(zw))):
        z1 = lcp_cuda.apgd_cuda(meta, F, b, mu, z0)
        p1 = lcp_cuda.apgd_plain(meta, ref(F), 0.0, ref(b), ref(mu), ref(z0))
        z2 = lcp_cuda.apgd_cuda(meta, F, b, mu, z0, pgs_sweeps=sweeps)
        p2 = lcp_cuda.pgs_plain(meta, ref(F), 0.0, ref(b), ref(mu), p1, sweeps=sweeps)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(z1).all() and torch.isfinite(z2).all()),
              f"{label}: kernel output not finite ({start})")
        errs["k1", start], errs["k1b", start] = rel_err(ref(z1), p1), rel_err(ref(z2), p2)
        if gram_fault:
            errs["gram", start] = rel_err(z2, dropped_gram(meta, F, b, mu, p1, sweeps))[1]
        if start == "warm":
            row["impulse_max"] = float(p2.abs().max())
            if fault:
                d1, d2 = fault[1](meta, ref(F), ref(b), ref(mu), ref(z0), p2)
                faults = (rel_err(ref(z1), d1)[1], rel_err(ref(z2), d2)[1])
    for key, sw, tol in (("k1", 0, KERNEL_TOL), ("k1b", sweeps, PGS_TOL)):
        ms = cuda_ms(lambda: lcp_cuda.apgd_cuda(meta, F, b, mu, zw, pgs_sweeps=sw), 20)
        plain = ((lambda: lcp_cuda.seed_plain(meta, F, 0.0, b, mu, zw)) if sw
                 else (lambda: lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, zw)))
        plain_ms = cuda_ms(plain, 2 if sw else 5, warmup=1)
        bound, by = apgd_bound_ms(n, r, B, meta.iterations, sw)
        regs, spill = report.get((plan.rank_width, plan.rows_per_lane, sw > 0), (-1, -1))
        warps = lcp_cuda.resident_warps(plan, sw > 0)
        (wa, wr), (ca, cr) = errs[key, "warm"], errs[key, "cold"]
        row[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        max_abs_err=max(wa, ca), rel=max(wr, cr))
        print(f"{phase} ({label}, {'K1b' if sw else 'K1 '}): n={n} r={r} B={B}: "
              f"vs plain{' float64' if ref64 else ''}, max|dz| and max|dz|/(1+max|z|): "
              f"warm start {wa:.3e}, {wr:.3e}; cold {ca:.3e}, {cr:.3e} (tol {tol:g}); "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
              f"{plan_words(plan, sw > 0)}, {warps} resident warps/SM, {regs} registers, "
              f"{spill} bytes spilled")
        check(max(wr, cr) <= tol,
              f"{label}: {'K1b' if sw else 'K1'} disagrees with its plain version")
    print(f"{phase} ({label}): the engine's max|z| {row['impulse_max']:.4e}")
    if fault:
        print(f"{phase} ({label}): planted fault, {fault[0]}: K1 {faults[0]:.3e} "
              f"(> {KERNEL_TOL:g}), K1b {faults[1]:.3e} (> {PGS_TOL:g})")
        check(faults[0] > KERNEL_TOL and faults[1] > PGS_TOL,
              f"{label}: the limits cannot tell {fault[0]}")
    if gram_fault:
        gw, gc = errs["gram", "warm"], errs["gram", "cold"]
        print(f"{phase} ({label}): planted fault, one in-block Gram term dropped: "
              f"K1b warm start {gw:.3e}, cold {gc:.3e} (> {PGS_TOL:g})")
        check(max(gw, gc) > PGS_TOL, f"{label}: the limit cannot tell a dropped Gram term")
    return row


def phase9(dev, report):
    """K1 and K1b on each box-stack leg's own LCP (the capped one on the
    5-, 10- and 20-box legs, the first island's in the islands scene), with
    a dropped contact as the planted fault, and a seeded random LCP on the
    same rows and rank (random_check); the refusal past the wide tier."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    out = {}
    for label, world, q0, eng in box_cases(dev):
        carry, u = box_start(eng, q0, np.random.RandomState(SEED + 9), dev)
        q, v, z = rollout(eng, carry, u, 5)  # a warm state
        prob = eng.lcp_problem(q, v, u)
        blocks, _ = eng.lcp_blocks(prob, z)
        meta, F, b, mu, zw = blocks[0]
        out[label] = engine_lcp_check("phase 9", label, meta, F, b, mu, zw, report,
                                      ("a dropped contact", dropped_contact))
        random_check(f"phase 9 ({label})", meta, F.shape[1], F.shape[2], dev, SEED + 90)

    # The wide tier: the 10- and 20-box legs' capped LCPs at their widths.
    for boxes, cap, worlds in BOX_WIDE_LEGS:
        label = f"box{boxes}_cap{cap}"
        meta, F, b, mu, zw = box_lcp(dev, boxes, cap, worlds)
        out[label] = engine_lcp_check("phase 9", label, meta, F, b, mu, zw, report,
                                      ("a dropped contact", dropped_contact),
                                      gram_fault=True)
        random_check(f"phase 9 ({label})", meta, F.shape[1], F.shape[2], dev, SEED + 90)

    # Past the wide tier's capacity: the 10-box stack's uncapped LCP is
    # refused, with its numbers, and nothing is launched.
    world, q0, eng = make_box_engine(dev, *TOO_WIDE_LEG)
    (q, v, z), u = box_start(eng, q0, np.random.RandomState(SEED), dev, worlds=64)
    before = lcp_cuda.apgd_seed.launches
    try:
        eng.step(q, v, u, z_warm=z)
        msg = ""
    except NotImplementedError as e:
        msg = str(e)
    print(f"phase 9 (box{TOO_WIDE_LEG[0]}, no cap): n={eng.meta.n} r={world.num_dofs}: "
          f"{msg or 'NOT REFUSED'}")
    check(f"n={eng.meta.n}" in msg and f"r={world.num_dofs}" in msg,
          "the kernel did not refuse the uncapped 10-box LCP with its numbers")
    check(lcp_cuda.apgd_seed.launches == before, "a refused LCP launched the kernel")
    return out


def phase10(dev):
    """The box-stack legs: 100 warm-started steps at 4096 worlds each."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    out = {}
    for label, world, q0, eng in box_cases(dev)[:len(BOX_LEGS)]:
        carry, u = box_start(eng, q0, np.random.RandomState(SEED + 10), dev)
        torch.cuda.synchronize()
        lcp_cuda.apgd_seed.launches = 0
        t0 = time.perf_counter()
        carry = rollout(eng, carry, u, STEPS)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        launches = lcp_cuda.apgd_seed.launches
        qf, vf, zf = carry
        check(launches == STEPS, f"{label}: K1b launched {launches} times in {STEPS} steps")
        check(all(bool(torch.isfinite(x).all()) for x in carry), f"{label}: state not finite")
        top = len(q0) - 1
        dz = float((qf[top] - q0[top]).abs().max())
        vmax = float(vf.abs().max())
        per_step = count_launches(lambda: eng.step(qf, vf, u, z_warm=zf))
        extra = ""
        if eng.contact_cap is not None:
            d = eng.lcp_problem(qf, vf, u).contact_depths
            live = eng.assembler.contact_valid(d).sum(dim=0)
            extra = (f"; worlds with more penetrating slots than the cap "
                     f"({eng.contact_cap}): {int((live > eng.contact_cap).sum())}/{BATCH}, "
                     f"most {int(live.max())}")
        print(f"phase 10 ({label}): {STEPS} steps x {BATCH} worlds: "
              f"{dt_s / STEPS * 1e3:.3f} ms/step, {BATCH * STEPS / dt_s:.1f} env-steps/s; "
              f"K1b launches {launches}; CUDA kernel launches per step {per_step}; "
              f"LCP n={eng.num_rows} solved n={(eng.meta_cap or eng.meta).n}; top box "
              f"max|dz| {dz:.3e} (limit {STAND_DZ:g}), max|v| {vmax:.3e} (limit "
              f"{STAND_V:g}){extra}")
        check(dz <= STAND_DZ, f"{label}: the top box moved {dz:.3e} from its start")
        check(vmax < STAND_V, f"{label}: the stack is moving (max|v| {vmax:.3e})")
        out[label] = dict(launches=launches, per_step=per_step, world=world, eng=eng,
                          carry=carry, u=u, env_steps_s=BATCH * STEPS / dt_s)
    return out


def _card_seed_plain(meta, F, b, mu, z0, cfm=0.0, z_kernel=None):
    """The card's seed on the CPU: the plain seed plus the
    projected-gradient step the card re-attaches to the kernel's output."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    return lcp_cuda.pgd_step(meta, F, cfm, b, mu, lcp_cuda.seed_plain(meta, F, cfm, b, mu, z0))


def card_vs_cpu(world, state, worlds, body=None):
    """One step of the first `worlds` worlds on the card against the CPU
    float64 path (the port's own) and the CPU float32 path with the
    card's seed (the plain seed plus the projected-gradient step the card
    re-attaches); body: per-world body parameters {key: numpy (NB, ...,
    B)}. Returns the comparison's numbers."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.batched import lcp_cuda

    eng, (q, v, z, u) = state[0], (x[:, :worlds].contiguous() for x in state[1:])

    def bp(device, dtype):
        return None if body is None else {
            k: torch.as_tensor(x[..., :worlds], dtype=dtype, device=device)
            for k, x in body.items()}

    g = eng.step(q, v, u, z_warm=z, body_params=bp(q.device, q.dtype))
    gq, gv = g.q.double().cpu(), g.v.double().cpu()
    cpu64 = BatchedEngine(world, device="cpu", dtype=torch.float64)
    a64 = [x.double().cpu() for x in (q, v, u, z)]
    c64 = cpu64.step(*a64[:3], z_warm=a64[3], body_params=bp("cpu", torch.float64))
    with mock.patch.object(lcp_cuda, "apgd_seed", _card_seed_plain):
        c32 = BatchedEngine(world, device="cpu", dtype=torch.float32).step(
            *(x.cpu() for x in (q, v, u)), z_warm=z.cpu(),
            body_params=bp("cpu", torch.float32))
    dv64 = (gv - c64.v).abs().amax(dim=0)
    dv_cpu = (c32.v.double() - c64.v).abs().amax(dim=0)
    return dict(
        active=int((g.impulses.abs().amax(dim=0) > 0).sum()),
        dq_rel=float(((gq - c64.q).abs() / (1.0 + c64.q.abs())).max()),
        dz32=float(((g.impulses.cpu() - c32.impulses).abs().amax(dim=0)
                    / (1.0 + c32.impulses.abs().amax(dim=0))).max()),
        dv32=float(((gv - c32.v.double()).abs().amax(dim=0)
                    / (1.0 + c32.v.double().abs().amax(dim=0))).max()),
        dv64=dv64, dv_cpu=dv_cpu,
    )


def _world_rel(a, b):
    """Per world max|a - b| over 1 + max|b| ((n, B) -> (B,)); zeros for
    an empty a."""
    if not a.numel():
        return a.new_zeros(a.shape[-1])
    return (a - b).abs().amax(dim=0) / (1.0 + b.abs().amax(dim=0))


def step_residual(eng, prob, z):
    """Per world (B,), the natural-map residual (lcp_residual) of the
    impulses z (n, B) on the LCP(s) that `eng` solves for `prob`; zeros
    for a world with no rows."""
    if eng.num_rows == 0:
        return prob.b.new_zeros(prob.b.shape[-1])
    blocks, _ = eng.lcp_blocks(prob, z)
    return torch.stack([lcp_residual(meta, F, b, mu, zb)
                        for meta, F, b, mu, zb in blocks]).amax(dim=0)


def drop_loaded_contact(eng, z):
    """The impulses z (n, B) with each world's most loaded contact (its
    normal and two friction rows) zeroed: what a step that lost a contact
    would give."""
    C = eng.bcollider.num_contacts
    k = torch.argmax(z[0:3 * C:3], dim=0)
    out = z.clone()
    for i in range(3):
        out.scatter_(0, (3 * k + i)[None], 0.0)
    return out


def step_check(phase, label, world, eng, q, v, z, u, dz_lim, dv_lim):
    """One step of every world on the card, held world by world on what
    stays unique where A = F F^T is rank-deficient and z is not: the
    natural-map residual of the card's impulses on the LCP the CPU builds
    in float64 from the same inputs, at most RES_SAME above that of the
    CPU's own float32 step with the card's seed; and the card's v within
    dv_lim (over 1 + max|v|) of the CPU's float64 velocity update by the
    card's impulses. Planted faults, where the scene has contact
    impulses: the card's impulses with each world's most loaded contact
    dropped, and its v before the impulse update, must each miss. Prints
    beside the gaps in z and v to the CPU's float32 step against dz_lim
    and dv_lim (held nowhere: several z solve these LCPs). Returns the
    world farthest from the CPU's float32 step in those gaps."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.batched import lcp_cuda

    with torch.no_grad():
        g = eng.step(q, v, u, z_warm=z)
        cpu64 = BatchedEngine(world, device="cpu", dtype=torch.float64)
        x64 = [t.detach().cpu().double() for t in (q, v, u)]
        prob = cpu64.lcp_problem(*x64)
        with mock.patch.object(lcp_cuda, "apgd_seed", _card_seed_plain):
            c32 = BatchedEngine(world, device="cpu", dtype=torch.float32).step(
                *(t.cpu() for t in (q, v, u)), z_warm=None if z is None else z.cpu())
        gz, gv = g.impulses.cpu().double(), g.v.cpu().double()
        res_cpu = step_residual(cpu64, prob, c32.impulses.double())
        excess = step_residual(cpu64, prob, gz) - res_cpu
        v_ref = cpu64._finish(x64[0], x64[1], prob, gz).v
        dv = _world_rel(gv, v_ref)
        dz_free, dv_free = _world_rel(gz, c32.impulses.double()), _world_rel(gv, c32.v.double())
    active = int((gz.abs().amax(dim=0) > 0).sum()) if gz.numel() else 0
    we, wv = int(torch.argmax(excess)), int(torch.argmax(dv))
    worst = int(torch.argmax(torch.maximum(dz_free / dz_lim, dv_free / dv_lim)))
    print(f"{phase} ({label}): one step, {q.shape[1]} worlds ({active} with impulses), card "
          f"vs CPU: the card's LCP residual on the CPU's float64 LCP less the CPU float32 "
          f"step's, max {float(excess.max()):.3e} (world {we}; bound {RES_SAME:.3e}); the "
          f"card's v vs the CPU float64 update by the card's impulses, max|dv|/(1+max|v|) "
          f"{float(dv.max()):.3e} (world {wv}; bound {dv_lim:g})")
    print(f"{phase} ({label}, printed, not held): card vs CPU float32 step, "
          f"max|dz|/(1+max|z|) {float(dz_free.max()):.3e}, max|dv|/(1+max|v|) "
          f"{float(dv_free.max()):.3e}; worlds beyond {dz_lim:g} or {dv_lim:g}: "
          f"{int(((dz_free > dz_lim) | (dv_free > dv_lim)).sum())}; the worst, world {worst}: "
          f"dz {float(dz_free[worst]):.3e}, dv {float(dv_free[worst]):.3e}")
    check(bool((excess <= RES_SAME).all()) and bool((dv <= dv_lim).all()),
          f"{label}: a world's card step is beyond the limits")
    if active and cpu64.bcollider.num_contacts:
        with torch.no_grad():
            f_res = step_residual(cpu64, prob, drop_loaded_contact(cpu64, gz)) - res_cpu
            f_dv = _world_rel(g.v_pre.cpu().double(), v_ref)
        print(f"{phase} ({label}): planted faults: the most loaded contact dropped, residual "
              f"excess max {float(f_res.max()):.3e}, beyond {RES_SAME:.3e} in "
              f"{int((f_res > RES_SAME).sum())} worlds; v before the impulse update, max|dv|/"
              f"(1+max|v|) {float(f_dv.max()):.3e}, beyond {dv_lim:g} in "
              f"{int((f_dv > dv_lim).sum())} worlds")
        check(bool((f_res > RES_SAME).any()) and bool((f_dv > dv_lim).any()),
              f"{label}: the limits cannot tell a planted fault")
    return worst


def phase11(dev, legs):
    """The 3-box leg's final state, one step: card vs CPU."""
    leg = legs["box3"]
    qf, vf, zf = leg["carry"]
    c = card_vs_cpu(leg["world"], (leg["eng"], qf, vf, zf, leg["u"]), CHECK_WORLDS)
    share = float((c["dv64"] <= BOX_DV_CLOSE).double().mean())
    print(f"phase 11 (box3): {CHECK_WORLDS} worlds: card vs CPU f32 with the card's "
          f"seed: max|dz|/(1+max|z|) {c['dz32']:.3e} (bound {BOX_DZ_SAME:g}), "
          f"max|dv|/(1+max|v|) {c['dv32']:.3e} (bound {BOX_DV_SAME:g}); card vs CPU "
          f"f64: max|dq|/(1+|q|) {c['dq_rel']:.3e} (bound {DQ_TOL:g}), max|dv| "
          f"{float(c['dv64'].max()):.3e} (bound {DV_TOL:g}), share with |dv| <= "
          f"{BOX_DV_CLOSE:g} {share:.4f} (bound {BOX_DV_SHARE:g}); CPU f32 vs CPU f64: "
          f"{int((c['dv_cpu'] > DV_TOL).sum())} worlds beyond {DV_TOL:g}, max|dv| "
          f"{float(c['dv_cpu'].max()):.3e}")
    check(c["dz32"] <= BOX_DZ_SAME, "box3: card impulses disagree with the CPU's float32 path")
    check(c["dv32"] <= BOX_DV_SAME, "box3: card v disagrees with the CPU's float32 path")
    check(c["dq_rel"] <= DQ_TOL, "box3: card q disagrees with the CPU f64 path")
    check(float(c["dv64"].max()) <= DV_TOL, "box3: card v far from the CPU f64 path")
    check(share >= BOX_DV_SHARE, "box3: too few worlds agree with the CPU f64 path")


def phase12(dev):
    """The islands scene: 100 steps, one seed launch per island per step;
    one step against the same world as one LCP."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.batched import lcp_cuda

    world, q0 = islands_world()
    eng = BatchedEngine(world, device=dev)
    n_islands = len(eng.islands or ())
    check(n_islands == 3, f"islands scene has {n_islands} islands, not 3")
    carry, u = box_start(eng, q0, np.random.RandomState(SEED + 12), dev)
    torch.cuda.synchronize()
    lcp_cuda.apgd_seed.launches = 0
    t0 = time.perf_counter()
    carry = rollout(eng, carry, u, STEPS)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = lcp_cuda.apgd_seed.launches
    qf, vf, zf = carry
    check(launches == n_islands * STEPS,
          f"seed launched {launches} times in {STEPS} steps of {n_islands} islands")
    check(all(bool(torch.isfinite(x).all()) for x in carry), "islands: state not finite")
    heights = qf[5::6] - torch.as_tensor(q0[5::6], dtype=qf.dtype, device=dev)[:, None]
    dz, vmax = float(heights.abs().max()), float(vf.abs().max())
    per_step = count_launches(lambda: eng.step(qf, vf, u, z_warm=zf))
    solver0 = world.solver
    world.solver = dataclasses.replace(solver0, contact_islands=False)
    try:
        eng_m = BatchedEngine(world, device=dev)
    finally:
        world.solver = solver0
    check(eng_m.islands is None, "contact_islands=False kept the islands")
    r_i = eng.step(qf, vf, u, z_warm=zf)
    r_m = eng_m.step(qf, vf, u, z_warm=zf)
    dq = float(((r_i.q - r_m.q).abs() / (1.0 + r_m.q.abs())).max())
    dv = float(((r_i.v - r_m.v).abs().amax(dim=0) / (1.0 + r_m.v.abs().amax(dim=0))).max())
    dz_i = float(((r_i.impulses - r_m.impulses).abs().amax(dim=0)
                  / (1.0 + r_m.impulses.abs().amax(dim=0))).max())
    print(f"phase 12 (islands): {n_islands} islands (n={[m.n for _, _, m in eng.islands]}), "
          f"{STEPS} steps x {BATCH} worlds: {dt_s / STEPS * 1e3:.3f} ms/step, "
          f"{BATCH * STEPS / dt_s:.1f} env-steps/s; seed launches {launches}; CUDA "
          f"kernel launches per step {per_step}; box heights max|dz| {dz:.3e}, max|v| "
          f"{vmax:.3e}; one step vs one LCP: max|dq|/(1+|q|) {dq:.3e}, max|dv|/(1+max|v|) "
          f"{dv:.3e}, max|dz|/(1+max|z|) {dz_i:.3e} (bounds {ISL_DQ:g}, {ISL_DV:g}, {ISL_DZ:g})")
    check(dz <= STAND_DZ and vmax < STAND_V, "islands: the boxes do not rest")
    check(dq <= ISL_DQ and dv <= ISL_DV and dz_i <= ISL_DZ,
          "islands: the islanded step disagrees with the one-LCP step")
    return dict(launches=launches, per_step=per_step, env_steps_s=BATCH * STEPS / dt_s)


def rest_start(q0, rng, worlds):
    """The box stack at rest with every contact ~1 mm deep (box i lowered
    by (i + 1) mm), the top box's yaw jittered, velocities 1e-3 N(0, 1);
    as numpy."""
    nv = len(q0)
    q = np.tile(q0[:, None], (1, worlds))
    q[5::6] -= 1e-3 * np.arange(1, nv // 6 + 1)[:, None]
    q[nv - 4] += rng.uniform(-YAW_JITTER, YAW_JITTER, worlds)
    return q, 1e-3 * rng.randn(nv, worlds)


def phase13(dev):
    """A VJP through VJP_STEPS remat_steps of the 2-box stack, card f32
    against the CPU's float64 path."""
    grads = {}
    for label, d, dtype in (("card", dev, torch.float32), ("cpu", torch.device("cpu"), torch.float64)):
        world, q0, eng = make_box_engine(d, 2, dtype=dtype)
        rng = np.random.RandomState(SEED + 13)
        q, v = rest_start(q0, rng, VJP_WORLDS)
        wq, wv = (torch.as_tensor(rng.randn(*q.shape), dtype=dtype, device=d) for _ in range(2))
        x = [torch.as_tensor(a, dtype=dtype, device=d).requires_grad_() for a in (q, v)]
        u = torch.zeros_like(x[0])
        qq, vv, z = x[0], x[1], None
        for _ in range(VJP_STEPS):
            r = eng.remat_step(qq, vv, u, z_warm=z)
            qq, vv, z = r.q, r.v, r.impulses
        g = torch.autograd.grad((wq * qq).sum() + (wv * vv).sum(), x)
        grads[label] = torch.cat([t.reshape(-1) for t in g]).double().cpu()
    g, c = grads["card"], grads["cpu"]
    cos = cosine(g, c)
    rel = float((g - c).norm() / c.norm())
    print(f"phase 13: 2-box stack, {VJP_WORLDS} worlds x {VJP_STEPS} remat_steps: VJP "
          f"card f32 vs CPU f64: cosine {cos:.8f} (bound {VJP_COS:g}), |dg|/|g| "
          f"{rel:.3e} (bound {VJP_REL:g}), |g| {float(c.norm()):.4e}")
    check(bool(torch.isfinite(g).all()), "box-stack VJP not finite")
    check(cos >= VJP_COS, "card box-stack VJP points away from the CPU's")
    check(rel <= VJP_REL, "card box-stack VJP far from the CPU's")


def box_kernel_entries(k9, legs, isl):
    """The kernels line's entries for K1b on the box-stack path: one per
    leg (launches from its phase-10 rollout, or phase 12's for the
    islands) with phase 9's numbers at that leg's LCP."""
    runs = {label: leg["launches"] for label, leg in legs.items()}
    runs["islands"] = isl["launches"]
    out = []
    for label, launches in runs.items():
        k = k9[label]["k1b"]
        out.append({
            "name": f"apgd_seed_pgs/{label}",
            "route": "cuda",
            "source": "nimblephysics_tpu_torch/csrc/apgd_seed.cu",
            "replaces": "nimblephysics_tpu/batched/lcp_pallas.py:118",
            "launches": launches,
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,
        })
    return out


# -- the rest of the batched engine (phases 14-17) -----------------------------

# The reference suite's worlds (benchmarks/reference_suite.py): 4096 worlds,
# q0 + 0.003 N(0, 1), the tanh-MLP policy (hidden 64) on [q; v], warm-started
# impulses; forward 100 steps, training horizon 50.
REF_WORLDS = ("jump_worm", "catapult")
REF_HORIZON = 50
# The constraint families of tests/test_motors.py, one small world each.
MOTOR_SCENES = ("servo", "mimic", "locked", "ball", "weld")


def _translation(p):
    T = np.eye(4)
    T[:3, 3] = p
    return T


def _pendulum(links):
    """tests/worlds.py's pendulum (1 link) or double pendulum (2): unit
    links of mass 1 swinging about world y, each joint half a link above
    its body's centre."""
    from nimblephysics_tpu_torch.dynamics import REVOLUTE, Skeleton

    sk = Skeleton("pendulum" if links == 1 else "double_pendulum")
    body = -1
    for i in range(links):
        body = sk.add_joint_and_body(
            REVOLUTE, parent=body, name=f"link{i}", axis=[0.0, 1.0, 0.0],
            T_pj=None if i == 0 else _translation((0.0, 0.0, -0.5)),
            T_cj=_translation((0.0, 0.0, 0.5)), mass=1.0, inertia=np.eye(3) / 12.0)
    return sk


def _free_box(size=0.2):
    """tests/worlds.py's free_box: a free unit-mass box of side `size`."""
    from nimblephysics_tpu_torch.dynamics import FREE, ShapeSpec, Skeleton
    from nimblephysics_tpu_torch.math.spatial import inertia_box

    sk = Skeleton("box")
    sk.add_joint_and_body(FREE, name="box", mass=1.0, inertia=inertia_box(1.0, np.full(3, size)),
                          shapes=(ShapeSpec("box", np.full(3, size)),))
    return sk


def _ground():
    """tests/worlds.py's ground_plane: the z = 0 plane, restitution 1."""
    from nimblephysics_tpu_torch.dynamics import WELD, ShapeSpec, Skeleton

    sk = Skeleton("ground")
    sk.add_joint_and_body(WELD, name="ground", mass=1.0, shapes=(
        ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0]), restitution=1.0),))
    return sk


def motor_scene(name):
    """One constraint family of tests/test_motors.py, built with the port's
    API: (world, q0, v0, control), the last three (nv,).
      servo: a pendulum, no gravity, a servo of force limit 0.01 told 10
        rad/s (test_servo_respects_force_limit: it saturates);
      mimic: a double pendulum, no gravity, dof 1 mimicking half of dof 0
        (limit 1e4), dof 0 driven (test_mimic_motor);
      locked: a pendulum under gravity, locked at 0.8 rad moving at 0.5
        (test_locked_joint);
      ball: a free box pinned by its corner (0.1, 0, 0.1) to the world point
        (0.1, 0, 1) over the ground (test_ball_constraint_pins_point);
      weld: two free boxes welded 0.4 apart in x and 0.1 in z, the first
        spinning (test_weld_batched_matches_single's pose)."""
    from nimblephysics_tpu_torch.simulation import World

    if name in ("servo", "mimic", "locked"):
        world = World(gravity=(0.0, 0.0, 0.0 if name != "locked" else -9.81))
        world.add_skeleton(_pendulum(2 if name == "mimic" else 1))
        if name == "servo":
            world.set_actuator_type(0, "servo", force_limit=0.01)
            return world, np.zeros(1), np.zeros(1), np.array([10.0])
        if name == "mimic":
            world.set_actuator_type(1, "mimic", force_limit=1e4, mimic_dof=0,
                                    mimic_multiplier=0.5)
            return world, np.zeros(2), np.array([1.0, 0.0]), np.array([2.0, 0.0])
        world.set_actuator_type(0, "locked")
        return world, np.array([0.8]), np.array([0.5]), np.zeros(1)
    world = World(time_step=1e-3)
    if name == "ball":
        world.add_skeleton(_free_box())
        world.add_skeleton(_ground())
        world.add_ball_joint_constraint(0, [0.1, 0.0, 0.1], 1, [0.1, 0.0, 1.0])
        q0 = np.zeros(6)
        q0[5] = 0.9
        return world, q0, np.zeros(6), np.zeros(6)
    world.add_skeleton(_free_box())
    world.add_skeleton(_free_box())
    q0 = np.zeros(12)
    q0[9], q0[11] = 0.4, 0.1
    world.add_weld_joint_constraint(0, 1, at_positions=q0)
    v0 = np.zeros(12)
    v0[0] = 0.5
    return world, q0, v0, np.zeros(12)


def constraint_drift(eng, q):
    """How far eng's ball and weld constraints are from holding at q
    (nv, B), per world: the largest gap |p_a - p_b| between a constraint's
    two anchor points, and the largest weld rotation error
    |log(R_a rel R_b^T)| (0 without a weld); tests/test_motors.py holds
    both within its limits."""
    from nimblephysics_tpu_torch.batched import linalg as bl
    from nimblephysics_tpu_torch.batched.articulated import fk

    R, p, *_ = fk(eng.fw, q)
    gap = rot = q.new_zeros(q.shape[-1])
    for k in eng.assembler.row_consts(q.dtype, q.device).dyn:
        pa = bl.mv(R[k.body_a], k.offset_a) + p[k.body_a]
        pb = bl.mv(R[k.body_b], k.offset_b) + p[k.body_b]
        gap = torch.maximum(gap, (pa - pb).norm(dim=0))
        if k.kind == "weld":
            R_e = bl.mm(bl.mm(R[k.body_a], k.rel_rot), R[k.body_b].transpose(0, 1))
            rot = torch.maximum(rot, bl.log_so3(R_e).norm(dim=0))
    return gap, rot


def make_ref_engine(dev, name, dtype=torch.float32):
    """The reference suite's world `name` (jump_worm or catapult) under the
    default SolverConfig, and its engine."""
    from nimblephysics_tpu_torch import models
    from nimblephysics_tpu_torch.batched import BatchedEngine

    world, q0, v0 = getattr(models, name)()
    return world, q0, v0, BatchedEngine(world, device=dev, dtype=dtype)


def ref_start(eng, q0, v0, rng, dev, worlds=None):
    """reference_suite.bench_workload's start: q0 + 0.003 N(0, 1), v0 and
    zero impulses in every world, and its policy (hidden HIDDEN, weights
    0.1 N(0, 1), zero biases). Returns ((q, v, z), policy)."""
    from nimblephysics_tpu_torch.convert import policy_from_arrays

    worlds = worlds or BATCH
    nv, na = len(q0), eng.world.action_size
    q = q0[:, None] + 0.003 * rng.randn(nv, worlds)
    carry = (_on(dev, q).to(eng.dtype), _on(dev, np.tile(v0[:, None], (1, worlds))).to(eng.dtype),
             torch.zeros(eng.num_rows, worlds, dtype=eng.dtype, device=dev))
    weights = (0.1 * rng.randn(HIDDEN, 2 * nv), np.zeros((HIDDEN, 1)),
               0.1 * rng.randn(na, HIDDEN), np.zeros((na, 1)))
    return carry, policy_from_arrays(*weights, device=dev, dtype=eng.dtype)


def policy_rollout(eng, carry, policy, steps):
    """`steps` warm-started steps from carry = (q, v, z), each driven by
    policy([q; v]) through action_to_forces."""
    q, v, z = carry
    with torch.no_grad():
        for _ in range(steps):
            r = eng.step(q, v, eng.action_to_forces(policy(torch.cat([q, v]))), z_warm=z)
            q, v, z = r.q, r.v, r.impulses
    return q, v, z


def motor_start(eng, name, rng, dev, worlds=None):
    """motor_scene(name)'s start in every world: the pendulums' q jittered
    by 0.05 N(0, 1), the boxes' v by 0.1 N(0, 1) (their q is where the
    constraint holds); zero impulses. Returns ((q, v, z), control)."""
    _, q0, v0, u0 = motor_scene(name)
    worlds = worlds or BATCH
    nv = len(q0)
    q = np.tile(q0[:, None], (1, worlds))
    v = np.tile(v0[:, None], (1, worlds))
    if name in ("ball", "weld"):
        v += 0.1 * rng.randn(nv, worlds)
    else:
        q += 0.05 * rng.randn(nv, worlds)
    z = torch.zeros(eng.num_rows, worlds, dtype=eng.dtype, device=dev)
    return ((_on(dev, q).to(eng.dtype), _on(dev, v).to(eng.dtype), z),
            _on(dev, np.tile(u0[:, None], (1, worlds))).to(eng.dtype))


def slice_engines(dev, dtype=torch.float32):
    """(label, world, engine, start) of this slice's worlds on the card:
    jump_worm and catapult (start: ((q, v, z), policy)) and each motor
    scene (start: ((q, v, z), control))."""
    from nimblephysics_tpu_torch.batched import BatchedEngine

    out = []
    for i, name in enumerate(REF_WORLDS):
        world, q0, v0, eng = make_ref_engine(dev, name, dtype)
        out.append((name, world, eng,
                    ref_start(eng, q0, v0, np.random.RandomState(SEED + 140 + i), dev)))
    for i, name in enumerate(MOTOR_SCENES):
        world = motor_scene(name)[0]
        eng = BatchedEngine(world, device=dev, dtype=dtype)
        out.append((name, world, eng,
                    motor_start(eng, name, np.random.RandomState(SEED + 145 + i), dev)))
    return out


def advance(eng, carry, drive, steps):
    """`steps` warm-started steps of a slice world: drive is its policy
    (the reference worlds) or its fixed control (the motor scenes)."""
    if isinstance(drive, torch.nn.Module):
        return policy_rollout(eng, carry, drive, steps)
    return rollout(eng, carry, drive, steps)


def lcp_residual(meta, F, b, mu, z):
    """Per world, the boxed LCP's natural-map residual max_i |z_i -
    proj_i(z_i - w_i)| with w = F F^T z - b (0 exactly at a solution: it
    measures feasibility and complementarity at once), over 1 + max|b|."""
    from nimblephysics_tpu_torch.batched.lcp import _Av, _const_bounds, _rows

    isf, fidx = _rows(meta, F.device)
    lo, hi = _const_bounds(meta, F.dtype, F.device)
    y = z - (_Av(F, 0.0, z) - b)
    bound = mu * torch.clamp(z[fidx], min=0.0)
    proj = torch.where(isf, torch.minimum(torch.maximum(y, -bound), bound),
                       torch.minimum(torch.maximum(y, lo), hi))
    return (z - proj).abs().amax(dim=0) / (1.0 + b.abs().amax(dim=0))


def unique_parts(meta, F, b, mu, z_k, z_p):
    """What a kernel output z_k shares with its plain version z_p on an LCP
    whose z is not unique (A = F F^T of rank r < n): the largest gap in
    u = F^T z over 1 + max|F^T z_p|, and in the natural-map residual."""
    u_k = torch.sum(F * z_k[:, None, :], dim=0)
    u_p = torch.sum(F * z_p[:, None, :], dim=0)
    du = float(((u_k - u_p).abs().amax(dim=0) / (1.0 + u_p.abs().amax(dim=0))).max())
    dres = float((lcp_residual(meta, F, b, mu, z_k) - lcp_residual(meta, F, b, mu, z_p)).abs().max())
    return du, dres


def dropped_contact(meta, F, b, mu, z0, z_ref):
    """The plain K1 and K1b outputs on the LCP with each world's most loaded
    contact (by z_ref's normal rows; its normal and friction rows) zeroed:
    what a kernel that skipped a row would give."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    keep = torch.ones_like(b)
    k = torch.argmax(z_ref[0::3][: (meta.findex >= 0).sum() // 2], dim=0)
    for i in range(3):
        keep.scatter_(0, (3 * k + i)[None], 0.0)
    Fd, bd = F * keep[:, None], b * keep
    return (lcp_cuda.apgd_plain(meta, Fd, 0.0, bd, mu, z0),
            lcp_cuda.seed_plain(meta, Fd, 0.0, bd, mu, z0))


def dropped_gram(meta, F, b, mu, z_apgd, sweeps):
    """pgs_plain from z_apgd with one in-block Gram term of the wide tier's
    blocked polish dropped: in every block of WIDE_BLOCK rows, the second
    row does not see the first one's update of the same sweep (its
    F_1 . F_0 dz_0 left out). What a kernel that skipped the term would
    give."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    cfm = 0.0
    fidx = np.maximum(meta.findex, 0)
    diag = lcp_cuda._diag_A(F, cfm)
    inv = torch.where(diag > 1e-12, 1.0 / torch.clamp(diag, min=1e-12), torch.zeros_like(diag))
    lo_c, hi_c = lcp_cuda._const_bounds(meta, F.dtype, F.device)
    Fr = F.unbind(0)
    z = list(z_apgd.unbind(0))
    u = torch.sum(F * z_apgd[:, None, :], dim=0)
    for _ in range(sweeps):
        dz_first = None
        for i in range(meta.n):
            ui = u - Fr[i - 1] * dz_first if i % lcp_cuda.WIDE_BLOCK == 1 else u
            zi = z[i] + (b[i] - (torch.sum(Fr[i] * ui, dim=0) + cfm * z[i])) * inv[i]
            if meta.is_friction[i]:
                bound = mu[i] * z[fidx[i]]
                zi = torch.minimum(torch.maximum(zi, -bound), bound)
            else:
                zi = torch.minimum(torch.maximum(zi, lo_c[i]), hi_c[i])
            dz = zi - z[i]
            if i % lcp_cuda.WIDE_BLOCK == 0:
                dz_first = dz
            u = u + Fr[i] * dz
            z[i] = zi
    return torch.stack(z)


def unbounded_servo(meta, F, b, mu, z0, z_ref=None):
    """The plain K1 and K1b outputs with the servo rows' bounds removed
    (-inf, inf): what a kernel that ignored finite bounds would give."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    free = dataclasses.replace(meta, lo_const=np.full(meta.n, -np.inf),
                               hi_const=np.full(meta.n, np.inf))
    return (lcp_cuda.apgd_plain(free, F, 0.0, b, mu, z0),
            lcp_cuda.seed_plain(free, F, 0.0, b, mu, z0))


def phase14(dev, report):
    """K1 and K1b on this slice's LCPs: jump_worm and catapult (warm and
    cold) and each motor scene, against their plain versions, with the
    dropped-contact (worm) and unbounded-servo faults; seeded random LCPs
    on the same rows, held by u = F^T z and the residual."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    out = {}
    for label, world, eng, (carry, drive) in slice_engines(dev):
        q, v, z = advance(eng, carry, drive, 20 if label in REF_WORLDS else 5)
        u = (eng.action_to_forces(drive(torch.cat([q, v]))).detach()
             if isinstance(drive, torch.nn.Module) else drive)
        meta, F, b, mu, zw = eng.lcp_blocks(eng.lcp_problem(q, v, u), z)[0][0]
        fault = {"jump_worm": ("a dropped contact", dropped_contact),
                 "servo": ("the servo rows unbounded", unbounded_servo)}.get(label)
        out[label] = engine_lcp_check("phase 14", label, meta, F, b, mu, zw, report, fault)
        if label == "servo":
            hi = float(meta.hi_const[0])
            z = lcp_cuda.apgd_cuda(meta, F.contiguous(), b.contiguous(), mu.contiguous(),
                                   zw.contiguous(), pgs_sweeps=meta.seed_pgs_sweeps)
            at_bound = float((z[0] >= hi * (1 - 1e-6)).double().mean())
            print(f"phase 14 (servo): share of worlds at the bound {hi:.3e}: {at_bound:.4f}")
            check(at_bound == 1.0, "the servo scene does not saturate its bound")
        if meta.n > 1:
            random_check(f"phase 14 ({label})", meta, F.shape[1], F.shape[2], dev, SEED + 141)
    return out


def random_check(label, meta, r, B, dev, seed):
    """K1 and K1b on a seeded random LCP of meta's rows and rank r against
    the plain versions in float32 and float64: z is shown (a rank-r
    operator on n > r rows leaves z free along its null space, and the
    polish drifts there in either precision), u = F^T z and the
    natural-map residual are held to RAND_U_TOL and RAND_RES_TOL."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    Fr, br, mur, zr = random_lcp(meta, r, B, np.random.RandomState(seed), dev)
    for key, sw in (("K1 ", 0), ("K1b", meta.seed_pgs_sweeps)):
        m = dataclasses.replace(meta, seed_pgs_sweeps=sw)
        zk = lcp_cuda.apgd_cuda(meta, Fr, br, mur, zr, pgs_sweeps=sw)
        p32, p64 = (lcp_cuda.seed_plain(m, Fr.to(dt), 0.0, br.to(dt), mur.to(dt), zr.to(dt))
                    for dt in (torch.float32, torch.float64))
        du, dres = unique_parts(meta, Fr, br, mur, zk, p32)
        print(f"{label}, random LCP n={meta.n} r={r}, {key}: z: kernel vs plain f32 "
              f"{rel_err(zk, p32)[1]:.3e}, vs plain f64 {rel_err(zk.double(), p64)[1]:.3e}, "
              f"plain f32 vs f64 {rel_err(p32.double(), p64)[1]:.3e} (shown); u = F^T z "
              f"{du:.3e} (tol {RAND_U_TOL:g}); residual {dres:.3e} (tol {RAND_RES_TOL:g})")
        check(du <= RAND_U_TOL, f"{label}: {key} u = F^T z disagrees with its plain version")
        check(dres <= RAND_RES_TOL, f"{label}: {key} residual disagrees with its plain version")


def _forbidden(*_, **__):
    raise AssertionError("the plain seed ran on the card")


def phase15(dev):
    """The slice's rollouts at BATCH worlds: jump_worm and catapult (STEPS
    warm-up and STEPS timed policy steps) and each motor scene (STEPS
    steps), one K1b launch a step and never the plain seed; then the
    worm's settling and the catapult arm's response to torque."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    out = {}
    for label, world, eng, (carry, drive) in slice_engines(dev):
        if label in REF_WORLDS:
            carry = advance(eng, carry, drive, STEPS)  # warm-up
        torch.cuda.synchronize()
        lcp_cuda.apgd_seed.launches = 0
        with mock.patch.object(lcp_cuda, "seed_plain", _forbidden), \
                mock.patch.object(lcp_cuda, "apgd_plain", _forbidden):
            t0 = time.perf_counter()
            carry = advance(eng, carry, drive, STEPS)
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t0
        launches = lcp_cuda.apgd_seed.launches
        qf, vf, zf = carry
        u = (eng.action_to_forces(drive(torch.cat([qf, vf]))).detach()
             if isinstance(drive, torch.nn.Module) else drive)
        per_step = count_launches(lambda: eng.step(qf, vf, u, z_warm=zf))
        check(launches == STEPS, f"{label}: K1b launched {launches} times in {STEPS} steps")
        check(all(bool(torch.isfinite(x).all()) for x in carry), f"{label}: state not finite")
        extra = motor_check(label, eng, qf, vf) if label in MOTOR_SCENES else ""
        print(f"phase 15 ({label}): {STEPS} steps x {BATCH} worlds: "
              f"{dt_s / STEPS * 1e3:.3f} ms/step, {BATCH * STEPS / dt_s:.1f} env-steps/s; "
              f"K1b launches {launches}; CUDA kernel launches per step {per_step}; LCP "
              f"n={eng.num_rows} r={world.num_dofs}; worlds with impulses "
              f"{int((zf.abs().amax(dim=0) > 0).sum())}/{BATCH}{extra}")
        out[label] = dict(launches=launches, per_step=per_step, world=world, eng=eng,
                          carry=carry, u=u, env_steps_s=BATCH * STEPS / dt_s)
    settle_check(dev)
    torque_check(dev)
    return out


def motor_check(label, eng, q, v):
    """tests/test_motors.py's checks on a motor scene after STEPS steps."""
    dt = eng.world.time_step
    if label == "servo":
        # Saturated from rest with no gravity: v = STEPS f dt / M, M = 1/3.
        want = STEPS * 0.01 * dt * 3.0
        err = float((v[0] - want).abs().max()) / want
        check(err <= SERVO_REL, f"servo: v off its force-limited value by {err:.3e}")
        return f"; servo v {float(v[0].mean()):.6e} (force-limited {want:.6e}), rel {err:.3e}"
    if label == "mimic":
        err = float((v[1] - 0.5 * v[0]).abs().max())
        check(err <= MIMIC_ABS, f"mimic: |v1 - v0 / 2| {err:.3e}")
        return f"; max|v1 - v0/2| {err:.3e} (limit {MIMIC_ABS:g})"
    if label == "locked":
        err = float(v.abs().max())
        check(err <= LOCKED_ABS, f"locked: max|v| {err:.3e}")
        return f"; max|v| {err:.3e} (limit {LOCKED_ABS:g})"
    gap, rot = constraint_drift(eng, q)
    limit = BALL_DRIFT if label == "ball" else WELD_DRIFT
    check(float(gap.max()) <= limit and float(rot.max()) <= limit,
          f"{label}: the constraint drifted ({float(gap.max()):.3e}, {float(rot.max()):.3e})")
    return (f"; anchor gap max {float(gap.max()):.3e}, rotation error max "
            f"{float(rot.max()):.3e} (limit {limit:g}); max|v| {float(v.abs().max()):.3e}")


def settle_check(dev):
    """tests/test_reference_workloads.py::test_settles_on_floor on the card:
    SETTLE_WORLDS worms from the reference start, no torque, SETTLE_STEPS
    steps (600 there): the root rests on the floor (-0.56 < y < 0.1),
    |v| < 1."""
    world, q0, v0, eng = make_ref_engine(dev, "jump_worm")
    (q, v, z), _ = ref_start(eng, q0, v0, np.random.RandomState(SEED + 150), dev, SETTLE_WORLDS)
    q, v, z = rollout(eng, (q, v, z), torch.zeros_like(q), SETTLE_STEPS)
    y, vmax = q[1], float(v.abs().max())
    print(f"phase 15 (jump_worm settling): {SETTLE_WORLDS} worlds x {SETTLE_STEPS} steps, "
          f"no torque: root y in [{float(y.min()):.4f}, {float(y.max()):.4f}] (bounds "
          f"-0.56, 0.1), max|v| {vmax:.3e} (bound 1)")
    check(bool(torch.isfinite(q).all()) and float(y.min()) > -0.56 and float(y.max()) < 0.1
          and vmax < 1.0, "jump_worm: the worm does not rest on the floor")


def torque_check(dev):
    """tests/test_reference_workloads.py::test_arm_torque_moves_projectile
    on the card, cut to TORQUE_STEPS steps: the catapult arm under -60 N m
    on its three joints ends more than 0.05 rad from the passive arm."""
    world, q0, v0, eng = make_ref_engine(dev, "catapult")
    (q, v, z), _ = ref_start(eng, q0, v0, np.random.RandomState(SEED + 151), dev, SETTLE_WORLDS)
    torque = torch.zeros_like(q)
    torque[2:] = -60.0
    passive = rollout(eng, (q, v, z), torch.zeros_like(q), TORQUE_STEPS)[0]
    driven = rollout(eng, (q, v, z), torque, TORQUE_STEPS)[0]
    moved = float((driven[2:5] - passive[2:5]).abs().amax(dim=0).min())
    print(f"phase 15 (catapult torque): {SETTLE_WORLDS} worlds x {TORQUE_STEPS} steps: arm "
          f"joints, torque vs passive, least max|dq| over worlds {moved:.4f} (bound 0.05)")
    check(bool(torch.isfinite(driven).all()) and moved > 0.05,
          "catapult: the arm does not respond to torque")


def phase16(dev):
    """train_step_batched on jump_worm and catapult at BATCH worlds, horizon
    REF_HORIZON: one warm-up call (horizon WARMUP_STEPS) and one timed call
    each."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.parallel import train_step_batched

    out = {}
    for i, name in enumerate(REF_WORLDS):
        world, q0, v0, eng = make_ref_engine(dev, name)
        (q, v, _), policy = ref_start(eng, q0, v0, np.random.RandomState(SEED + 160 + i), dev)
        states = torch.cat([q, v])
        train = train_step_batched(eng, policy, REF_HORIZON, LEARNING_RATE)
        first = train_step_batched(eng, policy, WARMUP_STEPS, LEARNING_RATE)(states)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        lcp_cuda.apgd_seed.launches = 0
        t0 = time.perf_counter()
        res = train(states)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        launches = lcp_cuda.apgd_seed.launches
        peak = torch.cuda.max_memory_allocated(dev)
        g = policy_grad(policy)
        print(f"phase 16 ({name}): {BATCH} worlds x horizon {REF_HORIZON}, hidden "
              f"{HIDDEN}: {dt_s:.3f} s/training step, {BATCH * REF_HORIZON / dt_s:.1f} "
              f"fwd+bwd env-steps/s; K1b launches {launches}; peak memory "
              f"{peak / 2**20:.1f} MiB; loss {float(res.loss):.6f} (after a "
              f"{WARMUP_STEPS}-step warm-up step at {float(first.loss):.6f}); |grad| "
              f"{float(g.norm()):.4e}")
        check(launches == REF_HORIZON,
              f"{name}: K1b launched {launches} times in a {REF_HORIZON}-step training step")
        check(bool(torch.isfinite(res.loss)) and bool(torch.isfinite(g).all()),
              f"{name}: training loss or gradient not finite")
        out[name] = dict(launches=launches, env_steps_s=BATCH * REF_HORIZON / dt_s,
                         peak_mib=peak / 2**20)
    return out


def euler_chain_world():
    """tests/test_batched.py::test_batched_euler_joints_match's world: an
    euler_free base and an euler tip, no shapes."""
    from nimblephysics_tpu_torch.dynamics import Skeleton
    from nimblephysics_tpu_torch.simulation import World

    sk = Skeleton("euler_chain")
    base = sk.add_joint_and_body("eulerfree", name="base", euler_order="zyx", mass=1.2,
                                 inertia=np.eye(3) * 0.02)
    sk.add_joint_and_body("euler", parent=base, name="tip", euler_order="xyz",
                          T_pj=_translation((0.1, 0.0, -0.2)), mass=0.7,
                          inertia=np.eye(3) * 0.01)
    world = World(gravity=(0.0, 0.0, -9.81), time_step=0.001)
    world.add_skeleton(sk)
    return world


def shapes_world():
    """Five free bodies with no gravity, every pair colliding: two spheres
    (radii 0.1, 0.12), a box (0.2 x 0.3 x 0.4) and two capsules ((0.05,
    0.3), (0.04, 0.2)): sphere-sphere, sphere-box, capsule-sphere,
    capsule-capsule and capsule-box slots (tests/test_torch_collision.py's
    world)."""
    from nimblephysics_tpu_torch.dynamics import FREE, ShapeSpec, Skeleton
    from nimblephysics_tpu_torch.simulation import World

    world = World(gravity=(0.0, 0.0, 0.0))
    shapes = [("sphere", [0.1]), ("sphere", [0.12]), ("box", [0.2, 0.3, 0.4]),
              ("capsule", [0.05, 0.3]), ("capsule", [0.04, 0.2])]
    for i, (kind, size) in enumerate(shapes):
        sk = Skeleton(f"body{i}")
        sk.add_joint_and_body(FREE, name=f"body{i}", shapes=(ShapeSpec(kind, np.array(size)),))
        world.add_skeleton(sk)
    return world


def shapes_start(rng, worlds):
    """The five bodies of shapes_world in a row along x, each neighbour
    ~2 mm into the next (sphere-sphere, sphere-box, capsule-box and
    capsule-capsule slots touch; the capsule-sphere and other slots stay
    apart), jittered per world by 1 mm and 0.05 rad, moving together at
    ~0.05 m/s: (30, worlds) q and v as numpy."""
    x = np.array([0.0, 0.218, 0.436, 0.584, 0.672])
    q = np.zeros((30, worlds))
    q[0::6] = q[1::6] = q[2::6] = 0.05 * rng.randn(5, worlds)
    q[3::6] = x[:, None] + 1e-3 * rng.randn(5, worlds)
    v = np.zeros_like(q)
    v[3::6] = -0.05 * np.sign(x - x.mean())[:, None] + 0.01 * rng.randn(5, worlds)
    return q, v


def phase17(dev, runs):
    """The card against the CPU: one step of jump_worm and of each motor
    scene from phase 15's final state, and of the five-shape world; the
    no-row worlds with no kernel launch; a remat_step VJP through the
    servo scene."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.batched import lcp_cuda

    for label in ("jump_worm",) + MOTOR_SCENES:
        run = runs[label]
        qf, vf, zf = run["carry"]
        c = card_vs_cpu(run["world"], (run["eng"], qf, vf, zf, run["u"]), CHECK_WORLDS)
        slice_card_check(label, c)
    world = shapes_world()
    eng = BatchedEngine(world, device=dev)
    q, v = shapes_start(np.random.RandomState(SEED + 170), CHECK_WORLDS)
    q, v = _on(dev, q), _on(dev, v)
    c = card_vs_cpu(world, (eng, q, v, torch.zeros(eng.num_rows, CHECK_WORLDS, device=dev),
                            torch.zeros_like(q)), CHECK_WORLDS)
    check(float(eng.step(q, v, torch.zeros_like(q)).impulses.abs().max()) > 0,
          "the five-shape world has no contact")
    slice_card_check("shapes", c)
    from nimblephysics_tpu_torch.models import inverted_double_pendulum

    for label, world in (("inverted_double_pendulum", inverted_double_pendulum()[0]),
                         ("euler_chain", euler_chain_world())):
        eng = BatchedEngine(world, device=dev)
        rng = np.random.RandomState(SEED + 171)
        x = [_on(dev, s * rng.randn(world.num_dofs, CHECK_WORLDS)) for s in (0.4, 0.4, 0.2)]
        before = lcp_cuda.apgd_seed.launches
        per_step = count_launches(lambda: eng.step(*x))
        g = eng.step(*x)
        launched = lcp_cuda.apgd_seed.launches - before
        c64 = BatchedEngine(world, device="cpu", dtype=torch.float64).step(
            *(t.double().cpu() for t in x))
        dq = float(((g.q.double().cpu() - c64.q).abs() / (1 + c64.q.abs())).max())
        dv = float(((g.v.double().cpu() - c64.v).abs().amax(dim=0)
                    / (1 + c64.v.abs().amax(dim=0))).max())
        print(f"phase 17 ({label}): no rows: impulses {tuple(g.impulses.shape)}, seed "
              f"kernel launches {launched}, CUDA kernel launches per step {per_step}; card "
              f"f32 vs CPU f64: max|dq|/(1+|q|) {dq:.3e}, max|dv|/(1+max|v|) {dv:.3e} "
              f"(bounds {NOROW_DQ:g}, {NOROW_DV:g})")
        check(launched == 0 and g.impulses.shape[0] == 0, f"{label}: a no-row world solved an LCP")
        check(dq <= NOROW_DQ and dv <= NOROW_DV, f"{label}: card step far from the CPU f64 path")
    servo_vjp(dev)


def slice_card_check(label, c):
    share = float((c["dv64"] <= BOX_DV_CLOSE).double().mean())
    print(f"phase 17 ({label}): {CHECK_WORLDS} worlds: card vs CPU f32 with the card's "
          f"seed: max|dz|/(1+max|z|) {c['dz32']:.3e} (bound {SLICE_DZ_SAME:g}), "
          f"max|dv|/(1+max|v|) {c['dv32']:.3e} (bound {SLICE_DV_SAME:g}); card vs CPU f64: "
          f"max|dq|/(1+|q|) {c['dq_rel']:.3e} (bound {DQ_TOL:g}), max|dv| "
          f"{float(c['dv64'].max()):.3e} (bound {DV_TOL:g}), share with |dv| <= "
          f"{BOX_DV_CLOSE:g} {share:.4f}; CPU f32 vs CPU f64: "
          f"{int((c['dv_cpu'] > DV_TOL).sum())} worlds beyond {DV_TOL:g}, max|dv| "
          f"{float(c['dv_cpu'].max()):.3e}")
    check(c["dz32"] <= SLICE_DZ_SAME, f"{label}: card impulses disagree with the CPU's float32 path")
    check(c["dv32"] <= SLICE_DV_SAME, f"{label}: card v disagrees with the CPU's float32 path")
    check(c["dq_rel"] <= DQ_TOL, f"{label}: card q disagrees with the CPU f64 path")
    check(float(c["dv64"].max()) <= DV_TOL, f"{label}: card v far from the CPU f64 path")


def servo_vjp(dev):
    """A VJP through VJP_STEPS remat_steps of the servo scene (saturated),
    card f32 against the CPU's float64 path."""
    from nimblephysics_tpu_torch.batched import BatchedEngine

    grads = {}
    for label, d, dtype in (("card", dev, torch.float32), ("cpu", torch.device("cpu"), torch.float64)):
        world = motor_scene("servo")[0]
        eng = BatchedEngine(world, device=d, dtype=dtype)
        rng = np.random.RandomState(SEED + 172)
        (q, v, _), u = motor_start(eng, "servo", rng, d, VJP_WORLDS)
        wq, wv = (torch.as_tensor(rng.randn(*q.shape), dtype=dtype, device=d) for _ in range(2))
        x = [q.clone().requires_grad_(), v.clone().requires_grad_()]
        qq, vv, z = x[0], x[1], None
        for _ in range(VJP_STEPS):
            r = eng.remat_step(qq, vv, u, z_warm=z)
            qq, vv, z = r.q, r.v, r.impulses
        g = torch.autograd.grad((wq * qq).sum() + (wv * vv).sum(), x)
        grads[label] = torch.cat([t.reshape(-1) for t in g]).double().cpu()
    g, c = grads["card"], grads["cpu"]
    cos = cosine(g, c)
    rel = float((g - c).norm() / c.norm())
    print(f"phase 17 (servo VJP): {VJP_WORLDS} worlds x {VJP_STEPS} remat_steps: card f32 "
          f"vs CPU f64: cosine {cos:.8f} (bound {VJP_COS:g}), |dg|/|g| {rel:.3e} (bound "
          f"{SERVO_VJP_REL:g}), |g| {float(c.norm()):.4e}")
    check(bool(torch.isfinite(g).all()), "servo VJP not finite")
    check(cos >= VJP_COS and rel <= SERVO_VJP_REL, "card servo VJP far from the CPU's")


def slice_kernel_entries(k14, runs):
    """The kernels line's entries for K1b on this slice's LCPs: launches
    from the phase-15 rollouts, phase 14's numbers at each LCP."""
    out = []
    for label, row in k14.items():
        k = row["k1b"]
        out.append({
            "name": f"apgd_seed_pgs/{label}",
            "route": "cuda",
            "source": "nimblephysics_tpu_torch/csrc/apgd_seed.cu",
            "replaces": "nimblephysics_tpu/batched/lcp_pallas.py:118",
            "launches": runs[label]["launches"],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,
        })
    return out


# -- the 10- and 20-box legs and body parameters (phases 18-19) ---------------


def phase18(dev):
    """The wide legs: WIDE_STEPS steps from box_start at their widths, one
    K1b launch a step and never the plain seed; finite, standing; one step
    card vs the CPU's float32 path with the card's seed."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    out = {}
    for boxes, cap, worlds in BOX_WIDE_LEGS:
        label = f"box{boxes}_cap{cap}"
        world, q0, eng = make_box_engine(dev, boxes, cap)
        carry, u = box_start(eng, q0, np.random.RandomState(SEED + 18), dev, worlds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        lcp_cuda.apgd_seed.launches = 0
        with mock.patch.object(lcp_cuda, "seed_plain", _forbidden), \
                mock.patch.object(lcp_cuda, "apgd_plain", _forbidden):
            t0 = time.perf_counter()
            carry = rollout(eng, carry, u, WIDE_STEPS)
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t0
        launches = lcp_cuda.apgd_seed.launches
        peak = torch.cuda.max_memory_allocated(dev)
        qf, vf, zf = carry
        finite = all(bool(torch.isfinite(x).all()) for x in carry)
        per_step = count_launches(lambda: eng.step(qf, vf, u, z_warm=zf))
        top = len(q0) - 1
        dz_w = (qf[top] - float(q0[top])).abs()
        v_w = vf.abs().amax(dim=0)
        dz, vmax = float(dz_w.max()), float(v_w.max())
        heights = qf[5::6] - torch.as_tensor(q0[5::6], dtype=qf.dtype, device=dev)[:, None]
        d = eng.lcp_problem(qf, vf, u).contact_depths
        live = eng.assembler.contact_valid(d).sum(dim=0)
        print(f"phase 18 ({label}): {WIDE_STEPS} steps x {worlds} worlds: "
              f"{dt_s / WIDE_STEPS * 1e3:.3f} ms/step, {worlds * WIDE_STEPS / dt_s:.1f} "
              f"env-steps/s; "
              f"K1b launches {launches}; CUDA kernel launches per step {per_step}; peak "
              f"memory {peak / 2**20:.1f} MiB; LCP n={eng.num_rows} solved "
              f"n={eng.meta_cap.n} r={world.num_dofs}; finite {finite}; top box max|dz| "
              f"{dz:.3e} (limit {STAND_DZ:g}, worlds beyond {int((dz_w > STAND_DZ).sum())}), "
              f"max|v| {vmax:.3e} (limit {STAND_V:g}, worlds beyond "
              f"{int((v_w >= STAND_V).sum())}); per box, max|dz| "
              f"{[round(float(x), 6) for x in heights.abs().amax(dim=1)]}; worlds with "
              f"more penetrating slots than the cap ({cap}): "
              f"{int((live > cap).sum())}/{worlds}, most {int(live.max())}")
        check(launches == WIDE_STEPS,
              f"{label}: K1b launched {launches} times in {WIDE_STEPS} steps")
        check(finite, f"{label}: state not finite")
        check(dz <= STAND_DZ, f"{label}: the top box moved {dz:.3e} from its start")
        check(vmax < STAND_V, f"{label}: the stack is moving (max|v| {vmax:.3e})")
        c = card_vs_cpu(world, (eng, qf, vf, zf, u), WIDE_CHECK_WORLDS)
        print(f"phase 18 ({label}): {WIDE_CHECK_WORLDS} worlds, one step: card vs CPU f32 "
              f"with the card's seed: max|dz|/(1+max|z|) {c['dz32']:.3e} (bound "
              f"{WIDE_DZ_SAME:g}), max|dv|/(1+max|v|) {c['dv32']:.3e} (bound "
              f"{WIDE_DV_SAME:g}); card vs CPU f64: max|dq|/(1+|q|) {c['dq_rel']:.3e} "
              f"(bound {DQ_TOL:g}), max|dv| {float(c['dv64'].max()):.3e}")
        check(c["dz32"] <= WIDE_DZ_SAME, f"{label}: card impulses disagree with the CPU's float32 path")
        check(c["dv32"] <= WIDE_DV_SAME, f"{label}: card v disagrees with the CPU's float32 path")
        check(c["dq_rel"] <= DQ_TOL, f"{label}: card q disagrees with the CPU f64 path")
        out[label] = dict(launches=launches, per_step=per_step, peak=peak,
                          env_steps_s=worlds * WIDE_STEPS / dt_s)
    return out


def body_jitter(world, rng, worlds):
    """tests/test_batched.py's per-world body parameters: masses x (1 + 0.1
    U), COMs + 0.01 N(0, 1), scales 1 + 0.05 U; numpy (NB, ..., worlds)."""
    bodies = [b for s in world.skeletons for b in s.bodies]
    nb = len(bodies)
    return dict(
        masses=np.array([b.mass for b in bodies])[:, None] * (1.0 + 0.1 * rng.rand(nb, worlds)),
        coms=np.stack([b.com for b in bodies])[:, :, None] + 0.01 * rng.randn(nb, 3, worlds),
        scales=1.0 + 0.05 * rng.rand(nb, 3, worlds))


def card_seed_detached(meta, F, b, mu, z0, cfm=0.0, z_kernel=None):
    """The card's seed on the CPU with its gradient: the plain seed on
    detached inputs in the kernel's place, and the projected-gradient step
    apgd_seed re-attaches."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    z = lcp_cuda.seed_plain(meta, F.detach(), cfm, b.detach(), mu.detach(), z0.detach())
    return lcp_cuda.pgd_step(meta, F, cfm, b, mu, z)


def body_vjp(world, device, dtype, start, body):
    """d/d(masses, scales) of a seeded weighting of (q, v) after VJP_STEPS
    remat_steps of the default config from start = (q, v, z or None, u)
    with per-world body parameters (numpy, as body_jitter gives them).
    Returns the gradient per world ((NB + 3 NB, worlds), float64 on the
    CPU) and the worlds with impulses after each step."""
    from nimblephysics_tpu_torch.simulation import SolverConfig

    eng = make_engine(device, SolverConfig(), dtype=dtype)[3]
    worlds = start[0].shape[1]
    q, v, z, u = (None if x is None else x.to(device=device, dtype=dtype) for x in start)
    m, sc = (torch.as_tensor(body[k], dtype=dtype, device=device).requires_grad_()
             for k in ("masses", "scales"))
    bp = {"masses": m, "coms": torch.as_tensor(body["coms"], dtype=dtype, device=device),
          "scales": sc}
    rng = np.random.RandomState(SEED + 192)
    wq, wv = (torch.as_tensor(rng.randn(world.num_dofs, worlds), dtype=dtype, device=device)
              for _ in range(2))
    active = []
    for _ in range(VJP_STEPS):
        r = eng.remat_step(q, v, u, z_warm=z, body_params=bp)
        q, v, z = r.q, r.v, r.impulses
        active.append(int((z.detach().abs().amax(dim=0) > 0).sum()))
    g = torch.autograd.grad((wq * q).sum() + (wv * v).sum(), (m, sc))
    return torch.cat([g[0], g[1].reshape(-1, worlds)]).double().cpu(), active


def phase19(dev):
    """Per-world body parameters on the card, from a state settled under
    them: a half-cheetah step with masses, COMs and scales against the CPU
    (phase 5's limits); a VJP through VJP_STEPS remat_steps in masses and
    scales from bench.py's start against the CPU's float64 path (phase 8's
    limits) and from the settled state against the CPU's float32 path;
    and state_step with masses."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, q0, v0, eng = make_engine(dev, SolverConfig())
    rng = np.random.RandomState(SEED + 19)
    carry, u = rollout_start(eng, q0, v0, rng, dev)
    body = body_jitter(world, rng, BATCH)
    # Settled under the jittered bodies, as phase 5's start is: the step
    # below goes through the contact LCP and K1b.
    carry = rollout(eng, carry, u, STEPS, {k: _on(dev, x) for k, x in body.items()})
    c = card_vs_cpu(world, (eng, *carry, u), CHECK_WORLDS, body)
    # The same step with the nominal bodies, for scale (not held).
    c0 = card_vs_cpu(world, (eng, *carry, u), CHECK_WORLDS)
    print(f"phase 19 (step): {CHECK_WORLDS} worlds, per-world masses, COMs and scales, "
          f"after {STEPS} steps: worlds with impulses {c['active']}/{CHECK_WORLDS} (bound "
          f"{BODY_ACTIVE_SHARE:g} of them); "
          f"card vs CPU f32 with the card's seed: max|dz|/(1+max|z|) {c['dz32']:.3e} "
          f"(bound {DZ_SAME:g}), max|dv|/(1+max|v|) {c['dv32']:.3e} (bound {DV_SAME:g}); "
          f"card vs CPU f64: max|dq|/(1+|q|) {c['dq_rel']:.3e} (bound {DQ_TOL:g}), "
          f"max|dv| {float(c['dv64'].max()):.3e}; the same step with the nominal bodies: "
          f"card vs CPU f32 {c0['dz32']:.3e} and {c0['dv32']:.3e}")
    check(c["active"] >= BODY_ACTIVE_SHARE * CHECK_WORLDS,
          "body parameters: too few worlds in contact for the step to hold the LCP")
    check(c["dz32"] <= DZ_SAME, "body parameters: card impulses disagree with the CPU's float32 path")
    check(c["dv32"] <= DV_SAME, "body parameters: card v disagrees with the CPU's float32 path")
    check(c["dq_rel"] <= DQ_TOL, "body parameters: card q disagrees with the CPU f64 path")

    # The VJP from bench.py's start (phase 8's), card f32 vs CPU f64.
    r2 = np.random.RandomState(SEED + 191)
    start_body = body_jitter(world, r2, GRAD_WORLDS)
    start_u = eng.action_to_forces(_on(dev, 0.5 * r2.randn(world.action_size, GRAD_WORLDS)))
    states, _ = train_start(q0, v0, np.random.RandomState(SEED + 2), dev, GRAD_WORLDS)
    nv = world.num_dofs
    start = (states[:nv], states[nv:], None, start_u)
    g, active = body_vjp(world, dev, torch.float32, start, start_body)
    c64, _ = body_vjp(world, "cpu", torch.float64, start, start_body)
    cos = cosine(g.reshape(-1), c64.reshape(-1))
    rel = float((g - c64).norm() / c64.norm())
    print(f"phase 19 (VJP from bench.py's start): {GRAD_WORLDS} worlds x {VJP_STEPS} "
          f"remat_steps, d/d(masses, scales): card f32 vs CPU f64: cosine {cos:.8f} (bound "
          f"{GRAD_COS:g}), |dg|/|g| {rel:.3e} (bound {GRAD_REL:g}), |g| "
          f"{float(c64.norm()):.4e}; worlds with impulses at each step {active}")
    check(bool(torch.isfinite(g).all()), "body-parameter VJP not finite")
    check(cos >= GRAD_COS and rel <= GRAD_REL, "card body-parameter VJP far from the CPU's")

    # The VJP from the settled state above: card vs the CPU's float32 path
    # with the card's seed, world by world; the CPU's float64 path shown.
    settled = tuple(x[:, :GRAD_WORLDS] for x in (*carry, u))
    sbody = {k: x[..., :GRAD_WORLDS] for k, x in body.items()}
    g, active = body_vjp(world, dev, torch.float32, settled, sbody)
    with mock.patch.object(lcp_cuda, "apgd_seed", card_seed_detached):
        c32, _ = body_vjp(world, "cpu", torch.float32, settled, sbody)
    c64, _ = body_vjp(world, "cpu", torch.float64, settled, sbody)

    def per_world(a, b):
        return (a - b).norm(dim=0) / b.norm(dim=0)

    same = per_world(g, c32)
    near64 = float((per_world(g, c64) <= GRAD_REL).double().mean())
    cpu_near64 = float((per_world(c32, c64) <= GRAD_REL).double().mean())
    print(f"phase 19 (VJP from the settled state): {GRAD_WORLDS} worlds x {VJP_STEPS} "
          f"remat_steps, worlds with impulses at each step {active} (bound "
          f"{BODY_ACTIVE_SHARE:g} of them); card f32 vs CPU f32 with the card's seed, "
          f"per world: max |dg|/|g| {float(same.max()):.3e} (bound {BODY_VJP_SAME:g}); "
          f"share of worlds within {GRAD_REL:g} of the CPU f64 path: card {near64:.4f}, "
          f"the CPU's own f32 path {cpu_near64:.4f}")
    check(bool(torch.isfinite(g).all()), "settled body-parameter VJP not finite")
    check(min(active) >= BODY_ACTIVE_SHARE * GRAD_WORLDS,
          "body-parameter VJP: too few worlds in contact")
    check(float(same.max()) <= BODY_VJP_SAME,
          "settled body-parameter VJP: card disagrees with the CPU's float32 path")

    qs, vs = (x[:, :CHECK_WORLDS].contiguous() for x in carry[:2])
    act = _on(dev, rng.randn(world.action_size, CHECK_WORLDS))
    masses = body["masses"][:, :CHECK_WORLDS]
    got = eng.state_step(torch.cat([qs, vs]), act, masses=_on(dev, masses))
    want = make_engine("cpu", SolverConfig(), dtype=torch.float64)[3].state_step(
        torch.cat([qs, vs]).double().cpu(), act.double().cpu(),
        masses=torch.as_tensor(masses, dtype=torch.float64))
    dq = float(((got[:nv].double().cpu() - want[:nv]).abs() / (1.0 + want[:nv].abs())).max())
    plain = eng.state_step(torch.cat([qs, vs]), act)
    moved = float((plain[nv:] - got[nv:]).abs().max())
    print(f"phase 19 (state_step): {CHECK_WORLDS} worlds with per-world masses: q card vs "
          f"CPU f64 max|dq|/(1+|q|) {dq:.3e} (bound {DQ_TOL:g}); v moved by the masses "
          f"{moved:.3e}")
    check(bool(torch.isfinite(got).all()), "state_step with masses not finite")
    check(dq <= DQ_TOL, "state_step with masses: card q disagrees with the CPU f64 path")
    check(moved > 0, "state_step ignored its masses")


# Phase 20: the single-world step (neural/timestep.py), float64 on the card
# against float64 on the CPU from the same state: the same algorithm and
# dtype, only the order of the reductions differs. Set before any reading:
# q to 1e-10, v and the impulses to 1e-8 of 1 + max|.|. A redundant
# contact set (a box's four corners on the ground) leaves z unique only up
# to F^T's null space; the pinned solve returns z in the row space of its
# clamping rows, so that part holds to the same limit.
SW_STEPS = 100
# The card's float64 rollout is only timed (its float32 one is held to the
# CPU): SW_F64_TIMED steps.
SW_F64_TIMED = 10
# The states compared: every SW_EVERY-th, from the fifth (the feet land
# near step 60; on the two-row contacts before step 84 the seed alone is
# often exact, so only states with more live rows can tell it).
SW_EVERY = 10
SW_CONTROL = 3.0
SW_DQ = 1e-10
SW_DV = 1e-8
SW_DZ = 1e-8
# The 4-step VJP in (q, v, control, masses): |dg| / |g|, card vs CPU.
SW_VJP = 1e-8
SW_VJP_STEPS = 4
# float32 on the card: no body deeper into the ground than the CPU float64
# rollout's deepest contact plus this.
SW_DEPTH_SLACK = 1e-3


def sw_world(*skels, gravity=(0.0, 0.0, -9.81), dt=1e-3):
    from nimblephysics_tpu_torch.simulation import World

    w = World(time_step=dt, gravity=gravity)
    for s in skels:
        w.add_skeleton(s)
    return w


def sw_goldens(dev):
    """tests/test_golden_values.py's pendulum and resting-box goldens on
    the card in float64, at that file's tolerances."""
    from nimblephysics_tpu_torch.neural import Engine

    f64 = dict(dtype=torch.float64, device=dev)
    g, dt = 9.81, 1e-3
    eng = Engine(sw_world(_pendulum(1)), device=dev)
    z1 = torch.zeros(1, **f64)
    hang = float(eng.step(z1, z1, z1).v[0])
    horiz = float(eng.step(torch.tensor([np.pi / 2], **f64), z1, z1).v[0])
    want = dt * -(g * 0.5) / (1.0 / 3.0)
    box = Engine(sw_world(_free_box(), _ground()), device=dev)
    q = torch.zeros(6, **f64)
    q[5] = 0.1 - 1e-5
    r = box.step(q, torch.zeros(6, **f64), torch.zeros(6, **f64))
    C = r.contact_depths.shape[0]
    normal = float(r.impulses[: 3 * C][0::3].sum())
    print(f"phase 20 (a): pendulum hanging v' {hang:.3e} (bound 1e-12), horizontal v' "
          f"{horiz:.15e} vs {want:.15e} (rel {abs(horiz / want - 1):.2e}, bound 1e-10); "
          f"resting box normal impulse {normal:.15e} vs m g dt {g * dt:.15e} (rel "
          f"{abs(normal / (g * dt) - 1):.2e}, bound 1e-8)")
    check(abs(hang) <= 1e-12, "hanging pendulum accelerates on the card")
    check(abs(horiz / want - 1) <= 1e-10, "horizontal pendulum acceleration on the card")
    check(abs(normal / (g * dt) - 1) <= 1e-8, "resting box normal impulse on the card")


def sw_compare(card, cpu):
    """(dq, dv, dz), each over 1 + max|.| of the CPU step."""
    def rel(a, b):
        b = b.detach().cpu().double()
        if not b.numel():  # a world with no rows
            return 0.0
        return float((a.detach().cpu().double() - b).abs().max() / (1.0 + b.abs().max()))

    return rel(card.q, cpu.q), rel(card.v, cpu.v), rel(card.impulses, cpu.impulses)


def sw_on(dev, xs, dtype=torch.float64):
    return [x.detach().to(device=dev, dtype=dtype) for x in xs]


def sw_seed_only(meta, F, b, mu, z_warm, cfm=0.0, fallback_cfm=None):
    """The planted fault: the LCP's seed alone (APGD and its PGS sweeps),
    with no refinement rounds and no pinned solve."""
    import dataclasses as dc

    from nimblephysics_tpu_torch.constraint import lcp

    z = lcp._apgd(meta, F, cfm, b, mu, z_warm)
    return lcp._pgs(dc.replace(meta, iterations=meta.seed_pgs_sweeps), F, cfm, b, mu, z)


def sw_vjp(eng, start, u, masses, weights):
    """The gradient of sum_k w_k . [q_k; v_k] over SW_VJP_STEPS steps from
    `start` in (q, v, control, masses), concatenated."""
    q, v, z = (x.clone() for x in start)
    q.requires_grad_()
    v.requires_grad_()
    u = u.clone().requires_grad_()
    m = masses.clone().requires_grad_()
    q0, v0 = q, v
    loss = 0.0
    for w in weights:
        r = eng.step(q, v, u, z_warm=z, body_params={"masses": m})
        q, v, z = r.q, r.v, r.impulses
        loss = loss + torch.dot(w, torch.cat([q, v]))
    return torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, (q0, v0, u, m))])


def sw_cpu_rollout():
    """The half-cheetah from bench.py's start under a seeded control,
    drawn anew each step (SW_CONTROL randn on the leg joints: the legs
    push, so that several rows are live at once), with warm-started
    impulses, SW_STEPS steps on the CPU in float64: (world, controls, the
    CPU engine, the state (q, v, z_warm) before each step, the deepest
    contact, CPU ms a step, and the random state that drew the controls)."""
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.neural import Engine

    world, q0, v0 = half_cheetah()
    rng = np.random.RandomState(SEED + 20)
    q = q0.copy()
    q[1] += rng.uniform(-0.02, 0.02)
    cpu = Engine(world, device="cpu")
    us = [world.action_to_forces(torch.as_tensor(SW_CONTROL * rng.randn(world.action_size)))
          for _ in range(SW_STEPS)]
    state = (torch.as_tensor(q), torch.as_tensor(v0), torch.zeros(cpu.num_constraint_rows,
                                                                   dtype=torch.float64))
    states, deepest = [], 0.0
    t0 = time.perf_counter()
    for u in us:
        states.append(state)
        r = cpu.step(*state[:2], u, z_warm=state[2])
        deepest = max(deepest, float(r.contact_depths.max()))
        state = (r.q, r.v, r.impulses)
    cpu_ms = (time.perf_counter() - t0) / SW_STEPS * 1e3
    check(all(bool(torch.isfinite(x).all()) for x in state), "CPU rollout not finite")
    return world, us, cpu, states, deepest, cpu_ms, rng


def phase20(dev, smi):
    """The single-world timestep on the card (module docstring)."""
    from unittest import mock

    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.models import box_drop, box_stack
    from nimblephysics_tpu_torch.neural import Engine

    # The module (the package exports its function of the same name).
    ts_mod = importlib.import_module("nimblephysics_tpu_torch.neural.timestep")

    launches0 = lcp_cuda.apgd_seed.launches
    sw_goldens(dev)

    # (b) The half-cheetah's CPU float64 rollout (sw_cpu_rollout), and one
    # card step from every SW_EVERY-th of its states.
    world, us, cpu, states, deepest, cpu_ms, rng = sw_cpu_rollout()
    card = Engine(world, device=dev)
    worst = [0.0] * 3
    fault, in_contact = 0.0, 0
    for k in range(SW_EVERY // 2, SW_STEPS, SW_EVERY):
        s, u = states[k], us[k]
        want = cpu.step(*s[:2], u, z_warm=s[2])
        got = card.step(*sw_on(dev, s[:2]), u.to(dev), z_warm=s[2].to(dev))
        worst = [max(a, b) for a, b in zip(worst, sw_compare(got, want))]
        if float(want.impulses.abs().max()) > 0:
            in_contact += 1
            with mock.patch.object(ts_mod, "boxed_lcp", sw_seed_only):
                seed = cpu.step(*s[:2], u, z_warm=s[2])
            fault = max(fault, sw_compare(got, seed)[2])
    print(f"phase 20 (b): half-cheetah, {SW_STEPS} CPU float64 steps (deepest contact "
          f"{deepest:.4e} m), {SW_STEPS // SW_EVERY} card steps from its states "
          f"({in_contact} with impulses): max |dq|/(1+|q|) {worst[0]:.3e} (bound {SW_DQ:g}), "
          f"|dv|/(1+|v|) {worst[1]:.3e} (bound {SW_DV:g}), |dz|/(1+|z|) {worst[2]:.3e} "
          f"(bound {SW_DZ:g}); planted fault (the seed alone) {fault:.3e} (must exceed "
          f"{SW_DZ:g})")
    check(in_contact >= 2, "too few compared states in contact")
    check(worst[0] <= SW_DQ and worst[1] <= SW_DV, "card step q/v disagree with the CPU")
    check(worst[2] <= SW_DZ, "card impulses disagree with the CPU")

    # The JAX models' box_drop (landing flat) and 3-box stack, one step.
    for label, (w, qb, vb) in (("box_drop", box_drop()), ("box_stack(3)", box_stack(3))):
        qb = np.asarray(qb, dtype=np.float64).copy()
        vb = np.asarray(vb, dtype=np.float64).copy()
        if label == "box_drop":
            qb[5], vb[5] = 0.1 - 1e-3, -0.8
        e_cpu, e_card = Engine(w, device="cpu"), Engine(w, device=dev)
        s = [torch.as_tensor(x) for x in (qb, vb, np.zeros(w.num_dofs))]
        want = e_cpu.step(*s)
        got = e_card.step(*sw_on(dev, s))
        d = sw_compare(got, want)
        with mock.patch.object(ts_mod, "boxed_lcp", sw_seed_only):
            d_seed = sw_compare(got, e_cpu.step(*s))[2]
        fault = max(fault, d_seed)
        print(f"phase 20 (b): {label}: |dq| {d[0]:.3e}, |dv| {d[1]:.3e}, |dz| {d[2]:.3e}; "
              f"{int((want.contact_depths > 0).sum())} contacts, max z "
              f"{float(want.impulses.abs().max()):.4e}; the seed alone {d_seed:.3e}")
        check(float(want.impulses.abs().max()) > 0, f"{label}: no impulse")
        check(d[0] <= SW_DQ and d[1] <= SW_DV and d[2] <= SW_DZ,
              f"{label}: the card step disagrees with the CPU")
    # The planted fault must miss the impulse limit somewhere: warm-started
    # on the cheetah's steady contacts the seed can meet it, so the
    # boxes' cold-started impacts count too.
    print(f"phase 20 (e): the seed alone, largest |dz|/(1+|z|) {fault:.3e} "
          f"(must exceed {SW_DZ:g})")
    check(fault > SW_DZ, "the impulse limit cannot tell the seed alone")

    # The card's own rollouts, float64 and float32, timed; CUDA launches a
    # step.
    f32 = Engine(world, device=dev, dtype=torch.float32)
    times, finals = {}, {}
    for label, eng, dtype, steps in (("float64", card, torch.float64, SW_F64_TIMED),
                                     ("float32", f32, torch.float32, SW_STEPS)):
        s = sw_on(dev, states[0], dtype)
        ut = sw_on(dev, us, dtype)
        for _ in range(3):  # warm-up
            eng.step(s[0], s[1], ut[0], z_warm=s[2])
        torch.cuda.synchronize()
        seen, deep = [], 0.0
        t0 = time.perf_counter()
        for k in range(steps):
            if k % SW_EVERY == SW_EVERY // 2:
                seen.append((k, s))
            r = eng.step(s[0], s[1], ut[k], z_warm=s[2])
            s = (r.q, r.v, r.impulses)
            if dtype == torch.float32:
                deep = torch.maximum(torch.as_tensor(deep, device=dev), r.contact_depths.max())
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) / steps * 1e3
        finals[label] = (s, seen, float(deep))
    launches = count_launches(lambda: card.step(*sw_on(dev, states[-1][:2]), us[-1].to(dev),
                                                z_warm=states[-1][2].to(dev)))

    # (d) float32 on the card: finite, no deeper than the float64 rollout
    # plus SW_DEPTH_SLACK, and each of its SW_EVERY-th states stepped on the
    # CPU's float32 path at phase 5's limits.
    (s32, seen32, deep32) = finals["float32"]
    check(all(bool(torch.isfinite(x).all()) for x in s32), "float32 card rollout not finite")
    cpu32 = Engine(world, device="cpu", dtype=torch.float32)
    dz32 = dv32 = 0.0
    for k, s in seen32:
        got = f32.step(s[0], s[1], us[k].to(device=dev, dtype=torch.float32), z_warm=s[2])
        want = cpu32.step(*(x.cpu() for x in s[:2]), us[k].float(), z_warm=s[2].cpu())
        dz32 = max(dz32, float((got.impulses.cpu() - want.impulses).abs().max()
                               / (1.0 + want.impulses.abs().max())))
        dv32 = max(dv32, float((got.v.cpu() - want.v).abs().max()
                               / (1.0 + want.v.abs().max())))
    print(f"phase 20 (d): float32 on the card: deepest contact {deep32:.4e} m (bound "
          f"{deepest + SW_DEPTH_SLACK:.4e}); card vs CPU float32 from {len(seen32)} of its "
          f"states: max|dz|/(1+max|z|) {dz32:.3e} (bound {DZ_SAME:g}), max|dv|/(1+max|v|) "
          f"{dv32:.3e} (bound {DV_SAME:g})")
    check(deep32 <= deepest + SW_DEPTH_SLACK, "float32 card rollout sinks into the ground")
    check(dz32 <= DZ_SAME and dv32 <= DV_SAME, "float32 card step disagrees with the CPU")

    # (c) The VJP of a SW_VJP_STEPS-step loss from a state in contact.
    k_start = max(k for k in range(SW_STEPS) if float(states[k][2].abs().max()) > 0)
    wts = [torch.as_tensor(rng.randn(2 * world.num_dofs)) for _ in range(SW_VJP_STEPS)]
    masses = torch.as_tensor(1.0 + 0.1 * rng.rand(world.num_bodies))
    g_cpu = sw_vjp(cpu, states[k_start], us[k_start], masses, wts)
    args = (sw_on(dev, states[k_start]), us[k_start].to(dev), masses.to(dev),
            [w.to(dev) for w in wts])
    sw_vjp(card, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_card = sw_vjp(card, *args)
    torch.cuda.synchronize()
    vjp_ms = (time.perf_counter() - t0) * 1e3
    rel = float((g_card.cpu() - g_cpu).norm() / g_cpu.norm())
    print(f"phase 20 (c): {SW_VJP_STEPS}-step VJP in (q, v, control, masses) from CPU step "
          f"{k_start} (in contact): |dg|/|g| {rel:.3e} (bound {SW_VJP:g}), |g| "
          f"{float(g_cpu.norm()):.4e}")
    check(rel <= SW_VJP, "card VJP disagrees with the CPU")

    # No kernel of the batched path runs on the single-world one.
    check(lcp_cuda.apgd_seed.launches == launches0, "the single-world step launched the seed kernel")
    print(f"phase 20 (f): {smi}: single-world half-cheetah step {times['float64']:.3f} ms "
          f"(float64), {times['float32']:.3f} ms (float32), CPU float64 {cpu_ms:.3f} ms; "
          f"{launches} CUDA launches a step; {SW_VJP_STEPS}-step VJP {vjp_ms:.3f} ms")


# Phase 21: the BackpropSnapshot Jacobian API (neural/backprop_snapshot.py)
# on the card, float64, against the CPU from the same state. Set before
# any reading: each Jacobian and backprop_state, card vs CPU, to SW_VJP of
# 1 + max|.|; on the card J^T g equals backprop_state to SNAP_JTG of
# 1 + max|.|; box_drop's state Jacobian against the port's Ridders FD
# stepped on the card at the verification battery's 2e-6.
SNAP_JTG = 1e-10
SNAP_FD = 2e-6
# benchmark_jacobians' samples a Jacobian (each one batched reverse pass).
SNAP_SAMPLES = 1


def _free_sphere(radius=0.1):
    """tests/worlds.py's free_sphere: a free unit-mass sphere."""
    from nimblephysics_tpu_torch.dynamics import FREE, ShapeSpec, Skeleton

    sk = Skeleton("sphere")
    sk.add_joint_and_body(FREE, name="sphere", mass=1.0, inertia=np.eye(3) * 0.4 * radius**2,
                          shapes=(ShapeSpec("sphere", np.array([radius])),))
    return sk


def sphere_stack():
    """tests/test_verify_battery.py's sphere_stack: two spheres stacked on
    the ground, the lower one pushed along x: (world, state, action)."""
    world = sw_world(_ground(), _free_sphere(), _free_sphere())
    q = np.zeros(12)
    q[5], q[11] = 0.0999, 0.2995
    u = np.zeros(12)
    u[3] = 0.3
    return world, np.concatenate([q, np.zeros(12)]), u


def snap_worlds():
    """Phase 21's (label, world, state, action), float64 on the CPU: the
    half-cheetah at the state of sw_cpu_rollout whose cold-started step
    has the most live impulse rows (the latest of those), box_drop landing
    on one corner, and the battery's sphere stack."""
    from nimblephysics_tpu_torch.math import lie
    from nimblephysics_tpu_torch.models import box_drop

    world, us, cpu, states, *_ = sw_cpu_rollout()
    best = (0, None)
    for k in range(SW_STEPS - 1):
        if float(states[k + 1][2].abs().max()) > 0:  # step k has impulses warm-started
            live = int((cpu.step(*states[k][:2], us[k]).impulses.abs() > 0).sum())
            best = max(best, (live, k))
    live, k = best
    check(live > 0, "no state of the half-cheetah rollout has a cold-started impulse")
    out = [(f"half-cheetah (step {k}, {live} live rows)", world,
            torch.cat(states[k][:2]), world.forces_to_action(us[k]))]
    bw, _, _ = box_drop()
    rng = np.random.RandomState(SEED + 21)
    R = lie.exp_map_rot(torch.tensor([0.5, 0.4, 0.0], dtype=torch.float64)).numpy()
    q = np.r_[0.5, 0.4, 0.0, 0.0, 0.0, np.max(np.abs(R) @ np.full(3, 0.1)) - 1e-3]
    v = np.r_[0.3 * rng.randn(3), 0.2, -0.1, -0.8]
    out.append(("box_drop (one corner)", bw, torch.as_tensor(np.r_[q, v]),
                torch.zeros(6, dtype=torch.float64)))
    sw, state, u = sphere_stack()
    out.append(("sphere_stack", sw, torch.as_tensor(state), torch.as_tensor(u)))
    return out


def snap_readings(snap, g):
    """What phase 21 holds card vs CPU: the state, action, force-vel and
    mass-vel Jacobians, and backprop_state(g) concatenated."""
    ls, la, lm = snap.backprop_state(g)
    return {"state": snap.get_state_jacobian(), "action": snap.get_action_jacobian(),
            "force-vel": snap.get_force_vel_jacobian(),
            "mass-vel": snap.get_mass_vel_jacobian(), "backprop_state": torch.cat([ls, la, lm])}


def snap_rel(a, b):
    """|a - b| over 1 + max|b|, on the CPU in float64."""
    a, b = (x.detach().cpu().double() for x in (a, b))
    return float((a - b).abs().max() / (1.0 + b.abs().max()))


def phase21(dev, smi):
    """The BackpropSnapshot Jacobians on the card (module docstring)."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.dynamics.skeleton import default_body_params
    from nimblephysics_tpu_torch.neural import forward_pass

    ts_mod = importlib.import_module("nimblephysics_tpu_torch.neural.timestep")

    boxed_lcp = ts_mod.boxed_lcp

    def contact_cut(*args, **kw):  # the planted fault
        return boxed_lcp(*args, **kw).detach()

    launches0 = lcp_cuda.apgd_seed.launches
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 21)
    worst, worst_jtg, fault = {}, 0.0, []
    card_snaps = {}
    for label, world, state, action in snap_worlds():
        masses = torch.cat([default_body_params(sk)["masses"] for sk in world.skeletons])
        g = torch.as_tensor(rng.randn(2 * world.num_dofs))
        cpu = forward_pass(world, state, action, masses=masses)
        card = forward_pass(world, *sw_on(dev, (state, action)), masses=masses.to(dev))
        want, got = snap_readings(cpu, g), snap_readings(card, g.to(dev))
        d = {k: snap_rel(got[k], want[k]) for k in want}
        worst = {k: max(worst.get(k, 0.0), x) for k, x in d.items()}
        bs = got["backprop_state"]
        nv2 = 2 * world.num_dofs
        jtg = max(snap_rel(bs[:nv2], got["state"].T @ g.to(dev)),
                  snap_rel(bs[nv2:nv2 + world.action_size], got["action"].T @ g.to(dev)))
        worst_jtg = max(worst_jtg, jtg)
        with mock.patch.object(ts_mod, "boxed_lcp", contact_cut):
            cut = snap_rel(forward_pass(world, state, action).get_state_jacobian(),
                           got["state"])
        fault.append(cut)
        s32 = forward_pass(world, *sw_on(dev, (state, action), torch.float32))
        c32 = forward_pass(world, state.float(), action.float())
        f32 = snap_rel(s32.get_state_jacobian(), c32.get_state_jacobian())
        z = cpu.result.impulses
        print(f"phase 21 ({label}): {int((z.abs() > 0).sum())} live impulse rows, max|z| "
              f"{float(z.abs().max()):.4e}; card vs CPU float64, |dJ|/(1+max|J|): "
              + ", ".join(f"{k} {x:.3e}" for k, x in d.items())
              + f" (bound {SW_VJP:g}); J^T g vs backprop_state on the card {jtg:.3e} (bound "
              f"{SNAP_JTG:g}); planted fault (impulses detached) {cut:.3e} (must exceed "
              f"{SW_VJP:g}); float32 state Jacobian card vs CPU {f32:.3e} (printed, not held); "
              f"at {time.perf_counter() - t0:.1f} s")
        check(float(z.abs().max()) > 0, f"{label}: the cold-started step has no impulse")
        check(max(d.values()) <= SW_VJP, f"{label}: card Jacobians disagree with the CPU")
        check(jtg <= SNAP_JTG, f"{label}: J^T g differs from backprop_state on the card")
        check(cut > SW_VJP, f"{label}: the limit cannot tell the contact gradient cut")
        card_snaps[label.split(" ")[0]] = (world, card, state, action)

    # Box_drop's state Jacobian against Ridders FD, each step on the card.
    _, box, _, _ = card_snaps["box_drop"]
    J, fd = box.get_state_jacobian().cpu().numpy(), box.finite_difference_state_jacobian()
    fd_err = float(np.max(np.abs(J - fd) - SNAP_FD * np.abs(fd)))
    print(f"phase 21: box_drop state Jacobian vs Ridders FD on the card: max|dJ| "
          f"{float(np.abs(J - fd).max()):.3e}, max|dJ| - {SNAP_FD:g}|J_fd| {fd_err:.3e} "
          f"(bound {SNAP_FD:g}); at {time.perf_counter() - t0:.1f} s")
    check(fd_err <= SNAP_FD, "box_drop state Jacobian disagrees with FD on the card")

    # Costs on the half-cheetah, as a user calls it (no masses): the
    # forward pass, each Jacobian (one batched reverse pass filling every
    # block) and backprop_state.
    world, _, state, action = card_snaps["half-cheetah"]
    args = sw_on(dev, (state, action))
    g = torch.as_tensor(rng.randn(2 * world.num_dofs), device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    snap = forward_pass(world, *args)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t1) * 1e3
    bench = snap.benchmark_jacobians(samples=SNAP_SAMPLES)
    snap.backprop_state(g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(SNAP_SAMPLES):
        snap.backprop_state(g)
    torch.cuda.synchronize()
    bp_ms = (time.perf_counter() - t1) / SNAP_SAMPLES * 1e3
    launches = {  # each Jacobian's on a new snapshot: its reverse pass alone
        "forward_pass": count_launches(lambda: forward_pass(world, *args)),
        "state": count_launches(forward_pass(world, *args).get_state_jacobian),
        "action": count_launches(forward_pass(world, *args).get_action_jacobian),
        "backprop_state": count_launches(lambda: snap.backprop_state(g)),
    }
    check(lcp_cuda.apgd_seed.launches == launches0, "the snapshot launched the seed kernel")
    print(f"phase 21 (costs): {smi}: half-cheetah float64 snapshot: forward_pass "
          f"{fwd_ms:.3f} ms, {launches['forward_pass']} CUDA launches; state Jacobian "
          f"{bench['state'] * 1e3:.3f} ms, {launches['state']} launches; action Jacobian "
          f"{bench['action'] * 1e3:.3f} ms, {launches['action']} launches; backprop_state "
          f"{bp_ms:.3f} ms, {launches['backprop_state']} launches; benchmark_jacobians (ms): "
          + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in bench.items()))
    print(f"phase 21: card vs CPU worst: " + ", ".join(f"{k} {x:.3e}" for k, x in worst.items())
          + f"; J^T g {worst_jtg:.3e}; planted fault smallest {min(fault):.3e}; no seed "
          f"launch; {time.perf_counter() - t0:.1f} s")


# -- terrain, convex meshes, sphere sets and spline joints (22-23) ----------

# Phase 22's terrain: 64 x 64 cells of 0.1 m, heights uniform in [0, 3 cm]
# from the seed. Phase 22 holds K1b to phase 3/6's KERNEL_TOL / PGS_TOL on
# the terrain LCPs, the card step to phase 5's DZ_SAME / DV_SAME on every
# world, and the horizon-20 gradient to phase 8's GRAD_COS / GRAD_REL;
# phase 23 holds its batched scenes to phase 17's SLICE_DZ_SAME /
# SLICE_DV_SAME, its single-world steps to phase 20's SW_DQ / SW_DV /
# SW_DZ and its state Jacobian to phase 21's SNAP_FD. Set before any
# reading of these phases.
TERRAIN_CELLS = 64
TERRAIN_SPACING = 0.1
TERRAIN_BUMP = 0.03
TERRAIN_HORIZON = 20
SCENE_BATCH = 1024
SCENE_STEPS = 20
# Phases 22-23's one-step checks (step_check) hold, world by world, the
# card's impulses' natural-map residual on the CPU's float64 LCP to at
# most RES_SAME above the CPU float32 step's: the engine's own float32
# tolerance on w (batched/lcp.py::_lcp_valid, 10 max(1e-7, 1000 eps)),
# over the same scale, 1 + max|b|. Set before any card reading of it;
# the reading it was sized against is the CPU's own float32 step on
# 1024 settled terrain worlds, whose residual moves by up to 4.0e-4
# under one ulp of input noise (PERF.md § 6).
RES_SAME = 10 * max(1e-7, 1000 * float(np.finfo(np.float32).eps))


def terrain_cheetah(seed=SEED + 22):
    """The half-cheetah on rough terrain: models.half_cheetah() with its
    ground plane replaced by a heightmap (TERRAIN_CELLS^2 cells of
    TERRAIN_SPACING, heights uniform in [0, TERRAIN_BUMP] from `seed`),
    whose frame turns local +z onto the world's +y (the cheetah's gravity
    is -y) with height 0 on the plane's surface. Returns (world, q0, v0,
    the highest point)."""
    from nimblephysics_tpu_torch.dynamics import WELD, ShapeSpec, Skeleton
    from nimblephysics_tpu_torch.models import half_cheetah

    world, q0, v0 = half_cheetah()
    old = world.skeletons[0]
    plane = old.bodies[0].shapes[0]
    heights = TERRAIN_BUMP * np.random.RandomState(seed).rand(TERRAIN_CELLS + 1,
                                                              TERRAIN_CELLS + 1)
    T = np.eye(4)
    T[:3, :3] = [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]
    T[1, 3] = float(plane.size[3])  # the plane's surface, in the ground body's frame
    ground = Skeleton("ground")
    ground.add_joint_and_body(
        WELD, name="ground", T_pj=old.joints[0].T_pj, mass=old.bodies[0].mass,
        shapes=(ShapeSpec("heightmap", np.array([TERRAIN_SPACING, TERRAIN_SPACING, 1.0]),
                          T_offset=T, friction=plane.friction, restitution=plane.restitution,
                          heights=heights),))
    world.skeletons[0] = ground
    return world, q0, v0, float(heights.max())


def make_terrain_engine(dev, dtype=torch.float32):
    """The terrain half-cheetah under the default SolverConfig, with
    bench.py's start lifted by the terrain's highest point: (world, q0,
    v0, engine)."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, q0, v0, top = terrain_cheetah()
    world.solver = SolverConfig()
    q0 = q0.copy()
    q0[1] += top
    return world, q0, v0, BatchedEngine(world, device=dev, dtype=dtype)


def terrain_grads(dev):
    """The policy gradient of one train_step_batched (GRAD_WORLDS worlds,
    horizon TERRAIN_HORIZON) on the terrain, card f32 and CPU f64, from
    the same start and weights."""
    from nimblephysics_tpu_torch.convert import policy_from_arrays
    from nimblephysics_tpu_torch.parallel import train_step_batched

    grads = {}
    for label, d, dtype in (("card", dev, torch.float32),
                            ("cpu", torch.device("cpu"), torch.float64)):
        _, q0, v0, eng = make_terrain_engine(d, dtype)
        states, weights = train_start(q0, v0, np.random.RandomState(SEED + 222), d,
                                      GRAD_WORLDS, dtype)
        policy = policy_from_arrays(*weights, device=d, dtype=dtype)
        train_step_batched(eng, policy, TERRAIN_HORIZON, 0.0)(states)
        grads[label] = policy_grad(policy).double().cpu()
    return grads["card"], grads["cpu"]


def terrain_edge_distance(eng, q):
    """The smallest distance, over the live contacts of one terrain world
    q (nv, 1), of a contact's sample point (its sphere's centre, in the
    heightmap's frame) to a grid line across x: where the bilinear patch
    normal jumps as the cheetah moves. (The planar cheetah lies on the
    grid line y = 0 itself, at exactly gy = 32 on every device.)"""
    from nimblephysics_tpu_torch.batched.articulated import fk

    R, p, *_ = fk(eng.fw, q)
    pts, nrm, dep = (x[..., 0].double().cpu() for x in eng.bcollider.collide(R, p, 1))
    centres = pts + nrm * (0.046 - 0.5 * dep)[:, None]  # the cheetah's capsule radius
    # Heightmap frame: x = world x; grid lines every spacing.
    g = centres[:, 0] / TERRAIN_SPACING
    d = (g - torch.round(g)).abs() * TERRAIN_SPACING
    live = dep > 0
    return float(d[live].min()) if bool(live.any()) else float("nan")


def terrain_lcp(eng, q0, dev):
    """The terrain engine's LCP as phase 6 takes the ground's: one step
    from a seeded state with the feet in the terrain, warm-started from
    that step's impulses: (meta, F, b, mu, z_warm)."""
    rs = np.random.RandomState(SEED + 223)
    q = np.tile(q0[:, None], (1, BATCH)) + 0.02 * rs.randn(len(q0), BATCH)
    q[1] -= 0.27
    uu = eng.action_to_forces(_on(dev, 0.5 * rs.randn(eng.world.action_size, BATCH)))
    first = eng.step(_on(dev, q), _on(dev, 0.3 * rs.randn(len(q0), BATCH)), uu)
    return eng.lcp_blocks(eng.lcp_problem(first.q, first.v, uu), first.impulses)[0][0]


def phase22(dev, report):
    """The half-cheetah on a heightmap at BATCH worlds (module docstring).
    Returns K1b's kernels-line entry on the terrain LCP."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.convert import policy_from_arrays
    from nimblephysics_tpu_torch.parallel import train_step_batched

    t0 = time.perf_counter()
    world, q0, v0, eng = make_terrain_engine(dev)
    kinds = [s.kind for s in eng.collider.slots]
    check(kinds == ["capsule_heightmap"] * 8 and eng.num_rows == 84,
          f"terrain plan: {kinds}, {eng.num_rows} rows")
    rng = np.random.RandomState(SEED + 220)
    carry, u = rollout_start(eng, q0, v0, rng, dev)
    with mock.patch.object(lcp_cuda, "seed_plain", _forbidden), \
            mock.patch.object(lcp_cuda, "apgd_plain", _forbidden):
        carry, launches = timed_rollout(eng, carry, u, "phase 22 (terrain)")
    qf, vf, zf = carry
    per_step = count_launches(lambda: eng.step(qf, vf, u, z_warm=zf))
    print(f"phase 22 (terrain): CUDA kernel launches per step {per_step}; K1b launches "
          f"{launches} in {STEPS} steps; LCP n={eng.num_rows} r={world.num_dofs}")
    meta, F, b, mu, zw = terrain_lcp(eng, q0, dev)
    plan = lcp_cuda.seed_plan(F.shape[0], F.shape[1], lcp_cuda.smem_limit(F.device.index))
    check(plan.tier != "wide", "the terrain LCP took the wide tier")
    row = engine_lcp_check("phase 22", "terrain", meta, F, b, mu, zw, report,
                           ("a dropped contact", dropped_contact), ref64=True)
    # The same on the rollout's settled LCP, warm-started from its impulses.
    engine_lcp_check("phase 22", "terrain, settled", *eng.lcp_blocks(
        eng.lcp_problem(qf, vf, u), zf)[0][0], report, ref64=True)
    w = step_check("phase 22", "terrain", world, eng, qf, vf, zf, u, DZ_SAME, DV_SAME)
    print(f"phase 22 (terrain): world {w}'s live contacts' sample points lie "
          f"{terrain_edge_distance(eng, qf[:, w:w + 1]):.3e} m from a grid line across x")
    states, weights = train_start(q0, v0, np.random.RandomState(SEED + 221), dev)
    policy = policy_from_arrays(*weights, device=dev)
    train = train_step_batched(eng, policy, TERRAIN_HORIZON, LEARNING_RATE)
    torch.cuda.synchronize()
    lcp_cuda.apgd_seed.launches = 0
    t1 = time.perf_counter()
    res = train(states)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t1
    check(lcp_cuda.apgd_seed.launches == TERRAIN_HORIZON,
          f"K1b launched {lcp_cuda.apgd_seed.launches} times in a training step")
    check(bool(torch.isfinite(res.loss)) and bool(torch.isfinite(policy_grad(policy)).all()),
          "terrain training loss or gradient not finite")
    g, cg = terrain_grads(dev)
    cos, rel = cosine(g, cg), float((g - cg).norm() / cg.norm())
    print(f"phase 22 (terrain): train_step_batched {BATCH} worlds x horizon "
          f"{TERRAIN_HORIZON} (first call): {dt_s:.3f} s, {BATCH * TERRAIN_HORIZON / dt_s:.1f} "
          f"fwd+bwd env-steps/s; policy gradient at {GRAD_WORLDS} worlds, card f32 vs CPU "
          f"f64: cosine {cos:.8f} (bound {GRAD_COS:g}), |dg|/|g| {rel:.3e} (bound "
          f"{GRAD_REL:g}), |g| {float(cg.norm()):.4e}")
    check(cos >= GRAD_COS and rel <= GRAD_REL, "terrain: card policy gradient far from the CPU's")
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    k = row["k1b"]
    return {"name": "apgd_seed_pgs/terrain", "route": "cuda",
            "source": "nimblephysics_tpu_torch/csrc/apgd_seed.cu",
            "replaces": "nimblephysics_tpu/batched/lcp_pallas.py:118", "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}


def _cube_verts(h=0.1):
    return np.array([[sx, sy, sz] for sx in (-h, h) for sy in (-h, h) for sz in (-h, h)])


def _octahedron(r=0.1):
    return r * np.array([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])


def _free_shape(name, shape, inertia=0.002):
    """A free unit-mass body carrying `shape`."""
    from nimblephysics_tpu_torch.dynamics import FREE, Skeleton

    sk = Skeleton(name)
    sk.add_joint_and_body(FREE, name=name, mass=1.0, inertia=np.eye(3) * inertia,
                          shapes=(shape,))
    return sk


def _slope_hm():
    """tests/test_terrain.py's sloped heightmap, height 0.3 x on 9 x 9
    points of 0.25 m, as a welded ground."""
    from nimblephysics_tpu_torch.dynamics import WELD, ShapeSpec, Skeleton

    sk = Skeleton("terrain")
    sk.add_joint_and_body(WELD, name="hm", mass=1.0, shapes=(ShapeSpec(
        "heightmap", np.array([0.25, 0.25, 1.0]), friction=0.8,
        heights=np.tile(0.3 * np.linspace(-1, 1, 9), (9, 1))),))
    return sk


def contact_scenes():
    """Phase 23's contact scenes, with the port's API: tests/
    test_mesh_collision.py's cube mesh on the ground and cube mesh on a
    slab under an octahedron mesh (mesh_plane, box_mesh, mesh_mesh), and
    tests/test_terrain.py's sphere, capsule, box and sphere-set bodies on
    its sloped heightmap. (label, world, start(rng, worlds) -> q (nv,
    worlds) numpy): each body a hair into contact, jittered by 5 mm in x
    and 0.05 rad."""
    from nimblephysics_tpu_torch.dynamics import WELD, ShapeSpec, Skeleton

    def mesh(name, verts):
        return _free_shape(name, ShapeSpec("mesh", np.zeros(1), mesh_vertices=verts))

    slab = Skeleton("table")
    slab.add_joint_and_body(WELD, name="slab", mass=1.0,
                            shapes=(ShapeSpec("box", np.array([1.0, 1.0, 0.2])),))

    def placed(z_of, bodies=1):
        def start(rng, worlds):
            q = np.zeros((6 * bodies, worlds))
            for i in range(bodies):
                q[6 * i:6 * i + 3] = 0.05 * rng.randn(3, worlds)
                q[6 * i + 3] = 5e-3 * rng.randn(worlds)
                q[6 * i + 5] = z_of(i, q[6 * i + 3])
            return q
        return start

    c = np.sqrt(1.0 + 0.3**2)  # a point at height gap g over the slope is g / c off it
    ms = np.array([[-0.1, 0.0, 0.0, 0.05], [0.1, 0.0, 0.0, 0.05]])
    return [
        ("mesh_plane", sw_world(_ground(), mesh("cube", _cube_verts())),
         placed(lambda i, x: 0.1 - 1e-3)),
        ("mesh_box_mesh", sw_world(slab, mesh("m1", _cube_verts()), mesh("m2", _octahedron())),
         placed(lambda i, x: (0.2, 0.4)[i] - 1e-3, bodies=2)),
        ("sphere_heightmap", sw_world(_slope_hm(), _free_shape(
            "ball", ShapeSpec("sphere", np.array([0.1]), friction=0.8), 0.004)),
         placed(lambda i, x: 0.3 * x + 0.1 * c - 1e-3)),
        ("capsule_heightmap", sw_world(_slope_hm(), _free_shape(
            "capsule", ShapeSpec("capsule", np.array([0.05, 0.2]), friction=0.8))),
         placed(lambda i, x: 0.3 * x + 0.1 + 0.05 * c - 1e-3)),
        ("box_heightmap", sw_world(_slope_hm(), _free_shape(
            "box", ShapeSpec("box", np.array([0.1, 0.2, 0.1]), friction=0.8))),
         placed(lambda i, x: 0.3 * (x + 0.05) + 0.05 - 1e-3)),
        ("multisphere_heightmap", sw_world(_slope_hm(), _free_shape(
            "dumbbell", ShapeSpec("multisphere", np.zeros(1), friction=0.8, spheres=ms))),
         placed(lambda i, x: 0.3 * (x + 0.1) + 0.05 * c - 1e-3)),
    ]


def custom_skeleton():
    """tests/test_batched.py's spline-driven custom joint: rotation x = q0,
    rotation y = a natural spline of q1, translation x = 0.2 q0, y =
    0.05."""
    from nimblephysics_tpu_torch.dynamics import CUSTOM, CustomJointDef, Skeleton
    from nimblephysics_tpu_torch.math import splines

    xs = np.linspace(-1.5, 1.5, 7)
    cj = CustomJointDef(
        n_dofs=2, rot_axes=np.eye(3), trans_axes=np.eye(3),
        functions=(splines.linear(1.0, 0.0), splines.simm_spline(xs, 0.3 * np.sin(xs)),
                   splines.constant(0.0), splines.linear(0.2, 0.0),
                   splines.constant(0.05), splines.constant(0.0)),
        drives=(0, 1, -1, 0, -1, -1))
    sk = Skeleton("osimish")
    sk.add_joint_and_body(CUSTOM, name="seg", custom=cj, mass=1.1, inertia=np.eye(3) * 0.02)
    return sk


# tests/test_batched.py's BIOMECH_TYPES.
BIOMECH_TYPES = (
    ("ellipsoid", {"radii": (0.07, 0.05, 0.09)}),
    ("scapulathoracic", {"radii": (0.07, 0.05, 0.09), "winging_axis_offset": (0.02, -0.01),
                         "winging_axis_direction": 0.4}),
    ("constantcurve", {"neutral": (0.0, 0.0, 0.0, 0.3)}),
    ("constantcurveincompressible", {"length": 0.35, "neutral": (0.05, 0.0, -0.02)}),
)


def biomech_skeleton(jt, props):
    """tests/test_batched.py's biomechanics world: the joint under a body,
    with a revolute tip hung off it."""
    from nimblephysics_tpu_torch.dynamics import REVOLUTE, Skeleton

    sk = Skeleton(f"bio_{jt}")
    a = sk.add_joint_and_body(jt, name="seg", props=props, mass=1.5, com=(0.0, 0.05, 0.0),
                              inertia=np.eye(3) * 0.01)
    sk.add_joint_and_body(REVOLUTE, parent=a, name="tip", axis=(0, 0, 1),
                          T_pj=_translation((0.05, 0.1, 0.0)), mass=0.4,
                          inertia=np.eye(3) * 0.005)
    return sk


def joint_scenes():
    """(label, world) of phase 23's joint scenes: the custom joint under
    gravity -z, each biomechanics joint under gravity -y."""
    out = [("custom", sw_world(custom_skeleton()))]
    for jt, props in BIOMECH_TYPES:
        out.append((jt, sw_world(biomech_skeleton(jt, props), gravity=(0.0, -9.81, 0.0))))
    return out


def terrain_probe():
    """tests/test_terrain.py's heightmap-gradient world: a sphere falling
    at 0.3 m/s onto 6 x 6 heights 0.05 N(0, 1) of 0.5 m, here 2 mm into
    the terrain (over the origin, the middle of a cell, the bilinear
    height is the mean of its corners): (world, state (12,), action (6,))
    as numpy."""
    from nimblephysics_tpu_torch.dynamics import WELD, ShapeSpec, Skeleton

    heights = 0.05 * np.random.RandomState(0).randn(6, 6)
    ground = Skeleton("terrain")
    ground.add_joint_and_body(WELD, name="hm", mass=1.0, shapes=(ShapeSpec(
        "heightmap", np.array([0.5, 0.5, 1.0]), friction=0.8, heights=heights),))
    world = sw_world(ground, _free_shape("ball", ShapeSpec(
        "sphere", np.array([0.1]), friction=0.8), 0.004))
    state = np.zeros(12)
    state[5], state[11] = float(heights[2:4, 2:4].mean()) + 0.1 - 2e-3, -0.3
    return world, state, np.zeros(6)


def phase23(dev):
    """The meshes, terrain, sphere sets and spline-driven joints at
    SCENE_BATCH worlds, card against the CPU; the single world on the
    card in float64 (module docstring)."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.neural import Engine, forward_pass

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 230)
    for label, world, start in contact_scenes():
        eng = BatchedEngine(world, device=dev)
        q = _on(dev, start(rng, SCENE_BATCH))
        v = _on(dev, 0.05 * rng.randn(world.num_dofs, SCENE_BATCH))
        u = torch.zeros_like(q)
        z = torch.zeros(eng.num_rows, SCENE_BATCH, device=dev)
        torch.cuda.synchronize()
        lcp_cuda.apgd_seed.launches = 0
        with mock.patch.object(lcp_cuda, "seed_plain", _forbidden), \
                mock.patch.object(lcp_cuda, "apgd_plain", _forbidden):
            q, v, z = rollout(eng, (q, v, z), u, SCENE_STEPS)
            torch.cuda.synchronize()
        launches = lcp_cuda.apgd_seed.launches
        active = int((z.abs().amax(dim=0) > 0).sum())
        kinds = sorted({s.kind for s in eng.collider.slots})
        print(f"phase 23 ({label}): {kinds}, LCP n={eng.num_rows}; {SCENE_STEPS} steps x "
              f"{SCENE_BATCH} worlds: K1b launches {launches}; worlds with impulses {active}")
        check(launches == SCENE_STEPS, f"{label}: K1b launched {launches} times")
        check(active > 0 and all(bool(torch.isfinite(x).all()) for x in (q, v, z)),
              f"{label}: no contact or a state not finite")
        step_check("phase 23", label, world, eng, q, v, z, u, SLICE_DZ_SAME, SLICE_DV_SAME)
    for label, world in joint_scenes():
        # tests/test_batched.py's draws (q, v 0.3 N(0, 1), control 0.1 N(0,
        # 1)): the constant-curve joints' S is infinite at a 90 degree bend
        # (asin at 1), in the JAX package as here.
        eng = BatchedEngine(world, device=dev)
        x = [_on(dev, s * rng.randn(world.num_dofs, SCENE_BATCH)) for s in (0.3, 0.3, 0.1)]
        q, v, _ = rollout(eng, (x[0], x[1], None), x[2], SCENE_STEPS)
        check(bool(torch.isfinite(q).all() and torch.isfinite(v).all()), f"{label}: not finite")
        step_check("phase 23", label, world, eng, q, v, None, x[2], SLICE_DZ_SAME,
                   SLICE_DV_SAME)
    # The single world in float64 on the card against the CPU.
    world, state, action = terrain_probe()
    cw = sw_world(custom_skeleton())
    cx = np.random.RandomState(SEED + 231).randn(3, 2)
    for label, w, s, a in (("terrain", world, state, action),
                           ("custom", cw, np.concatenate(cx[:2]), cx[2])):
        nv = w.num_dofs
        cpu = Engine(w, device="cpu").step(*sw_on("cpu", torch.as_tensor(s).split(nv)),
                                           torch.as_tensor(a))
        card = Engine(w, device=dev).step(*sw_on(dev, torch.as_tensor(s).split(nv)),
                                          torch.as_tensor(a, device=dev))
        dq, dv, dz = sw_compare(card, cpu)
        print(f"phase 23 (single world, {label}): card vs CPU float64: |dq| {dq:.3e} (bound "
              f"{SW_DQ:g}), |dv| {dv:.3e} (bound {SW_DV:g}), |dz| {dz:.3e} (bound {SW_DZ:g}); "
              f"max|z| {float(cpu.impulses.abs().max()) if cpu.impulses.numel() else 0.0:.4e}")
        check(dq <= SW_DQ and dv <= SW_DV and dz <= SW_DZ, f"{label}: card step far from the CPU")
    snap = forward_pass(world, torch.as_tensor(state, device=dev),
                        torch.as_tensor(action, device=dev))
    zmax = float(snap.result.impulses.abs().max())
    check(zmax > 0, "the heightmap contact is not live")
    J, fd = snap.get_state_jacobian().cpu().numpy(), snap.finite_difference_state_jacobian()
    fd_err = float(np.max(np.abs(J - fd) - SNAP_FD * np.abs(fd)))
    print(f"phase 23: heightmap state Jacobian vs Ridders FD on the card (max|z| "
          f"{zmax:.4e}): max|dJ| {float(np.abs(J - fd).max()):.3e}, "
          f"max|dJ| - {SNAP_FD:g}|J_fd| {fd_err:.3e} (bound {SNAP_FD:g})")
    check(fd_err <= SNAP_FD, "heightmap state Jacobian disagrees with FD on the card")
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")


# -- the layers on top of the step: trajectory optimisation, MPC and SSID,
# BatchedEnv (phases 24-26) -------------------------------------------------

# Phase 24's half-cheetah MultiShot: TRAJ_SHOTS shots of TRAJ_LEN steps
# from sw_cpu_rollout's state before step TRAJ_START (bench.py's start
# under the seeded control of phase 20; four live contact rows a step),
# the rollout's own controls and its state before step TRAJ_START +
# TRAJ_LEN as the knot; Gauss-Newton on TRAJ_GN_LEN-step shots. Card vs
# CPU in float64 at phase 21's SW_VJP (1e-8 of 1 + max|.|). Set before any
# reading of phases 24-26.
TRAJ_START = 90
TRAJ_SHOTS = 2
TRAJ_LEN = 3
TRAJ_GN_LEN = 2
TRAJ_GN_ITERS = (1, 1)  # outer, inner
# The cartpole (action on the cart) at a time step of 0.05: a MultiShot of
# CART_STEPS steps in shots of CART_SHOT, augmented Lagrangian AL_ITERS
# (outer, inner) at AL_LR, card vs CPU at SW_VJP.
CART_DT = 0.05
CART_STEPS = 6
CART_SHOT = 3
AL_ITERS = (2, 3)
AL_LR = 0.2
# Phase 25: MPC on the cartpole (examples/04_mpc.py's loss and learning
# rate), MPC_STEPS control steps replanning MPC_ITERS Adam iterations over
# MPC_HORIZON steps; SSID on an SSID_WINDOW-step window of the heavier
# cart (tests/test_realtime.py:93, rtol SSID_RTOL) for SSID_ITERS
# iterations at SSID_LR (the JAX test: 15 steps, 150 iterations at 0.08);
# one half-cheetah optimize_plan of MPC_HC (horizon, iterations). Card vs
# CPU at SW_VJP.
MPC_STEPS = 4
MPC_HORIZON = 5
MPC_ITERS = 3
MPC_LR = 0.3
MPC_TARGET = 0.4
MPC_HC = (5, 2)
SSID_WINDOW = 8
SSID_ITERS = 10
SSID_LR = 0.12
SSID_RTOL = 0.08
# Phase 26: BatchedEnv over the half-cheetah, the default config, float32,
# BATCH worlds, ENV_STEPS steps with the horizon at ENV_HORIZON; the
# gradient of a linear policy's ENV_GRAD_STEPS-step return at GRAD_WORLDS
# worlds, card f32 vs CPU f64 at phase 8's GRAD_COS / GRAD_REL.
ENV_STEPS = 50
ENV_HORIZON = 25
ENV_DROP = 0.25
ENV_GRAD_STEPS = 5


def cart_world(dt=None):
    """The cartpole with the action on the cart (at time step dt)."""
    from nimblephysics_tpu_torch.models import cartpole

    world, _, _ = cartpole()
    world.set_action_space([0])
    if dt is not None:
        world.time_step = dt
    return world


def traj_rel(a, b):
    """|a - b| / (1 + max|b|), b the CPU's."""
    a, b = torch.as_tensor(a).detach().cpu().double(), torch.as_tensor(b).detach().cpu().double()
    return float((a - b).abs().max() / (1.0 + b.abs().max())) if b.numel() else 0.0


@functools.lru_cache(maxsize=1)
def sw_states():
    """sw_cpu_rollout's world, controls and states, run once for phases
    24-25."""
    world, us, _, states, _, _, _ = sw_cpu_rollout()
    return world, us, states


def traj_problems(dev, shot_len):
    """The half-cheetah MultiShot (TRAJ_SHOTS shots of shot_len steps) on
    the CPU and on `dev`, and its x (numpy): sw_cpu_rollout's state before
    step TRAJ_START, its controls, its state before TRAJ_START + shot_len
    as the knot, moved by a seeded 1e-4 in q and 1e-2 in v (the knot
    constraints then read ~1e-2)."""
    from nimblephysics_tpu_torch.trajectory import MultiShot

    world, us, states = sw_states()
    idx = torch.as_tensor(world.action_indices.astype(np.int64))
    k, steps = TRAJ_START, TRAJ_SHOTS * shot_len
    start = torch.cat(states[k][:2]).numpy()
    rng = np.random.RandomState(SEED + 24)
    nv = world.num_dofs
    knots = [torch.cat(states[k + i * shot_len][:2]).numpy()
             + np.r_[1e-4 * rng.randn(nv), 1e-2 * rng.randn(nv)] for i in range(1, TRAJ_SHOTS)]
    forces = torch.stack([u[idx] for u in us[k : k + steps]]).numpy()
    x = np.concatenate(knots + [forces.reshape(-1)])

    def loss(ro):
        return torch.sum(ro.vels[-1] ** 2) + 1e-3 * torch.sum(ro.forces ** 2)

    probs = [MultiShot(world, loss, steps, shot_len, start_state=start, device=d)
             for d in ("cpu", dev)]
    return world, probs, x


def first_control(prob, x):
    """The control of a MultiShot's first step at x."""
    na = prob.world.action_size
    forces = prob.tensor(x)[len(x) - prob.steps * na :]
    return prob.world.action_to_forces(forces[:na])


def traj_readings(prob, x, ms=None):
    """loss, constraints, the loss gradient, the per-step constraint and
    final-state Jacobians of a MultiShot at x; ms, if given, gets the
    milliseconds of the rollout (loss and knots), the gradient and the
    per-step Jacobians."""
    from nimblephysics_tpu_torch.trajectory.optimizers import value_and_grad

    def timed(label, fn):
        if prob.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        if prob.device.type == "cuda":
            torch.cuda.synchronize()
        if ms is not None:
            ms[label] = (time.perf_counter() - t1) * 1e3
        return out

    xt = prob.tensor(x)
    with torch.no_grad():
        loss, cons = timed("rollout", lambda: prob.loss_and_constraints(xt))
    _, grad = timed("gradient", lambda: value_and_grad(prob.loss, xt))
    jac = timed("Jacobians", lambda: prob.constraint_jacobian_scan(xt))
    return dict(loss=loss, constraints=cons, grad=grad, jac_scan=jac,
                final_jac=prob.final_state_jacobian(xt))


def first_shot_cut(boxed_lcp, calls):
    """boxed_lcp with its impulses detached for the first `calls` calls:
    the planted faults of phase 24 (the first shot's A_t and B_t taken
    without the contact rows' gradient) and 25 (a replan's)."""
    n = [0]

    def cut(*args, **kw):
        n[0] += 1
        z = boxed_lcp(*args, **kw)
        return z.detach() if n[0] <= calls else z

    return cut


def phase24(dev, smi):
    """Trajectory optimisation on the card in float64 against the CPU
    (module docstring)."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.neural import BackpropSnapshot
    from nimblephysics_tpu_torch.trajectory import (
        AugmentedLagrangianOptimizer,
        GaussNewtonOptimizer,
        MultiShot,
        TerminalResiduals,
    )

    ts_mod = importlib.import_module("nimblephysics_tpu_torch.neural.timestep")
    t0 = time.perf_counter()
    launches0 = lcp_cuda.apgd_seed.launches
    world, (cpu, card), x = traj_problems(dev, TRAJ_LEN)
    nv = world.num_dofs
    ms = {}
    want, got = traj_readings(cpu, x), traj_readings(card, x, ms)
    d = {k: traj_rel(got[k], want[k]) for k in want}
    _, (faulty, _), _ = traj_problems("cpu", TRAJ_LEN)
    with mock.patch.object(ts_mod, "boxed_lcp", first_shot_cut(ts_mod.boxed_lcp, TRAJ_LEN)):
        fault = traj_rel(faulty.constraint_jacobian_scan(faulty.tensor(x)), got["jac_scan"])
    with torch.no_grad():
        rows = int((cpu.engine.step(*cpu.start_state.split(nv), first_control(cpu, x))
                    .impulses.abs() > 0).sum())
    print(f"phase 24 (half-cheetah MultiShot {TRAJ_SHOTS} x {TRAJ_LEN}, {rows} live rows in "
          f"its first step): card vs CPU float64, |d|/(1+max|.|): "
          + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
          + f" (bound {SW_VJP:g}); planted fault (the first shot's A_t, B_t without the "
          f"contact rows) {fault:.3e} (must exceed {SW_VJP:g}); loss "
          f"{float(want['loss']):.6e}, max|h| {float(want['constraints'].abs().max()):.3e}; "
          f"at {time.perf_counter() - t0:.1f} s")
    check(rows > 0, "the MultiShot's first step has no live contact row")
    check(max(d.values()) <= SW_VJP, "the card's trajectory readings disagree with the CPU")
    check(fault > SW_VJP, "the limit cannot tell a shot's Jacobians without contact rows")

    # Launches: the first shot's rollout and one step's A_t, B_t.
    xt, s0, u0 = card.tensor(x), card.start_state, first_control(card, x)

    def shot():
        with torch.no_grad():
            card._states(s0, card._split(xt)[1][0])

    def step_jac():
        snap = BackpropSnapshot(world, s0[:nv], s0[nv:], u0)
        snap.get_state_jacobian()
        snap.get_action_jacobian()

    steps = TRAJ_SHOTS * TRAJ_LEN
    print(f"phase 24 (costs): {smi}: float64 half-cheetah, the {steps}-step MultiShot "
          f"rollout (loss and knots) {ms['rollout']:.1f} ms, {count_launches(shot)} CUDA "
          f"launches a shot of {TRAJ_LEN} steps; the loss gradient {ms['gradient']:.1f} ms; "
          f"the per-step Jacobians "
          f"(a BackpropSnapshot a step, one batched reverse pass each) "
          f"{ms['Jacobians']:.1f} ms, {ms['Jacobians'] / steps:.1f} ms a step, "
          f"{count_launches(step_jac)} launches a step")

    # Gauss-Newton, TRAJ_GN_ITERS, on TRAJ_GN_LEN-step shots.
    runs = {}
    _, probs, xg = traj_problems(dev, TRAJ_GN_LEN)
    for label, prob in zip(("cpu", "card"), probs):
        res = TerminalResiduals(prob, lambda f, u: torch.cat([f[nv:], 0.03 * u.reshape(-1)]))
        calls = []
        sol = GaussNewtonOptimizer(*TRAJ_GN_ITERS).optimize(
            prob, res, x0=xg, structured_jacobian=True,
            callback=lambda k, f, viol: calls.append((f, viol)))
        runs[label] = (sol, calls)
    (cs, cc), (gs, gc) = runs["cpu"], runs["card"]
    gn = max([traj_rel(gs.x, cs.x), traj_rel(gs.loss_history, cs.loss_history)]
             + [traj_rel([a[0], a[1]], [b[0], b[1]]) for a, b in zip(gc, cc)])
    print(f"phase 24 (Gauss-Newton, {TRAJ_SHOTS} x {TRAJ_GN_LEN} steps, {TRAJ_GN_ITERS[0]} "
          f"outer x {TRAJ_GN_ITERS[1]} inner): loss {cc[0][0]:.6e} -> {cs.loss:.6e}, knot "
          f"violation {cc[0][1]:.3e} -> {cs.constraint_violation:.3e}; card vs CPU (x, loss "
          f"history, outer losses and violations) {gn:.3e} (bound {SW_VJP:g}); at "
          f"{time.perf_counter() - t0:.1f} s")
    check(len(gc) == len(cc) == TRAJ_GN_ITERS[0], "Gauss-Newton outer iterations")
    check(gn <= SW_VJP, "the card's Gauss-Newton run disagrees with the CPU's")

    # The cartpole's augmented Lagrangian, card vs CPU.
    runs = {}
    for label, d_ in (("cpu", "cpu"), ("card", dev)):
        w = cart_world(CART_DT)

        def loss(ro):
            qf, vf = ro.poses[-1], ro.vels[-1]
            return (10.0 * (qf[0] - 0.3) ** 2 + 0.1 * vf[0] ** 2
                    + 1e-5 * torch.sum(ro.forces ** 2))

        prob = MultiShot(w, loss, CART_STEPS, CART_SHOT, device=d_)
        x0 = prob.initial_guess([0.0, 0.1, 0.0, 0.0])
        calls = []
        t1 = time.perf_counter()
        sol = AugmentedLagrangianOptimizer(*AL_ITERS, learning_rate=AL_LR).optimize(
            prob, x0, callback=lambda k, f, viol, xx: calls.append((f, viol, xx)))
        torch.cuda.synchronize()
        runs[label] = (sol, calls, time.perf_counter() - t1)
    (cs, cc, _), (gs, gc, g_s) = runs["cpu"], runs["card"]
    al = max(max(traj_rel(g[2], c[2]), traj_rel(g[:2], c[:2])) for g, c in zip(gc, cc))
    grads = AL_ITERS[0] * AL_ITERS[1] * CART_STEPS
    print(f"phase 24 (cartpole augmented Lagrangian, {CART_STEPS} steps at dt {CART_DT}, "
          f"{AL_ITERS[0]} outer x {AL_ITERS[1]} inner): knot violation "
          + " -> ".join(f"{c[1]:.3e}" for c in cc)
          + f"; card vs CPU (iterates, losses, violations) {al:.3e} (bound {SW_VJP:g}); "
          f"{g_s:.2f} s on the card, {g_s / grads * 1e3:.1f} ms a step with its gradient")
    check(al <= SW_VJP, "the card's augmented Lagrangian run disagrees with the CPU's")
    check(lcp_cuda.apgd_seed.launches == launches0, "the single-world path launched the seed")
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")


def mpc_loop(dev):
    """examples/04_mpc.py's loop on the cartpole: MPC_STEPS control steps,
    each recording the state, replanning and stepping under the plan's
    first force. Returns (the states, the plans)."""
    from nimblephysics_tpu_torch.realtime import MPCLocal

    world = cart_world()

    def loss(poses, vels, forces):
        return (10.0 * torch.sum((poses[-1, 0] - MPC_TARGET) ** 2)
                + 0.1 * torch.sum(vels[-1] ** 2) + 1e-5 * torch.sum(forces ** 2))

    mpc = MPCLocal(world, loss, horizon_steps=MPC_HORIZON, replan_iterations=MPC_ITERS,
                   learning_rate=MPC_LR, device=dev)
    state = torch.zeros(4, dtype=torch.float64, device=dev)
    t, states, plans = 0.0, [], []
    for _ in range(MPC_STEPS):
        mpc.record_ground_truth_state(t, state.cpu().numpy())
        mpc.optimize_plan(t)
        plans.append(mpc.buffer.get_plan_copy()[1])
        u = mpc.get_force(t)
        with torch.no_grad():
            state = mpc.engine.state_step(state, torch.as_tensor(u, device=dev))
        t += world.time_step
        states.append(state.cpu().numpy())
    return mpc, np.stack(states), np.stack(plans)


def ssid_fit(dev):
    """SSID on the heavier cart (tests/test_realtime.py:93's data, stepped on
    `dev`): the fitted masses."""
    from nimblephysics_tpu_torch.realtime import SSID

    world = cart_world()
    ssid = SSID(world, window_steps=SSID_WINDOW, fit_iterations=SSID_ITERS,
                learning_rate=SSID_LR, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    heavy = torch.tensor([12.0, 4.8953899], **f64)
    rng = np.random.RandomState(0)
    state, t = torch.tensor([0.0, 0.2, 0.0, 0.0], **f64), 0.0
    ssid.register_sensors(t, state.cpu().numpy())
    with torch.no_grad():
        for _ in range(SSID_WINDOW):
            u = torch.as_tensor(rng.randn(1) * 4.0, **f64)
            ssid.register_controls(t, u.cpu().numpy())
            state = ssid.engine.state_step(state, u, heavy)
            t += world.time_step
            ssid.register_sensors(t, state.cpu().numpy())
    return ssid.run_inference()


def phase25(dev, smi):
    """MPC and SSID on the card in float64 against the CPU (module
    docstring)."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.realtime import MPCLocal

    t0 = time.perf_counter()
    launches0 = lcp_cuda.apgd_seed.launches
    _, cpu_states, cpu_plans = mpc_loop("cpu")
    t1 = time.perf_counter()
    mpc, states, plans = mpc_loop(dev)
    loop_s = time.perf_counter() - t1
    d = max(traj_rel(states, cpu_states), traj_rel(plans, cpu_plans))
    x0, x1 = 0.0, float(states[-1, 0])
    print(f"phase 25 (MPC, cartpole): {MPC_STEPS} control steps, horizon {MPC_HORIZON}, "
          f"{MPC_ITERS} Adam iterations a replan: cart x {x0:.4f} -> {x1:.6f} (target "
          f"{MPC_TARGET}); card vs CPU plans and states {d:.3e} (bound {SW_VJP:g}); "
          f"{loop_s:.2f} s on the card, {loop_s / MPC_STEPS:.3f} s a control step")
    check(abs(x1 - MPC_TARGET) < abs(x0 - MPC_TARGET), "MPC did not move the cart toward its target")
    check(d <= SW_VJP, "the card's MPC plans disagree with the CPU's")
    # The replan thread on the card: it replans, and stop() ends it.
    count = mpc._replan_count
    mpc.start()
    deadline = time.monotonic() + 120.0
    while mpc._replan_count == count and time.monotonic() < deadline:
        time.sleep(0.05)
    mpc.stop()
    check(mpc._replan_count > count and mpc._thread is None, "the replan thread did not replan")

    cpu_m = ssid_fit("cpu")
    t1 = time.perf_counter()
    m = ssid_fit(dev)
    ssid_s = time.perf_counter() - t1
    dm = traj_rel(m, cpu_m)
    err = abs(m[0] / 12.0 - 1.0)
    print(f"phase 25 (SSID, cartpole): {SSID_WINDOW}-step window, {SSID_ITERS} iterations: "
          f"cart mass 9.4248 -> {m[0]:.4f} (true 12.0, rel {err:.3e}, bound {SSID_RTOL}); card "
          f"vs CPU {dm:.3e} (bound {SW_VJP:g}); {ssid_s:.2f} s on the card")
    check(err <= SSID_RTOL, "SSID did not recover the cart mass on the card")
    check(dm <= SW_VJP, "the card's SSID fit disagrees with the CPU's")

    # One half-cheetah replan, card vs CPU, from phase 24's start; the
    # planted fault: the CPU's replan with the impulses detached.
    world, _, rstates = sw_states()
    start = torch.cat(rstates[TRAJ_START][:2]).numpy()
    ts_mod = importlib.import_module("nimblephysics_tpu_torch.neural.timestep")
    plans = {}
    for label, d_ in (("cpu", "cpu"), ("card", dev), ("cut", "cpu")):
        mpc = MPCLocal(world, lambda p, v, f: torch.sum(v[-1] ** 2) + 1e-3 * torch.sum(f ** 2),
                       horizon_steps=MPC_HC[0], replan_iterations=MPC_HC[1],
                       learning_rate=MPC_LR, device=d_)
        mpc.record_ground_truth_state(0.0, start)
        cut = first_shot_cut(ts_mod.boxed_lcp, sys.maxsize if label == "cut" else 0)
        t1 = time.perf_counter()
        with mock.patch.object(ts_mod, "boxed_lcp", cut):
            mpc.optimize_plan(0.0)
        plans[label] = (mpc.buffer.get_plan_copy()[1], time.perf_counter() - t1)
    dp = traj_rel(plans["card"][0], plans["cpu"][0])
    fault = traj_rel(plans["card"][0], plans["cut"][0])
    print(f"phase 25 (MPC, half-cheetah): one optimize_plan, horizon {MPC_HC[0]}, "
          f"{MPC_HC[1]} iterations: card vs CPU plan {dp:.3e} (bound {SW_VJP:g}); planted "
          f"fault (the CPU's replan with the impulses detached) {fault:.3e} (must exceed "
          f"{SW_VJP:g}); max|plan| {float(np.abs(plans['cpu'][0]).max()):.4e}; {smi}: "
          f"{plans['card'][1]:.2f} s on the card, {plans['cpu'][1]:.2f} s on the CPU")
    check(dp <= SW_VJP, "the card's half-cheetah plan disagrees with the CPU's")
    check(fault > SW_VJP, "the limit cannot tell a replan without contact gradients")
    check(lcp_cuda.apgd_seed.launches == launches0, "the single-world path launched the seed")
    print(f"phase 25: {time.perf_counter() - t0:.1f} s")


def make_env(dev, worlds, dtype=torch.float32, horizon=ENV_HORIZON):
    """BatchedEnv over the half-cheetah (default config): reward the
    root's forward speed less effort; reset to the model's pose with the
    feet at the ground (phase 3's root height, less ENV_DROP) jittered by
    +-2 cm from the env's generator."""
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import BatchedEnv

    world, q0, v0 = half_cheetah()
    nv = world.num_dofs
    t = dict(dtype=dtype, device=dev)
    base = torch.as_tensor(np.concatenate([q0, v0]), **t)

    def reset(gen, k):
        s = base.expand(k, -1).clone()
        s[:, 1] += 0.04 * torch.rand(k, generator=gen, **t) - 0.02 - ENV_DROP
        return s

    def reward(s, a, s2):
        return s2[nv] - 1e-3 * torch.sum(a ** 2)

    return BatchedEnv(world, reward, reset_sampler=reset, horizon=horizon, batch_size=worlds,
                      device=dev, dtype=dtype)


def env_return(env, w, start, steps):
    """The summed reward of `steps` env steps from `start` under the linear
    policy a = tanh(s w)."""
    from nimblephysics_tpu_torch.simulation import EnvState

    st = EnvState(start, torch.zeros(start.shape[0], dtype=torch.int32, device=start.device),
                  torch.Generator(device=start.device).manual_seed(SEED))
    total = 0.0
    for _ in range(steps):
        out = env.step(st, torch.tanh(st.state @ w))
        st, total = out.env_state, total + out.reward.sum()
    return total


def phase26(dev, report):
    """BatchedEnv on the half-cheetah at BATCH worlds (module docstring).
    Returns K1b's kernels-line entry on the env's LCP."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    t0 = time.perf_counter()
    env = make_env(dev, BATCH)
    eng, world = env.engine, env.world
    check(eng.meta.seed_pgs_sweeps == 16, "the env's engine is not on the default config")
    rng = np.random.RandomState(SEED + 26)
    st = env.reset(SEED)
    acts = [_on(dev, 0.5 * rng.randn(BATCH, world.action_size)) for _ in range(ENV_STEPS)]
    env.step(st, acts[0])  # warm-up
    torch.cuda.synchronize()
    lcp_cuda.apgd_seed.launches = 0
    dones = []
    with mock.patch.object(lcp_cuda, "seed_plain", _forbidden), \
            mock.patch.object(lcp_cuda, "apgd_plain", _forbidden), torch.no_grad():
        t1 = time.perf_counter()
        for a in acts:
            prev = st
            out = env.step(st, a)
            st = out.env_state
            dones.append(out.done)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t1
    launches = lcp_cuda.apgd_seed.launches
    done = torch.stack(dones).cpu()
    want = torch.zeros(ENV_STEPS, BATCH, dtype=torch.bool)
    want[ENV_HORIZON - 1 :: ENV_HORIZON] = True
    per_step = count_launches(lambda: env.step(prev, acts[-1]))
    print(f"phase 26 (BatchedEnv, half-cheetah, default config, float32): {ENV_STEPS} steps "
          f"x {BATCH} worlds: {dt_s / ENV_STEPS * 1e3:.3f} ms/step, "
          f"{BATCH * ENV_STEPS / dt_s:.1f} env-steps/s; K1b launches {launches}; CUDA kernel "
          f"launches per env step {per_step}; auto-resets at steps "
          f"{[int(k) + 1 for k in torch.nonzero(done.any(dim=1))[:, 0]]} (horizon "
          f"{ENV_HORIZON}), every world each time {bool(torch.equal(done, want))}")
    check(launches == ENV_STEPS, f"K1b launched {launches} times in {ENV_STEPS} env steps")
    check(bool(torch.equal(done, want)), "the env did not reset every world at its horizon")
    check(bool(torch.isfinite(st.state).all()) and bool((st.steps == 0).all()),
          "env state not finite or step counts not reset")
    # K1 and K1b on the env's LCP (the last step's, its impulses as the warm
    # start) against the plain version; one env step on every world.
    nv = world.num_dofs
    q, v = prev.state.T[:nv].contiguous(), prev.state.T[nv:].contiguous()
    u = eng.action_to_forces(acts[-1].T.contiguous())
    res = eng.step(q, v, u)
    check(int((res.impulses.abs().amax(dim=0) > 0).sum()) > 0, "no env world in contact")
    row = engine_lcp_check("phase 26", "env", *eng.lcp_blocks(
        eng.lcp_problem(q, v, u), res.impulses)[0][0], report,
        ("a dropped contact", dropped_contact))
    step_check("phase 26", "env", world, eng, q, v, None, u, DZ_SAME, DV_SAME)
    # The gradient of a linear policy's return, card f32 vs CPU f64.
    grads = {}
    wrng = np.random.RandomState(SEED + 261)
    w0 = 0.1 * wrng.randn(2 * nv, world.action_size)
    start = prev.state[:GRAD_WORLDS].detach().cpu().double().numpy()
    for label, d_, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float64)):
        e = make_env(d_, GRAD_WORLDS, dtype)
        w = torch.as_tensor(w0, dtype=dtype, device=d_).requires_grad_()
        (grads[label],) = torch.autograd.grad(
            env_return(e, w, torch.as_tensor(start, dtype=dtype, device=d_), ENV_GRAD_STEPS),
            [w])
    g, c = grads["card"].double().cpu().reshape(-1), grads["cpu"].reshape(-1)
    cos, rel = cosine(g, c), float((g - c).norm() / c.norm())
    print(f"phase 26 (BatchedEnv gradient): d(return)/d(policy) over {ENV_GRAD_STEPS} env "
          f"steps at {GRAD_WORLDS} worlds, card f32 vs CPU f64: cosine {cos:.8f} (bound "
          f"{GRAD_COS:g}), |dg|/|g| {rel:.3e} (bound {GRAD_REL:g}), |g| {float(c.norm()):.4e}")
    check(cos >= GRAD_COS and rel <= GRAD_REL, "env: card gradient far from the CPU's")
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")
    k = row["k1b"]
    return {"name": "apgd_seed_pgs/env", "route": "cuda",
            "source": "nimblephysics_tpu_torch/csrc/apgd_seed.cu",
            "replaces": "nimblephysics_tpu/batched/lcp_pallas.py:118", "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}


# Phase 27: the marker-fitting path (biomechanics/, dynamics/queries.py)
# on the card in float64 against the CPU, on the bundled humanoid at full
# width (38 dofs, 19 bodies, 25 markers) and FIT_FRAMES frames of
# synthetic mocap. Set before any card reading: poses, scales, offsets
# and per-frame errors, card vs CPU, to SW_VJP of 1 + max|.| (the same
# algorithm in the same dtype; only reduction orders differ); the
# queries and their scale gradients to SW_VJP; the standing humanoid's
# step at phase 20's limits.
FIT_FRAMES = 256
FIT_SHORT = 64  # the IK iteration's launches at FIT_SHORT and FIT_FRAMES
FIT_GN_ITERS = 10
FIT_IK_ITERS = 8
FIT_ADAM_ITERS = 5
FIT_OCCLUDE = 0.02
FIT_POSE_NOISE = 0.1  # rad (and m at the root), as examples/05_marker_fitting.py
# The Gauss-Newton fit's mean marker error (m): phase27 rehearsed on the
# CPU read FIT_ERR_READ before any card run; the limit is twice that.
FIT_ERR_READ = 5.4246e-3
FIT_ERR_MAX = 1.1e-2


def fit_mocap(frames, seed=SEED + 27):
    """The humanoid and seeded synthetic mocap: poses FIT_POSE_NOISE about
    zero, true scales in [0.85, 1.15] (inside the fitter's bounds),
    FIT_OCCLUDE of the markers NaN; (skeleton, observed (T, M, 3), true
    poses, true scales), made on the CPU in float64."""
    from nimblephysics_tpu_torch.biomechanics import marker_table, marker_world_positions_frames
    from nimblephysics_tpu_torch.models import rajagopal_humanoid

    sk, _ = rajagopal_humanoid()
    rng = np.random.RandomState(seed)
    _, bodies, offsets, _ = marker_table(sk)
    q = FIT_POSE_NOISE * rng.randn(frames, sk.num_dofs)
    s = np.clip(1.0 + 0.05 * rng.randn(sk.num_bodies, 3), 0.85, 1.15)
    pos = marker_world_positions_frames(sk, torch.as_tensor(q.T), bodies,
                                        torch.as_tensor(offsets), torch.as_tensor(s))
    obs = pos.permute(2, 0, 1).numpy().copy()
    obs[rng.rand(frames, len(bodies)) < FIT_OCCLUDE] = np.nan
    return sk, obs, q, s


def fit_rel(got, want):
    """max over the fit's readings of |d| / (1 + max|.|)."""
    out = 0.0
    for k in ("poses", "body_scales", "marker_offsets", "per_frame_error"):
        a, b = getattr(got, k), getattr(want, k)
        out = max(out, float(np.abs(a - b).max() / (1.0 + np.abs(b).max())))
    return out


def fit_prior(sk, groups):
    """A Gaussian prior over three of the humanoid's lengths (thigh,
    shank, upper arm along their bodies' y), each 1 +- 5% of the model's."""
    from nimblephysics_tpu_torch.biomechanics import Anthropometrics, MultivariateGaussian

    a = Anthropometrics()
    names = []
    for body in ("femur_r", "tibia_r", "humerus_r"):
        b = sk.body_index(body)
        length = 2.0 * abs(sk.joints[b].T_cj[1, 3])
        a.add_metric(body, b, 1, length)
        names.append((body, length))
    mu = np.array([x for _, x in names])
    a.set_skeleton(sk)
    a.set_distribution(MultivariateGaussian([n for n, _ in names], mu, np.diag((0.05 * mu) ** 2)))
    return a


def fit_runs(dev, sk, obs, q0, iters=FIT_GN_ITERS, fault=False):
    """(Gauss-Newton fit, Adam fit with the symmetry groups and the
    prior) on `dev`; fault: the Gauss-Newton fit alone, with the offsets
    not scaled by their body."""
    from nimblephysics_tpu_torch.biomechanics import MarkerFitter, ScaleGroups, scaled_fk

    local = (lambda off, s: off) if fault else scaled_fk._local_offsets
    with mock.patch.object(scaled_fk, "_local_offsets", local):
        gn = MarkerFitter(sk, device=dev).fit(obs, q_init=q0, outer_iterations=iters,
                                              ik_iterations=FIT_IK_ITERS, outer_solver="gn")
        if fault:
            return gn, None
        groups = ScaleGroups.from_symmetry(sk)
        adam = MarkerFitter(sk, scale_groups=groups, anthropometrics=fit_prior(sk, groups),
                            device=dev).fit(obs, q_init=q0, outer_iterations=FIT_ADAM_ITERS,
                                            ik_iterations=FIT_IK_ITERS)
    return gn, adam


def phase27(dev, smi):
    """Marker fitting on the card (module docstring)."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.biomechanics import IKInitializer, MarkerFitter
    from nimblephysics_tpu_torch.dynamics import queries
    from nimblephysics_tpu_torch.models import human_standing
    from nimblephysics_tpu_torch.neural import Engine

    t0 = time.perf_counter()
    launches0 = lcp_cuda.apgd_seed.launches
    sk, obs, q_true, s_true = fit_mocap(FIT_FRAMES)
    check((sk.num_dofs, sk.num_bodies, len(sk.markers)) == (38, 19, 25), "the humanoid's width")
    q0_cpu = IKInitializer(sk, device="cpu").initialize(obs)
    q0 = IKInitializer(sk, device=dev).initialize(obs)
    d_init = float(np.abs(q0 - q0_cpu).max() / (1.0 + np.abs(q0_cpu).max()))

    cpu_gn, cpu_adam = fit_runs("cpu", sk, obs, q0_cpu)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    card_gn, card_adam = fit_runs(dev, sk, obs, q0)
    torch.cuda.synchronize()
    fits_s = time.perf_counter() - t1
    fault_gn, _ = fit_runs("cpu", sk, obs, q0_cpu, fault=True)
    d_gn, d_adam, d_fault = (fit_rel(card_gn, cpu_gn), fit_rel(card_adam, cpu_adam),
                             fit_rel(card_gn, fault_gn))
    s_err = float(np.abs(card_gn.body_scales - s_true).max())
    print(f"phase 27 (fits): humanoid {sk.num_dofs} dofs, {sk.num_bodies} bodies, "
          f"{len(sk.markers)} markers, {FIT_FRAMES} frames, {int(np.isnan(obs[..., 0]).sum())} "
          f"occluded; IK initializer card vs CPU {d_init:.3e}; Gauss-Newton "
          f"({FIT_GN_ITERS} x {FIT_IK_ITERS} IK) card vs CPU {d_gn:.3e}, Adam "
          f"({FIT_ADAM_ITERS} x {FIT_IK_ITERS} IK, symmetry groups, prior) {d_adam:.3e} "
          f"(bound {SW_VJP:g}); planted fault (offsets not scaled) {d_fault:.3e} (must "
          f"exceed {SW_VJP:g}); mean marker error {card_gn.avg_marker_error:.4e} m (limit "
          f"{FIT_ERR_MAX:g}, the CPU read {FIT_ERR_READ:g} before any card run), max "
          f"|scale - true| {s_err:.3e}; the card's two fits {fits_s:.1f} s")
    check(d_init <= SW_VJP, "the card's IK initializer disagrees with the CPU's")
    check(max(d_gn, d_adam) <= SW_VJP, "the card's marker fits disagree with the CPU's")
    check(d_fault > SW_VJP, "the limit cannot tell offsets that do not scale")
    check(card_gn.avg_marker_error < FIT_ERR_MAX, "the Gauss-Newton fit did not recover")
    check(all(np.isfinite(getattr(card_adam, k)).all() for k in ("poses", "body_scales")),
          "the Adam fit is not finite")

    # Costs: ms and launches of an outer iteration; one IK iteration's
    # launches at FIT_SHORT and FIT_FRAMES frames.
    fitter = MarkerFitter(sk, device=dev)

    def fit(iters, frames=FIT_FRAMES):
        return fitter.fit(obs[:frames], q_init=q0[:frames], outer_iterations=iters,
                          ik_iterations=FIT_IK_ITERS, outer_solver="gn")

    ms = {}
    for iters in (0, FIT_GN_ITERS):
        fit(iters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fit(iters)
        torch.cuda.synchronize()
        ms[iters] = (time.perf_counter() - t1) * 1e3
    outer_ms = (ms[FIT_GN_ITERS] - ms[0]) / FIT_GN_ITERS
    outer_launches = count_launches(lambda: fit(2)) - count_launches(lambda: fit(1))
    ik = {}
    for frames in (FIT_SHORT, FIT_FRAMES):
        o = torch.as_tensor(np.nan_to_num(obs[:frames]).transpose(1, 2, 0), device=dev)
        m = torch.as_tensor(~np.isnan(obs[:frames, :, 0]).T, device=dev)
        q = torch.as_tensor(q0[:frames].T, device=dev)
        s = torch.ones(sk.num_bodies, 3, dtype=torch.float64, device=dev)
        args = (q, s, fitter._off0, o, m)
        fitter.ik_step(*args)
        ik[frames] = count_launches(lambda: fitter.ik_step(*args))
    print(f"phase 27 (costs): {smi}: a Gauss-Newton outer iteration ({FIT_IK_ITERS} IK "
          f"iterations and the outer step, {FIT_FRAMES} frames) {outer_ms:.1f} ms, "
          f"{outer_launches} CUDA launches; the fit's set-up and final IK {ms[0]:.1f} ms; "
          f"one IK iteration {ik[FIT_SHORT]} launches at {FIT_SHORT} frames, "
          f"{ik[FIT_FRAMES]} at {FIT_FRAMES}")
    check(ik[FIT_SHORT] == ik[FIT_FRAMES], "an IK iteration's launches depend on the frames")

    # The geometry queries and their scale gradients, card vs CPU.
    rng = np.random.RandomState(SEED + 28)
    qq, ss = FIT_POSE_NOISE * rng.randn(sk.num_dofs), s_true
    d_q = 0.0
    for name in ("skeleton_height", "skeleton_lowest_point"):
        vals = []
        for d_ in ("cpu", dev):
            x = torch.as_tensor(ss, device=d_).requires_grad_(True)
            v = getattr(queries, name)(sk, torch.as_tensor(qq, device=d_), x)
            v.backward()
            vals.append((float(v.detach()), x.grad.cpu().numpy()))
        (vc, gc), (vg, gg) = vals
        d_q = max(d_q, abs(vg - vc) / (1.0 + abs(vc)),
                  float(np.abs(gg - gc).max() / (1.0 + np.abs(gc).max())))
    print(f"phase 27 (queries): height and lowest point with their scale gradients, card vs "
          f"CPU {d_q:.3e} (bound {SW_VJP:g})")
    check(d_q <= SW_VJP, "the card's geometry queries disagree with the CPU's")

    # The standing humanoid: one single-world step, card vs CPU.
    world, q_st, v_st = human_standing()
    x = [torch.as_tensor(a, dtype=torch.float64) for a in (q_st, v_st, np.zeros(world.num_dofs))]
    want = Engine(world, device="cpu").step(*x)
    got = Engine(world, device=dev).step(*sw_on(dev, x))
    d = sw_compare(got, want)
    print(f"phase 27 (standing): human_standing step card vs CPU |dq| {d[0]:.3e} (bound "
          f"{SW_DQ:g}), |dv| {d[1]:.3e} (bound {SW_DV:g}), |dz| {d[2]:.3e} (bound "
          f"{SW_DZ:g}); {int((want.contact_depths > 0).sum())} contacts")
    check(d[0] <= SW_DQ and d[1] <= SW_DV and d[2] <= SW_DZ,
          "the standing humanoid's card step disagrees with the CPU")
    check(lcp_cuda.apgd_seed.launches == launches0, "the marker-fitting path launched the seed")
    print(f"phase 27: {time.perf_counter() - t0:.1f} s")


def wide_kernel_entries(k9, runs):
    """The kernels line's entries for K1b on the 10- and 20-box capped
    LCPs: launches from the phase-18 rollouts, phase 9's numbers."""
    out = []
    for label, run in runs.items():
        k = k9[label]["k1b"]
        out.append({
            "name": f"apgd_seed_pgs/{label}",
            "route": "cuda",
            "source": "nimblephysics_tpu_torch/csrc/apgd_seed.cu",
            "replaces": "nimblephysics_tpu/batched/lcp_pallas.py:118",
            "launches": run["launches"],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,
        })
    return out


def main() -> int:
    only = set()
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        only = {int(x) for x in sys.argv[2].split(",")}
        check(only <= {9, *range(18, 28)}, "--only takes phases 9 and 18 to 27")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def done(phases):
        print(f"chip_smoke: phase {phases} done at {time.perf_counter() - t_start:.1f} s")
    repo = Path(__file__).resolve().parent
    if not (repo / "nimblephysics_tpu_torch" / "csrc" / "apgd_seed.cu").is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.batched import lcp_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # 2. Build.
    lib_path, build_s, log = lcp_cuda.build(verbose=True)
    print(f"phase 2: built {lib_path.name} in {build_s:.1f} s")
    report = ptxas_report(log)
    check(len(report) == 2 * (len(lcp_cuda.INSTANCES) + len(lcp_cuda.WIDE_WIDTHS)),
          "ptxas did not report every kernel instantiation")
    for (width, rows, polish), (regs, spill) in sorted(report.items()):
        tier = f"{rows} rows a lane" if rows else "wide tier   "
        print(f"  ptxas: width {width:3d}, {tier}, "
              f"{'K1b' if polish else 'K1 '}: {regs} registers, {spill} bytes spilled")
    if only:
        k9 = phase9(dev, report) if 9 in only else None
        runs = phase18(dev) if 18 in only else None
        if 19 in only:
            phase19(dev)
        if 20 in only:
            phase20(dev, smi)
        if 21 in only:
            phase21(dev, smi)
        if 22 in only:
            print(json.dumps({"kernels": [phase22(dev, report)]}))
        if 23 in only:
            phase23(dev)
        if 24 in only:
            phase24(dev, smi)
        if 25 in only:
            phase25(dev, smi)
        if 26 in only:
            print(json.dumps({"kernels": [phase26(dev, report)]}))
        if 27 in only:
            phase27(dev, smi)
        if k9 and runs:
            print(json.dumps({"kernels": wide_kernel_entries(k9, runs)}))
        print(f"chip_smoke: phases 1, 2 and {sorted(only)} passed; no result line "
              "for a partial run")
        return 3

    world, q0, v0, eng = make_engine(dev)
    meta = eng.meta
    nv, na, nrows = world.num_dofs, world.action_size, eng.num_rows
    rng = np.random.RandomState(SEED)

    # 3. Kernel vs plain. (a) The engine's own LCP with feet on the ground,
    # warm-started from one step's impulses; (b) a seeded random LCP.
    q = np.tile(q0[:, None], (1, BATCH)) + 0.02 * rng.randn(nv, BATCH)
    q[1] -= 0.27
    v = 0.3 * rng.randn(nv, BATCH)
    u = eng.action_to_forces(_on(dev, 0.5 * rng.randn(na, BATCH)))
    inputs6 = (_on(dev, q), _on(dev, v), u)
    first = eng.step(*inputs6)
    prob = eng.lcp_problem(first.q, first.v, u)
    contact_worlds = int((first.impulses.abs().amax(dim=0) > 0).sum())
    check(contact_worlds > 0, "no world in contact for input (a)")
    inputs = {
        "engine_lcp": (prob.F, prob.b.contiguous(), prob.mu.contiguous(),
                       first.impulses.contiguous()),
        "random": random_lcp(meta, nv, BATCH, rng, dev),
    }
    short = dataclasses.replace(meta, iterations=meta.iterations - 1)

    errs = []
    for label, (F, b, mu, z0) in inputs.items():
        z_k = lcp_cuda.apgd_cuda(meta, F, b, mu, z0)
        z_p = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, z0)
        s_k = lcp_cuda.apgd_seed(meta, F, b, mu, z0)
        s_p = lcp_cuda.pgd_step(meta, F, 0.0, b, mu, z_p)
        z_short = lcp_cuda.apgd_plain(short, F, 0.0, b, mu, z0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(z_k).all()), f"kernel output not finite ({label})")
        max_abs, max_rel = rel_err(z_k, z_p)
        _, seed_rel = rel_err(s_k, s_p)
        _, short_rel = rel_err(z_k, z_short)
        _, nostep_rel = rel_err(z_k, s_p)
        errs.append(max_abs)
        print(f"phase 3 ({label}): kernel vs plain max|dz| {max_abs:.3e}, "
              f"max|dz|/(1+max|z|) {max_rel:.3e}; seed (+ step) vs plain + step "
              f"{seed_rel:.3e}; kernel vs plain with {short.iterations} "
              f"iterations {short_rel:.3e}; kernel vs plain + step "
              f"{nostep_rel:.3e}; tol {KERNEL_TOL:g}; worlds in "
              f"contact {contact_worlds}/{BATCH}")
        check(max_rel <= KERNEL_TOL, f"kernel disagrees with plain ({label})")
        check(seed_rel <= KERNEL_TOL, f"card seed disagrees with plain + step ({label})")
        if label == "random":
            check(short_rel > KERNEL_TOL,
                  "the tolerance cannot tell one Nesterov step fewer")
            check(nostep_rel > KERNEL_TOL,
                  "the tolerance cannot tell the seed without its step")
    F, b, mu, z0 = inputs["engine_lcp"]
    k_ms = cuda_ms(lambda: lcp_cuda.apgd_cuda(meta, F, b, mu, z0), 50)
    p_ms = cuda_ms(lambda: lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, z0), 10)
    bound_ms, bound_by = apgd_bound_ms(nrows, nv, BATCH, meta.iterations)
    print(f"phase 3: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) at n={nrows} r={nv} B={BATCH}")
    kernel_shapes("phase 3 (K1)", meta, inputs["engine_lcp"], 0, KERNEL_TOL, dev)
    done(3)

    # 4. Forward rollout.
    carry, u = rollout_start(eng, q0, v0, rng, dev)
    carry, launches = timed_rollout(eng, carry, u, "phase 4")
    qf, vf, zf = carry

    # 5. One step on the card from the rollout's final state, against the
    # CPU in float64 (the port's own path) and in float32 with the card's
    # seed.
    W = CHECK_WORLDS

    def card_seed_plain(meta, F, b, mu, z0, cfm=0.0, z_kernel=None):
        z = lcp_cuda.apgd_plain(meta, F, cfm, b, mu, z0)
        return lcp_cuda.pgd_step(meta, F, cfm, b, mu, z)

    qs, vs, zs, us = (x[:, :W].contiguous() for x in (qf, vf, zf, u))
    g = eng.step(qs, vs, us, z_warm=zs)
    gq, gv = g.q.double().cpu(), g.v.double().cpu()
    cpu64 = BatchedEngine(world, device="cpu", dtype=torch.float64)
    args64 = [x.double().cpu() for x in (qs, vs, us, zs)]
    c64 = cpu64.step(*args64[:3], z_warm=args64[3])
    with mock.patch.object(lcp_cuda, "apgd_seed", card_seed_plain):
        c32 = BatchedEngine(world, device="cpu", dtype=torch.float32).step(
            *(x.cpu() for x in (qs, vs, us)), z_warm=zs.cpu())
        c64s = cpu64.step(*args64[:3], z_warm=args64[3])
    dq_rel = float(((gq - c64.q).abs() / (1.0 + c64.q.abs())).max())
    dv64 = (gv - c64.v).abs().amax(dim=0)
    dv_cpu = (c32.v.double() - c64.v).abs().amax(dim=0)
    dv_step = (c64s.v - c64.v).abs().amax(dim=0)
    dz32 = float(((g.impulses.cpu() - c32.impulses).abs().amax(dim=0)
                  / (1.0 + c32.impulses.abs().amax(dim=0))).max())
    dv32_abs = (gv - c32.v.double()).abs().amax(dim=0)
    dv32 = float((dv32_abs / (1.0 + c32.v.double().abs().amax(dim=0))).max())
    share = float((dv64 <= DV_TOL).double().mean())
    unexplained = int(((dv64 > DV_TOL) & (dv_cpu <= DV_TOL)).sum())
    print(f"phase 5: {W} worlds: card vs CPU f64: max|dq|/(1+|q|) {dq_rel:.3e} "
          f"(bound {DQ_TOL:g}), max|dv| {float(dv64.max()):.3e} (bound {DV_MAX:g}), "
          f"share with |dv| <= {DV_TOL:g} {share:.4f} (bound {DV_SHARE:g}); card "
          f"vs CPU f32 with the card's seed: max|dz|/(1+max|z|) {dz32:.3e} (bound "
          f"{DZ_SAME:g}), max|dv|/(1+max|v|) {dv32:.3e} (bound {DV_SAME:g}), "
          f"max|dv| {float(dv32_abs.max()):.3e}; CPU f32 vs CPU f64: "
          f"{int((dv_cpu > DV_TOL).sum())} worlds beyond {DV_TOL:g}; card-vs-f64 "
          f"gaps the CPU's own f32 path does not show: {unexplained}; the step "
          f"alone (CPU f64 with the card's seed vs its own): "
          f"{int((dv_step > DV_TOL).sum())} worlds beyond {DV_TOL:g}, max|dv| "
          f"{float(dv_step.max()):.3e}")
    check(dq_rel <= DQ_TOL, "card q_next disagrees with the CPU f64 path")
    check(dz32 <= DZ_SAME, "card impulses disagree with the CPU's float32 path")
    check(dv32 <= DV_SAME, "card v_next disagrees with the CPU's float32 path")
    check(float(dv64.max()) <= DV_MAX, "card v_next far from the CPU f64 path")
    check(share >= DV_SHARE, "too few worlds agree with the CPU f64 path")
    done("4-5")

    # 6-8. The default config, training, gradients against the CPU.
    q6, v6, u6 = inputs6
    k1b = phase6(dev, q6, v6, u6, inputs["random"])
    done(6)
    phase7(dev)
    done(7)
    phase8(dev)
    done(8)

    # 9-13. The box-stack path.
    k9 = phase9(dev, report)
    done(9)
    legs = phase10(dev)
    done(10)
    phase11(dev, legs)
    isl = phase12(dev)
    phase13(dev)
    done("11-13")

    # 14-17. The reference suite's worlds, the motor scenes and the rest.
    k14 = phase14(dev, report)
    done(14)
    runs = phase15(dev)
    done(15)
    phase16(dev)
    done(16)
    phase17(dev, runs)
    done(17)

    # 18-19. The 10- and 20-box legs; body parameters.
    wide = phase18(dev)
    done(18)
    phase19(dev)
    done(19)

    # 20-21. The single-world timestep; its Jacobians.
    phase20(dev, smi)
    done(20)
    phase21(dev, smi)
    done(21)

    # 22-23. Terrain, convex meshes, sphere sets and spline-driven joints.
    terrain = phase22(dev, report)
    done(22)
    phase23(dev)
    done(23)

    # 24-26. Trajectory optimisation, MPC and SSID on one world; BatchedEnv.
    phase24(dev, smi)
    done(24)
    phase25(dev, smi)
    done(25)
    env = phase26(dev, report)
    done(26)

    # 27. Marker fitting on the bundled humanoid.
    phase27(dev, smi)
    done(27)

    kernel = {
        "name": "apgd_seed",
        "route": "cuda",
        "source": "nimblephysics_tpu_torch/csrc/apgd_seed.cu",
        "replaces": "nimblephysics_tpu/batched/lcp_pallas.py:67",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    print(json.dumps({"kernels": [kernel, k1b, *box_kernel_entries(k9, legs, isl),
                                  *slice_kernel_entries(k14, runs),
                                  *wide_kernel_entries(k9, wide), terrain, env]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
