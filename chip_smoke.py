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
  7. training: train_step_batched (4096 worlds, horizon 100, hidden 64,
     float32) under the default config and under throughput(), one
     warm-up call and one timed call each, with the kernel's launches,
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
     resident warps per SM, registers and spills; and a 10-box stack's
     capped LCP (n = 288, r = 60), which the kernel must refuse;
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
  then a JSON line per kernel and, last, {"ok": true, "device": ...}.

Matmuls run in full float32: TF32 is switched off for matmuls and cuDNN,
since F = J L^-T and the pinned solves would otherwise keep only ~3
digits and the stated float32 tolerances would not hold.

`make_engine`, `rollout_start` and `rollout` build the forward path, and
`make_box_engine`, `box_start` and `islands_world` the box-stack path;
the profiler (profile_torch_step.py) imports them from here.
"""

from __future__ import annotations

import dataclasses
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
# Training: bench.py's width.
TRAIN_HORIZON = 100
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
# (boxes, contact_cap); the 10- and 20-box legs are beyond the kernel's
# capacity (n <= 256, r <= 32) and only the refusal is checked.
BOX_LEGS = ((2, None), (3, None), (5, 48))
TOO_WIDE_LEG = (10, 96)
YAW_JITTER = 0.2
# tests/test_stacks.py's standing limits (200 steps, float64): the top
# box's height within 8e-3 of its start, every |v| below 5e-2.
STAND_DZ = 8e-3
STAND_V = 5e-2
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
# Phase 15: tests/test_reference_workloads.py's settling (600 steps, no
# torque) and arm-torque (300 steps there, TORQUE_STEPS here) checks at
# SETTLE_WORLDS worlds; tests/test_motors.py's limits after STEPS steps:
# the ball's anchor within 5e-3, the weld's pose within 2e-3; the servo's
# velocity to its force-limited value, the mimic's ratio and the locked
# joint's rest to float32 rounding (read 1.9e-7, 3.0e-8 and 1.9e-9).
SETTLE_WORLDS = 256
SETTLE_STEPS = 600
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
    bytes)} of each kernel instantiation, from nvcc -Xptxas -v."""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"apgd_seed_kernelILi(\d+)ELi(\d+)ELb([01])E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        if m and regs:
            out[int(m[1]), int(m[2]), m[3] == "1"] = (
                int(regs[1]), int(spill[1]) if spill else 0)
    return out


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


def rollout(eng, carry, u, steps):
    """`steps` warm-started steps from carry = (q, v, z)."""
    q, v, z = carry
    for _ in range(steps):
        r = eng.step(q, v, u, z_warm=z)
        q, v, z = r.q, r.v, r.impulses
    return q, v, z


def timed_rollout(eng, carry, u, label):
    """STEPS warm-up steps, then STEPS timed ones with the kernel's
    launches counted; checks the state and prints the forward cell."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    carry = rollout(eng, carry, u, STEPS)  # warm-up, as bench.py's first call
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
    _, launches = timed_rollout(eng, carry, uu, "phase 6 (default config)")
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
        first = train(states)  # warm-up
        torch.cuda.synchronize()
        grads[label] = policy_grad(policy).clone()
        torch.cuda.reset_peak_memory_stats(dev)
        lcp_cuda.apgd_seed.launches = 0
        t0 = time.perf_counter()
        res = train(states)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        launches[label] = lcp_cuda.apgd_seed.launches
        peak = torch.cuda.max_memory_allocated(dev)
        g = policy_grad(policy)
        print(f"phase 7 ({label}): {BATCH} worlds x horizon {TRAIN_HORIZON}, "
              f"hidden {HIDDEN}: {dt_s:.3f} s/training step, "
              f"{BATCH * TRAIN_HORIZON / dt_s:.1f} fwd+bwd env-steps/s; kernel "
              f"launches {launches[label]}; peak memory {peak / 2**20:.1f} MiB; "
              f"loss {float(first.loss):.6f} -> {float(res.loss):.6f}; "
              f"|grad| {float(g.norm()):.4e}")
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
    """CUDA kernel launches fn() makes, from torch.profiler's host events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name in LAUNCH_CALLS)


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


def engine_lcp_check(phase, label, meta, F, b, mu, zw, report, fault=None):
    """K1 and K1b on one of the engine's own LCPs against their plain
    versions, from its warm start zw and cold (a rollout's first step):
    errors, times, bounds and the launch plan; with fault = (what, fn),
    fn(meta, F, b, mu, z0, z_plain) gives the plain K1 and K1b outputs of
    a planted fault, which must miss both limits. The limits are relative
    to 1 + max|z|; where impulses are ~5e-3 they are ~1e-5 and 1e-4
    absolute and the warm-started seed has converged (one iteration or
    sweep fewer moves it ~1e-9), so the faults change the LCP itself.
    Returns {"n", "r", "B", "impulse_max", "k1": {...}, "k1b": {...}}."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    F, b, mu, zw = (x.detach().contiguous() for x in (F, b, mu, zw))
    n, r, B = F.shape
    sweeps = meta.seed_pgs_sweeps
    check(sweeps == 16, f"{label}: not the default config")
    plan = lcp_cuda.seed_plan(n, r, lcp_cuda.smem_limit(F.device.index))
    row = {"n": n, "r": r, "B": B}
    errs = {}
    for start, z0 in (("warm", zw), ("cold", torch.zeros_like(zw))):
        z1 = lcp_cuda.apgd_cuda(meta, F, b, mu, z0)
        p1 = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, z0)
        z2 = lcp_cuda.apgd_cuda(meta, F, b, mu, z0, pgs_sweeps=sweeps)
        p2 = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, p1, sweeps=sweeps)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(z1).all() and torch.isfinite(z2).all()),
              f"{label}: kernel output not finite ({start})")
        errs["k1", start], errs["k1b", start] = rel_err(z1, p1), rel_err(z2, p2)
        if start == "warm":
            row["impulse_max"] = float(p2.abs().max())
            if fault:
                d1, d2 = fault[1](meta, F, b, mu, z0, p2)
                faults = (rel_err(z1, d1)[1], rel_err(z2, d2)[1])
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
              f"vs plain, max|dz| and max|dz|/(1+max|z|): warm start {wa:.3e}, "
              f"{wr:.3e}; cold {ca:.3e}, {cr:.3e} (tol {tol:g}); {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); width "
              f"{plan.rank_width}, {plan.rows_per_lane} rows a lane, "
              f"{plan.worlds_per_block} worlds a block, {plan.smem_bytes} bytes, "
              f"{warps} resident warps/SM, {regs} registers, {spill} bytes spilled")
        check(max(wr, cr) <= tol,
              f"{label}: {'K1b' if sw else 'K1'} disagrees with its plain version")
    print(f"{phase} ({label}): the engine's max|z| {row['impulse_max']:.4e}")
    if fault:
        print(f"{phase} ({label}): planted fault, {fault[0]}: K1 {faults[0]:.3e} "
              f"(> {KERNEL_TOL:g}), K1b {faults[1]:.3e} (> {PGS_TOL:g})")
        check(faults[0] > KERNEL_TOL and faults[1] > PGS_TOL,
              f"{label}: the limits cannot tell {fault[0]}")
    return row


def phase9(dev, report):
    """K1 and K1b on each box-stack leg's own LCP (the capped one on the
    5-box leg, the first island's in the islands scene), with a dropped
    contact as the planted fault, and a seeded random LCP on the same
    rows and rank (random_check)."""
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

    # Past the kernel's capacity: the 10-box leg's capped LCP is refused,
    # with its numbers, and nothing is launched.
    world, q0, eng = make_box_engine(dev, *TOO_WIDE_LEG)
    (q, v, z), u = box_start(eng, q0, np.random.RandomState(SEED), dev, worlds=64)
    before = lcp_cuda.apgd_seed.launches
    try:
        eng.step(q, v, u, z_warm=z)
        msg = ""
    except NotImplementedError as e:
        msg = str(e)
    print(f"phase 9 (box{TOO_WIDE_LEG[0]}_cap{TOO_WIDE_LEG[1]}): n={eng.meta_cap.n} "
          f"r={world.num_dofs}: {msg or 'NOT REFUSED'}")
    check(f"n={eng.meta_cap.n}" in msg and f"r={world.num_dofs}" in msg,
          "the kernel did not refuse the 10-box LCP with its numbers")
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
            live = eng._contact_valid(d).sum(dim=0)
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


def card_vs_cpu(world, state, worlds):
    """One step of the first `worlds` worlds on the card against the CPU
    float64 path (the port's own) and the CPU float32 path with the
    card's seed (the plain seed plus the projected-gradient step the card
    re-attaches). Returns the comparison's numbers."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.batched import lcp_cuda

    eng, (q, v, z, u) = state[0], (x[:, :worlds].contiguous() for x in state[1:])

    def card_seed_plain(meta, F, b, mu, z0, cfm=0.0, z_kernel=None):
        return lcp_cuda.pgd_step(meta, F, cfm, b, mu, lcp_cuda.seed_plain(meta, F, cfm, b, mu, z0))

    g = eng.step(q, v, u, z_warm=z)
    gq, gv = g.q.double().cpu(), g.v.double().cpu()
    cpu64 = BatchedEngine(world, device="cpu", dtype=torch.float64)
    a64 = [x.double().cpu() for x in (q, v, u, z)]
    c64 = cpu64.step(*a64[:3], z_warm=a64[3])
    with mock.patch.object(lcp_cuda, "apgd_seed", card_seed_plain):
        c32 = BatchedEngine(world, device="cpu", dtype=torch.float32).step(
            *(x.cpu() for x in (q, v, u)), z_warm=z.cpu())
    dv64 = (gv - c64.v).abs().amax(dim=0)
    dv_cpu = (c32.v.double() - c64.v).abs().amax(dim=0)
    return dict(
        dq_rel=float(((gq - c64.q).abs() / (1.0 + c64.q.abs())).max()),
        dz32=float(((g.impulses.cpu() - c32.impulses).abs().amax(dim=0)
                    / (1.0 + c32.impulses.abs().amax(dim=0))).max()),
        dv32=float(((gv - c32.v.double()).abs().amax(dim=0)
                    / (1.0 + c32.v.double().abs().amax(dim=0))).max()),
        dv64=dv64, dv_cpu=dv_cpu,
    )


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
    from nimblephysics_tpu_torch.models.builtin import inertia_box

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
    for k in eng._c.dyn:
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
    SETTLE_WORLDS worms from the reference start, no torque, 600 steps:
    the root rests on the floor (-0.56 < y < 0.1), |v| < 1."""
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
    REF_HORIZON: one warm-up call and one timed call each."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.parallel import train_step_batched

    out = {}
    for i, name in enumerate(REF_WORLDS):
        world, q0, v0, eng = make_ref_engine(dev, name)
        (q, v, _), policy = ref_start(eng, q0, v0, np.random.RandomState(SEED + 160 + i), dev)
        states = torch.cat([q, v])
        train = train_step_batched(eng, policy, REF_HORIZON, LEARNING_RATE)
        first = train(states)
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
              f"{peak / 2**20:.1f} MiB; loss {float(first.loss):.6f} -> "
              f"{float(res.loss):.6f}; |grad| {float(g.norm()):.4e}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    check(len(report) == 2 * len(lcp_cuda.INSTANCES),
          "ptxas did not report every kernel instantiation")
    for (width, rows, polish), (regs, spill) in sorted(report.items()):
        print(f"  ptxas: width {width:2d}, {rows} rows a lane, "
              f"{'K1b' if polish else 'K1 '}: {regs} registers, {spill} bytes spilled")

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

    # 6-8. The default config, training, gradients against the CPU.
    q6, v6, u6 = inputs6
    k1b = phase6(dev, q6, v6, u6, inputs["random"])
    phase7(dev)
    phase8(dev)

    # 9-13. The box-stack path.
    k9 = phase9(dev, report)
    legs = phase10(dev)
    phase11(dev, legs)
    isl = phase12(dev)
    phase13(dev)

    # 14-17. The reference suite's worlds, the motor scenes and the rest.
    k14 = phase14(dev, report)
    runs = phase15(dev)
    phase16(dev)
    phase17(dev, runs)

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
                                  *slice_kernel_entries(k14, runs)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
