#!/usr/bin/env python3
"""Drive nimblephysics_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit;
  2. build the APGD seed kernel from the checkout's CUDA source;
  3. the kernel against its plain PyTorch version, float32 on the card, on
     (a) the LCP the engine assembles for half-cheetahs on the ground and
     (b) a seeded random LCP of the same shape, with times and the bound;
     the card's whole seed (kernel + the re-attached projected-gradient
     step) against the same step on the plain version; and, which must
     miss the tolerance, the plain version with one Nesterov step fewer
     and the kernel's output without the step;
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
     last sweep in reverse row order) that must miss the tolerance; then
     the 100-step warm-started rollout at this config;
  7. training: train_step_batched (4096 worlds, horizon 100, hidden 64,
     float32) under the default config and under throughput(), one
     warm-up call and one timed call each, with the kernel's launches,
     seconds per training step, fwd+bwd env-steps/s and peak memory;
  8. one short training step (64 worlds, horizon 4) on the card against
     the port's float64 CPU path from the same start and weights: the
     cosine and relative error of the policy gradient;
  then a JSON line per kernel and, last, {"ok": true, "device": ...}.

Matmuls run in full float32: TF32 is switched off for matmuls and cuDNN,
since F = J L^-T and the pinned solves would otherwise keep only ~3
digits and the stated float32 tolerances would not hold.

`make_engine`, `rollout_start` and `rollout` build the forward path; the
profiler (profile_torch_step.py) imports them from here.
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
# 1 + max|z|. Measured on the H100: 1.7e-7 on the engine's LCP and
# 1.1e-6 on the random one (PERF.md); the limit is ~10x the larger. The
# plain seed with one Nesterov step fewer must land above it.
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
# space. Read on the H100 (PERF.md): 2.4e-7 on the engine's LCP, 1.25e-5
# on the random one; the limit is 8x the larger. The plain polish one
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(3):
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
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
    print(f"  ptxas: {len(regs)} instantiations, {min(regs)}-{max(regs)} "
          f"registers, {spills} bytes spilled")

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
    mu_r = np.where(meta.is_friction[:, None], 0.9, 0.0) * np.ones((1, BATCH))
    inputs = {
        "engine_lcp": (prob.F, prob.b.contiguous(), prob.mu.contiguous(),
                       first.impulses.contiguous()),
        "random": tuple(_on(dev, x) for x in (
            0.5 * rng.randn(nrows, nv, BATCH), rng.randn(nrows, BATCH), mu_r,
            0.1 * np.abs(rng.randn(nrows, BATCH)))),
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
    print(json.dumps({"kernels": [kernel, k1b]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
