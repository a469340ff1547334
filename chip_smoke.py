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
  then a JSON line per kernel and, last, {"ok": true, "device": ...}.

Matmuls run in full float32: TF32 is switched off for matmuls and cuDNN,
since F = J L^-T and the pinned solves would otherwise keep only ~3
digits and the stated float32 tolerances would not hold.

`make_engine`, `rollout_start` and `rollout` build the main path; the
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


def apgd_bound_ms(n, r, B, iterations):
    """Least time for the seed's work at the card's peaks: each input read
    once and z written once, against the float32 operations it does
    (one operator application A y = F (F^T y) + cfm y is 4nr + 2n)."""
    nbytes = 4 * (n * r * B + 4 * n * B)
    av = 4 * n * r + 2 * n
    flops_world = 6 * (av + 3 * n) + (av + 2 * n) + 2 * n * r + iterations * (
        av + 12 * n
    )
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops_world * B / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _on(dev, x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev).contiguous()


def make_engine(dev):
    """The main path's world and engine: half-cheetah, throughput(), f32."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, q0, v0 = half_cheetah()
    world.solver = SolverConfig.throughput()
    return world, q0, v0, BatchedEngine(world, device=dev, dtype=torch.float32)


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
    first = eng.step(_on(dev, q), _on(dev, v), u)
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

    def rel(got, want):
        d = (got - want).abs()
        return float(d.max()), float((d / (1.0 + want.abs().amax(dim=0))).max())

    errs = []
    for label, (F, b, mu, z0) in inputs.items():
        z_k = lcp_cuda.apgd_cuda(meta, F, b, mu, z0)
        z_p = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, z0)
        s_k = lcp_cuda.apgd_seed(meta, F, b, mu, z0)
        s_p = lcp_cuda.pgd_step(meta, F, 0.0, b, mu, z_p)
        z_short = lcp_cuda.apgd_plain(short, F, 0.0, b, mu, z0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(z_k).all()), f"kernel output not finite ({label})")
        max_abs, max_rel = rel(z_k, z_p)
        _, seed_rel = rel(s_k, s_p)
        _, short_rel = rel(z_k, z_short)
        _, nostep_rel = rel(z_k, s_p)
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
    step_ms = dt_s / STEPS * 1e3
    print(f"phase 4: {STEPS} steps x {BATCH} worlds: {step_ms:.3f} ms/step, "
          f"{BATCH * STEPS / dt_s:.1f} env-steps/s; kernel launches "
          f"{launches}; median root height {median_h:.4f}; worlds with "
          f"impulses {in_contact}/{BATCH}")

    # 5. One step on the card from the rollout's final state, against the
    # CPU in float64 (the port's own path) and in float32 with the card's
    # seed.
    W = CHECK_WORLDS

    def card_seed_plain(meta, F, b, mu, z0, cfm=0.0):
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
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
