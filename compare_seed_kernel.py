#!/usr/bin/env python3
"""Time the APGD seed kernel against other builds of it on one GPU, in
turns.

    git show REV:nimblephysics_tpu_torch/csrc/apgd_seed.cu \
        > __pycache__/apgd_seed_old.cu
    python3 compare_seed_kernel.py --old __pycache__/apgd_seed_old.cu \
        [--alt PATH ...] [--batch 4096]
    python3 compare_seed_kernel.py --wide-parent __pycache__/apgd_seed_parent.cu

--old names a source with the one-thread-per-world design's C interface
(apgd_seed_f32(..., cfm, stream), which sizes its own launch and takes
r <= 16); each --alt a source with this tree's interface (the launch plan
of lcp_cuda.seed_plan). On chip_smoke.py's engine LCP (half-cheetahs on
the ground, n = 60, r = 9), for K1 (SolverConfig.throughput()) and K1b
(the default SolverConfig), every build is first held against the plain
version (chip_smoke's tolerances), then timed with CUDA events over 50
launches, in the order old, this tree's, the alternatives, and back.

--wide-parent names a source whose wide tier has the global-workspace
interface (apgd_wide_f32(..., cfm, rank_width, work, smem, stream): F
staged into n R floats a world of device memory, 4 (10 n + 288) bytes of
shared memory a block). On the 10- and 20-box legs' capped LCPs
(chip_smoke.box_lcp: n = 288, r = 60 at 2048 worlds; n = 576, r = 120 at
1024) it holds both wide tiers against the plain versions (K1, K1b, warm
start), prints each one's placement (CTAs a cluster, shared memory a CTA,
warps and worlds a SM, registers and spills), then times K1, K1b and the
staging alone (0 iterations, 0 sweeps: the power iteration still runs) over
20 launches, in the order parent, this tree's, each --wide-alt (sources
with this tree's wide interface), and back.

--terrain prints, on chip_smoke phase 22's terrain LCPs (the feet pushed
into the terrain, and the rollout's settled LCP after 200 steps; n = 84,
r = 9, 4096 worlds), K1 and K1b from the warm and the cold start against
the plain version in float32 and in float64, the plain float32 against
the float64, and the kernel's gaps to the float32 plain version in
u = F^T z and in the natural-map residual: the readings behind phase
22's float64 reference (A = F F^T has rank 9 of 84 rows, z is not
unique). Holds nothing.

Prints one line per timing and, last, a JSON summary. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke  # noqa: E402
from nimblephysics_tpu_torch.batched import lcp_cuda  # noqa: E402


def _args(meta, F, b, mu, z0):
    isf, fidx, lo, hi = lcp_cuda._static_rows(meta, F.device)
    z = torch.empty_like(b)
    ptrs = [x.data_ptr() for x in (F, b, mu, z0, z, isf, fidx, lo, hi)]
    return z, ptrs


def old_launcher(path):
    """apgd_cuda for a source with the one-thread-per-world interface."""
    lib = ctypes.CDLL(str(lcp_cuda.build(source=path)[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apgd_seed_f32.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, p]
    lib.apgd_seed_f32.restype = i

    def run(meta, F, b, mu, z0, pgs_sweeps=0):
        n, r, B = F.shape
        z, ptrs = _args(meta, F, b, mu, z0)
        err = lib.apgd_seed_f32(*ptrs, n, r, B, int(meta.iterations), pgs_sweeps,
                                0.0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{path}: launch failed, CUDA error {err}")
        return z
    return run


def alt_launcher(path):
    """apgd_cuda for a source with this tree's interface."""
    lib = ctypes.CDLL(str(lcp_cuda.build(source=path)[0]))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.apgd_seed_f32.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, i, i, i, i, sz, p]
    lib.apgd_seed_f32.restype = i

    def run(meta, F, b, mu, z0, pgs_sweeps=0):
        n, r, B = F.shape
        plan = lcp_cuda.seed_plan(n, r, lcp_cuda.smem_limit(F.device.index))
        z, ptrs = _args(meta, F, b, mu, z0)
        err = lib.apgd_seed_f32(*ptrs, n, r, B, int(meta.iterations), pgs_sweeps,
                                0.0, plan.rank_width, plan.rows_per_lane,
                                plan.worlds_per_block, plan.world_stride,
                                plan.smem_bytes,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{path}: launch failed, CUDA error {err}")
        return z
    return run


def parent_wide_launcher(path):
    """apgd_cuda's wide branch for a source with the global-workspace wide
    tier. Returns run(meta, F, b, mu, z0, pgs_sweeps) and place(n, r,
    polish) -> (shared memory a block, resident blocks a SM)."""
    lib = ctypes.CDLL(str(lcp_cuda.build(source=path)[0]))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.apgd_wide_f32.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, i, p, sz, p]
    lib.apgd_wide_f32.restype = i
    lib.apgd_wide_occupancy.argtypes = [i, i, sz]
    lib.apgd_wide_occupancy.restype = i

    def plan(n, r):
        return next(w for w in lcp_cuda.WIDE_WIDTHS if w >= r), 4 * (10 * n + 288)

    def run(meta, F, b, mu, z0, pgs_sweeps=0):
        n, r, B = F.shape
        width, smem = plan(n, r)
        work = torch.empty(B * n * width, dtype=torch.float32, device=F.device)
        z, ptrs = _args(meta, F, b, mu, z0)
        err = lib.apgd_wide_f32(*ptrs, n, r, B, int(meta.iterations), pgs_sweeps, 0.0,
                                width, work.data_ptr(), smem,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{path}: wide launch failed, CUDA error {err}")
        return z

    def place(n, r, polish):
        width, smem = plan(n, r)
        return smem, lib.apgd_wide_occupancy(width, int(polish), smem)
    return run, place


def wide_alt_launcher(path):
    """apgd_cuda's wide branch for a source with this tree's wide interface."""
    lib = ctypes.CDLL(str(lcp_cuda.build(source=path)[0]))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.apgd_wide_f32.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, i, i, i, i, sz, p]
    lib.apgd_wide_f32.restype = i

    def run(meta, F, b, mu, z0, pgs_sweeps=0):
        n, r, B = F.shape
        plan = lcp_cuda.seed_plan(n, r, lcp_cuda.smem_limit(F.device.index))
        z, ptrs = _args(meta, F, b, mu, z0)
        err = lib.apgd_wide_f32(*ptrs, n, r, B, int(meta.iterations), pgs_sweeps, 0.0,
                                plan.rank_width, plan.cluster, plan.rows_per_cta,
                                lcp_cuda.wide_layout(meta), plan.smem_bytes,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{path}: wide launch failed, CUDA error {err}")
        return z
    return run


def compare_wide(parent, alts=()):
    """The parent's wide tier against this tree's (and alternatives with
    this tree's interface), in turns, on the 10- and 20-box capped LCPs.
    Returns {label: {form: {build: [ms, ms]}}}."""
    dev = torch.device("cuda")
    old, old_place = parent_wide_launcher(parent)
    sources = [("parent", parent), ("new", lcp_cuda.SOURCE)] + [
        (f"alt{k}:{Path(a).name}", a) for k, a in enumerate(alts)]
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, together
        logs = list(pool.map(lambda src: lcp_cuda.build(verbose=True, source=src[1])[2],
                             sources))
    reports = {name: chip_smoke.ptxas_report(log) for (name, _), log in zip(sources, logs)}
    builds = {"parent": old, "new": lcp_cuda.apgd_cuda}
    for name, path in sources[2:]:
        builds[name] = wide_alt_launcher(path)
    summary = {}
    for boxes, cap, worlds in chip_smoke.BOX_WIDE_LEGS:
        label = f"box{boxes}_cap{cap}"
        meta, F, b, mu, zw = chip_smoke.box_lcp(dev, boxes, cap, worlds)
        n, r, B = F.shape
        sweeps = int(meta.seed_pgs_sweeps)
        plan = lcp_cuda.seed_plan(n, r, lcp_cuda.smem_limit(F.device.index))
        p1 = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, zw)
        p2 = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, p1, sweeps=sweeps)
        for name, fn in builds.items():
            for form, sw, want, tol in (("K1", 0, p1, chip_smoke.KERNEL_TOL),
                                        ("K1b", sweeps, p2, chip_smoke.PGS_TOL)):
                got = fn(meta, F, b, mu, zw, pgs_sweeps=sw)
                torch.cuda.synchronize()
                _, rel = chip_smoke.rel_err(got, want)
                print(f"{label} {form} {name}: vs plain max|dz|/(1+max|z|) {rel:.3e} "
                      f"(tol {tol:g})")
                chip_smoke.check(rel <= tol, f"{label} {form} {name} disagrees with plain")
        staging = dataclasses.replace(meta, iterations=0)
        for name, fn in builds.items():
            got = fn(staging, F, b, mu, zw)
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(got, zw), f"{label} {name}: 0 iterations moved z")
        for polish in (False, True):
            regs = {k: rep.get((plan.rank_width, 0, polish), (-1, -1))
                    for k, rep in reports.items()}
            smem, blocks = old_place(n, r, polish)
            ctas, sms = lcp_cuda.wide_residency(plan, polish)
            bound, by = chip_smoke.apgd_bound_ms(n, r, B, meta.iterations,
                                                 sweeps if polish else 0)
            for name in list(reports)[2:]:
                print(f"{label} {'K1b' if polish else 'K1 '} {name}: {regs[name][0]} "
                      f"registers, {regs[name][1]} bytes spilled")
            print(f"{label} {'K1b' if polish else 'K1 '} placement: parent: a block of "
                  f"256 threads a world, F in a global workspace, {smem} bytes of shared "
                  f"memory, {blocks * 8} warps and {blocks} worlds a SM, "
                  f"{regs['parent'][0]} registers, {regs['parent'][1]} bytes spilled; "
                  f"new: a cluster of {plan.cluster} CTA(s), {plan.rows_per_cta} rows of F "
                  f"a CTA in shared memory, {plan.smem_bytes} bytes a CTA, "
                  f"{ctas * 8 // sms} warps and {ctas / plan.cluster / sms:.2f} worlds a SM, "
                  f"{regs['new'][0]} registers, {regs['new'][1]} bytes spilled; bound "
                  f"{bound:.4f} ms ({by}) at n={n} r={r} B={B}")
        times = {}
        for form, m, sw in (("staging", staging, 0), ("K1", meta, 0), ("K1b", meta, sweeps)):
            times[form] = {name: [] for name in builds}
            for name in list(builds) + list(builds)[::-1]:
                ms = chip_smoke.cuda_ms(lambda: builds[name](m, F, b, mu, zw, pgs_sweeps=sw), 20)
                times[form][name].append(ms)
                print(f"{label} {form} {name}: {ms:.4f} ms at n={n} r={r} B={B}, "
                      f"{m.iterations} iterations + {sw} sweeps")
        summary[label] = times
    return summary


def engine_lcp(dev, solver, batch):
    """chip_smoke phase 3's engine LCP (a) under `solver`."""
    _, q0, _, eng = chip_smoke.make_engine(dev, solver)
    rng = np.random.RandomState(chip_smoke.SEED)
    nv, na = eng.world.num_dofs, eng.world.action_size
    q = np.tile(q0[:, None], (1, batch)) + 0.02 * rng.randn(nv, batch)
    q[1] -= 0.27
    v = 0.3 * rng.randn(nv, batch)
    u = eng.action_to_forces(chip_smoke._on(dev, 0.5 * rng.randn(na, batch)))
    first = eng.step(chip_smoke._on(dev, q), chip_smoke._on(dev, v), u)
    prob = eng.lcp_problem(first.q, first.v, u)
    return eng.meta, (prob.F, prob.b.contiguous(), prob.mu.contiguous(),
                      first.impulses.contiguous())


def terrain_readings(dev):
    """--terrain (module docstring)."""
    _, q0, v0, eng = chip_smoke.make_terrain_engine(dev)
    lcps = {"feet in": chip_smoke.terrain_lcp(eng, q0, dev)}
    rng = np.random.RandomState(chip_smoke.SEED + 220)
    carry, u = chip_smoke.rollout_start(eng, q0, v0, rng, dev)
    q, v, z = chip_smoke.rollout(eng, carry, u, 2 * chip_smoke.STEPS)
    lcps["settled"] = eng.lcp_blocks(eng.lcp_problem(q, v, u), z)[0][0]
    for label, lcp in lcps.items():
        meta, F, b, mu, zw = (x.detach().contiguous() if torch.is_tensor(x) else x for x in lcp)
        sweeps = meta.seed_pgs_sweeps
        for start, z0 in (("warm", zw), ("cold", torch.zeros_like(zw))):
            plain = {}
            for dt in (torch.float32, torch.float64):
                args = [x.to(dt) for x in (F, b, mu, z0)]
                p1 = lcp_cuda.apgd_plain(meta, args[0], 0.0, *args[1:])
                plain[dt] = (p1, lcp_cuda.pgs_plain(meta, args[0], 0.0, *args[1:3], p1,
                                                    sweeps=sweeps))
            for k, (form, sw) in enumerate((("K1", 0), ("K1b", sweeps))):
                got = lcp_cuda.apgd_cuda(meta, F, b, mu, z0, pgs_sweeps=sw)
                p32, p64 = plain[torch.float32][k], plain[torch.float64][k]
                du, dres = chip_smoke.unique_parts(meta, F, b, mu, got, p32)
                print(f"terrain ({label}, {start} start, {form}): max|dz|/(1+max|z|): kernel vs "
                      f"plain float32 {chip_smoke.rel_err(got, p32)[1]:.3e}, vs plain float64 "
                      f"{chip_smoke.rel_err(got.double(), p64)[1]:.3e}; plain float32 vs "
                      f"float64 {chip_smoke.rel_err(p32.double(), p64)[1]:.3e}; kernel vs plain "
                      f"float32 in u = F^T z {du:.3e}, in the residual {dres:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", help="source with the one-thread-per-world interface")
    ap.add_argument("--alt", action="append", default=[],
                    help="source with this tree's interface (repeatable)")
    ap.add_argument("--batch", type=int, default=chip_smoke.BATCH)
    ap.add_argument("--wide-parent",
                    help="source with the global-workspace wide tier (times the wide tiers)")
    ap.add_argument("--wide-alt", action="append", default=[],
                    help="with --wide-parent: a source with this tree's wide interface "
                         "(repeatable)")
    ap.add_argument("--terrain", action="store_true",
                    help="print the kernel's gaps to the plain version on the terrain LCPs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_seed_kernel: no CUDA device", file=sys.stderr)
        return 2
    from nimblephysics_tpu_torch.simulation import SolverConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    if args.terrain:
        lcp_cuda.build()
        terrain_readings(dev)
        return 0
    if args.wide_parent:
        summary = compare_wide(args.wide_parent, args.wide_alt)
        print(json.dumps({"gpu": torch.cuda.get_device_name(0), "wide_ms": summary}))
        return 0
    sources = [lcp_cuda.SOURCE] + ([args.old] if args.old else []) + args.alt
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, together
        list(pool.map(lambda src: lcp_cuda.build(source=src), sources))
    builds = {"new": lcp_cuda.apgd_cuda}
    if args.old:
        builds["old"] = old_launcher(args.old)
    for k, path in enumerate(args.alt):
        builds[f"alt{k}:{Path(path).name}"] = alt_launcher(path)
    names = list(builds)
    order = ["old"] * bool(args.old) + [x for x in names if x != "old"]
    order = order + order[::-1]

    summary = {}
    for form, solver, tol in (("K1", SolverConfig.throughput(), chip_smoke.KERNEL_TOL),
                              ("K1b", SolverConfig(), chip_smoke.PGS_TOL)):
        meta, lcp = engine_lcp(dev, solver, args.batch)
        sweeps = int(meta.seed_pgs_sweeps)
        want = lcp_cuda.seed_plain(meta, lcp[0], 0.0, *lcp[1:])
        for name in names:
            got = builds[name](meta, *lcp, pgs_sweeps=sweeps)
            torch.cuda.synchronize()
            _, rel = chip_smoke.rel_err(got, want)
            print(f"{form} {name}: vs plain max|dz|/(1+max|z|) {rel:.3e} (tol {tol:g})")
            chip_smoke.check(rel <= tol, f"{form} {name} disagrees with the plain version")
        times = {name: [] for name in names}
        for name in order:
            ms = chip_smoke.cuda_ms(lambda: builds[name](meta, *lcp, pgs_sweeps=sweeps), 50)
            times[name].append(ms)
            print(f"{form} {name}: {ms:.4f} ms at n={meta.n} r={lcp[0].shape[1]} "
                  f"B={args.batch}, {meta.iterations} iterations + {sweeps} sweeps")
        summary[form] = times
    print(json.dumps({"gpu": torch.cuda.get_device_name(0), "batch": args.batch,
                      "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
