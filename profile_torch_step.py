#!/usr/bin/env python3
"""Where a step of nimblephysics_tpu_torch's main path spends its time on
one NVIDIA GPU.

    python3 profile_torch_step.py [--world half_cheetah|box3|box10|box20|
                                           jump_worm|catapult|terrain|single]
                                  [--trace PATH]

Builds the main path of chip_smoke.py with its own functions (4096
worlds, float32) and traces it with torch.profiler. For the half-cheetah
(the default), three cells:
  * the forward rollout under SolverConfig.throughput() and under the
    default SolverConfig (warm-started impulses, settled on the ground
    with chip_smoke.STEPS untraced steps), TRACED_STEPS steps each;
  * one training step (train_step_batched, horizon TRACED_STEPS, hidden
    chip_smoke.HIDDEN, the default SolverConfig) after an untraced one.
For --world box3, the 3-box stack's forward rollout (chip_smoke's
box_start, the default SolverConfig), settled with chip_smoke.STEPS
untraced steps, TRACED_STEPS traced; box10 and box20 the same for the
10- and 20-box legs at chip_smoke.BOX_WIDE_LEGS's contact caps and worlds
(2048 and 1024). For --world jump_worm or catapult,
the reference suite's world under the default SolverConfig driven by its
policy (chip_smoke's make_ref_engine, ref_start and policy_rollout),
after chip_smoke.STEPS untraced steps. For --world terrain, the
half-cheetah on chip_smoke's heightmap (make_terrain_engine, the default
SolverConfig) from rollout_start, settled with chip_smoke.STEPS
untraced steps. For --world single, the
single-world half-cheetah step (neural.Engine, float64) from the last
state in contact of chip_smoke's CPU rollout (sw_cpu_rollout),
TRACED_STEPS steps from that state, and the CUDA launches of each part of
one step (the smooth dynamics, collision and rows; the LCP; its seed).
Prints, per env-step of each cell: host milliseconds, CUDA kernel
launches, summed kernel time and the device's busy share of the wall
time, and the kernels that take the most device time; with --trace,
writes a Chrome trace of each cell there (PATH with the cell's name
before the suffix). Exits non-zero where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke  # noqa: E402

TRACED_STEPS = 5


def _union_us(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(label, fn, steps, trace=None, batch=None):
    """Trace fn() (`steps` env-steps per world of `batch`, chip_smoke.BATCH
    unless given), print and return the per-step summary."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    launches = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.name in chip_smoke.LAUNCH_CALLS
    )
    kernel_us = sum(v[1] for v in by_name.values())
    summary = {
        "cell": label,
        "gpu": torch.cuda.get_device_name(0),
        "batch": batch or chip_smoke.BATCH,
        "steps_traced": n,
        "host_ms_per_step": wall_us / n / 1e3,
        "kernel_launches_per_step": launches / n,
        "device_events_per_step": len(kernels) / n,
        "kernel_ms_per_step": kernel_us / n / 1e3,
        "device_busy_share": busy_us / wall_us,
    }
    print(f"{label}, per step: host {summary['host_ms_per_step']:.3f} ms, "
          f"{summary['kernel_launches_per_step']:.0f} kernel launches, "
          f"{summary['device_events_per_step']:.0f} device events, device "
          f"kernels {summary['kernel_ms_per_step']:.3f} ms, busy share "
          f"{summary['device_busy_share']:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (count, us) in top:
        print(f"  {us / n:9.1f} us/step {count / n:6.0f}x/step  {name[:90]}")
    if trace:
        out = Path(trace)
        out = out.with_name(f"{out.stem}_{label}{out.suffix}")
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
    return summary


def profile_single(dev, trace=None):
    """The single-world step's trace and the launches of its parts."""
    import dataclasses

    from nimblephysics_tpu_torch.constraint import lcp
    from nimblephysics_tpu_torch.neural import Engine

    world, us, _, states, _, _, _ = chip_smoke.sw_cpu_rollout()
    k = max(i for i, s in enumerate(states) if float(s[2].abs().max()) > 0)
    q, v, z = chip_smoke.sw_on(dev, states[k])
    u = us[k].to(dev)
    eng = Engine(world, device=dev)
    meta, cfg = eng.assembler.meta, world.solver
    for _ in range(3):  # warm-up
        eng.step(q, v, u, z_warm=z)
    torch.cuda.synchronize()
    summary = profile(
        "single_world_float64",
        lambda: [eng.step(q, v, u, z_warm=z) for _ in range(TRACED_STEPS)],
        TRACED_STEPS, trace, 1)
    prob = eng.lcp_problem(q, v, u)

    def seed():
        z0 = lcp._apgd(meta, prob.F, cfg.cfm, prob.b, prob.mu, z)
        return lcp._pgs(dataclasses.replace(meta, iterations=meta.seed_pgs_sweeps),
                        prob.F, cfg.cfm, prob.b, prob.mu, z0)

    parts = {
        "step": lambda: eng.step(q, v, u, z_warm=z),
        "lcp_problem (smooth dynamics, collision, rows, F)": lambda: eng.lcp_problem(q, v, u),
        "boxed_lcp": lambda: lcp.boxed_lcp(meta, prob.F, prob.b, prob.mu, z, cfm=cfg.cfm,
                                           fallback_cfm=cfg.fallback_cfm),
        "boxed_lcp's seed (APGD and its PGS sweeps)": seed,
    }
    summary["launches"] = {name: chip_smoke.count_launches(fn) for name, fn in parts.items()}
    for name, n in summary["launches"].items():
        print(f"  {n:7d} launches  {name}")
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", choices=("half_cheetah", "box3", "box10", "box20")
                    + chip_smoke.REF_WORLDS + ("terrain", "single"),
                    default="half_cheetah")
    ap.add_argument("--trace", help="write Chrome traces to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    from nimblephysics_tpu_torch.convert import policy_from_arrays
    from nimblephysics_tpu_torch.parallel import train_step_batched
    from nimblephysics_tpu_torch.simulation import SolverConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    summaries = []
    if args.world == "single":
        print(json.dumps([profile_single(dev, args.trace)]))
        return 0
    if args.world.startswith("box"):
        boxes = int(args.world[3:])
        cap, worlds = next(((c, w) for b, c, w in chip_smoke.BOX_WIDE_LEGS if b == boxes),
                           (None, None))
        _, q0, eng = chip_smoke.make_box_engine(dev, boxes, cap)
        carry, u = chip_smoke.box_start(eng, q0, np.random.RandomState(chip_smoke.SEED),
                                        dev, worlds)
        carry = chip_smoke.rollout(eng, carry, u, chip_smoke.STEPS)
        torch.cuda.synchronize()
        summaries.append(profile(
            f"{args.world}_forward_default",
            lambda: chip_smoke.rollout(eng, carry, u, TRACED_STEPS),
            TRACED_STEPS, args.trace, worlds))
        print(json.dumps(summaries))
        return 0
    if args.world == "terrain":
        _, q0, v0, eng = chip_smoke.make_terrain_engine(dev)
        carry, u = chip_smoke.rollout_start(eng, q0, v0, np.random.RandomState(chip_smoke.SEED),
                                            dev)
        carry = chip_smoke.rollout(eng, carry, u, chip_smoke.STEPS)
        torch.cuda.synchronize()
        summaries.append(profile(
            "terrain_forward_default", lambda: chip_smoke.rollout(eng, carry, u, TRACED_STEPS),
            TRACED_STEPS, args.trace))
        print(json.dumps(summaries))
        return 0
    if args.world in chip_smoke.REF_WORLDS:
        _, q0, v0, eng = chip_smoke.make_ref_engine(dev, args.world)
        carry, policy = chip_smoke.ref_start(eng, q0, v0, np.random.RandomState(chip_smoke.SEED), dev)
        carry = chip_smoke.policy_rollout(eng, carry, policy, chip_smoke.STEPS)
        torch.cuda.synchronize()
        summaries.append(profile(
            f"{args.world}_forward_default",
            lambda: chip_smoke.policy_rollout(eng, carry, policy, TRACED_STEPS),
            TRACED_STEPS, args.trace))
        print(json.dumps(summaries))
        return 0
    for label, cfg in (("forward_throughput", None), ("forward_default", SolverConfig())):
        _, q0, v0, eng = chip_smoke.make_engine(dev, cfg)
        rng = np.random.RandomState(chip_smoke.SEED)
        carry, u = chip_smoke.rollout_start(eng, q0, v0, rng, dev)
        carry = chip_smoke.rollout(eng, carry, u, chip_smoke.STEPS)
        torch.cuda.synchronize()
        summaries.append(profile(
            label, lambda: chip_smoke.rollout(eng, carry, u, TRACED_STEPS),
            TRACED_STEPS, args.trace))

    _, q0, v0, eng = chip_smoke.make_engine(dev, SolverConfig())
    states, weights = chip_smoke.train_start(
        q0, v0, np.random.RandomState(chip_smoke.SEED + 1), dev)
    train = train_step_batched(eng, policy_from_arrays(*weights, device=dev),
                               TRACED_STEPS, chip_smoke.LEARNING_RATE)
    train(states)
    torch.cuda.synchronize()
    summaries.append(profile("train_default", lambda: train(states),
                             TRACED_STEPS, args.trace))
    print(json.dumps(summaries))
    return 0


if __name__ == "__main__":
    sys.exit(main())
