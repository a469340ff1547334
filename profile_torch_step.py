#!/usr/bin/env python3
"""Where a step of nimblephysics_tpu_torch's main path spends its time on
one NVIDIA GPU.

    python3 profile_torch_step.py [--world half_cheetah|box3|jump_worm|catapult]
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
untraced steps, TRACED_STEPS traced. For --world jump_worm or catapult,
the reference suite's world under the default SolverConfig driven by its
policy (chip_smoke's make_ref_engine, ref_start and policy_rollout),
after chip_smoke.STEPS untraced steps.
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


def profile(label, fn, steps, trace=None):
    """Trace fn() (`steps` env-steps per world), print and return the
    per-step summary."""
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
        "batch": chip_smoke.BATCH,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", choices=("half_cheetah", "box3") + chip_smoke.REF_WORLDS,
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
    if args.world == "box3":
        _, q0, eng = chip_smoke.make_box_engine(dev, 3)
        carry, u = chip_smoke.box_start(eng, q0, np.random.RandomState(chip_smoke.SEED), dev)
        carry = chip_smoke.rollout(eng, carry, u, chip_smoke.STEPS)
        torch.cuda.synchronize()
        summaries.append(profile(
            "box3_forward_default", lambda: chip_smoke.rollout(eng, carry, u, TRACED_STEPS),
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
