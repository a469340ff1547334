#!/usr/bin/env python3
"""Where a step of nimblephysics_tpu_torch's forward rollout spends its
time on one NVIDIA GPU.

    python3 profile_torch_step.py [--trace PATH]

Builds the main path of chip_smoke.py with its own functions (4096
half-cheetahs, float32, SolverConfig.throughput(), warm-started
impulses), settles it on the ground with chip_smoke.STEPS untraced
steps, then traces TRACED_STEPS steps with torch.profiler. Prints, per
step: host milliseconds, CUDA kernel launches, summed kernel time and
the device's busy share of the wall time, and the kernels that take the
most device time; with --trace, writes a Chrome trace there. Exits
non-zero where there is no CUDA device.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write a Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _, q0, v0, eng = chip_smoke.make_engine(dev)
    rng = np.random.RandomState(chip_smoke.SEED)
    carry, u = chip_smoke.rollout_start(eng, q0, v0, rng, dev)
    carry = chip_smoke.rollout(eng, carry, u, chip_smoke.STEPS)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        chip_smoke.rollout(eng, carry, u, TRACED_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = TRACED_STEPS
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
        and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                       "cuLaunchKernelEx")
    )
    kernel_us = sum(v[1] for v in by_name.values())
    summary = {
        "gpu": torch.cuda.get_device_name(0),
        "batch": chip_smoke.BATCH,
        "steps_traced": n,
        "host_ms_per_step": wall_us / n / 1e3,
        "kernel_launches_per_step": launches / n,
        "device_events_per_step": len(kernels) / n,
        "kernel_ms_per_step": kernel_us / n / 1e3,
        "device_busy_share": busy_us / wall_us,
    }
    print(f"per step: host {summary['host_ms_per_step']:.3f} ms, "
          f"{summary['kernel_launches_per_step']:.0f} kernel launches, "
          f"{summary['device_events_per_step']:.0f} device events, device "
          f"kernels {summary['kernel_ms_per_step']:.3f} ms, busy share "
          f"{summary['device_busy_share']:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (count, us) in top:
        print(f"  {us / n:9.1f} us/step {count / n:6.0f}x/step  {name[:90]}")
    if args.trace:
        out = Path(args.trace)
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
