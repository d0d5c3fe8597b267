#!/usr/bin/env python3
"""Where the port's physics step spends its time on one NVIDIA GPU: device
busy and idle share per step, by ``torch.profiler``.

    python3 chip_step_trace.py

For each of chip_smoke.py's phase-4 runs (``main_path_runs``: 10,240
floes, float32; the quad lattice in aggregate mode and under the default
ContactConfig, periodic and walled; the concave-star lattice per-region,
its pool sized by a probe step, and in aggregate mode; the quad lattice
with the cell-list broad phase), three warm-up steps, ten steps timed by
the host clock, then ten steps under the profiler.  Prints per run the
step time (host clock, without and with the profiler), the device busy
time per step (the union of the kernels' intervals on the card, from the
profiled steps), the idle share (1 - busy / unprofiled step time), the
kernels and the host-side PyTorch operator calls per step, and the five
kernels that take the most device time.  The last line names the card and its power
limit.
"""

from __future__ import annotations

import subprocess
import sys
import time

import chip_smoke as cs

STEPS = 10


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace(label, state, forcing, cfg):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from subzero_tpu_torch.dynamics.step import make_step_fn

    step = make_step_fn(cfg, forcing, cs.MODULUS)
    s = state
    for i in range(3):
        s, _ = step(s, i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 3 + STEPS):
        s, _ = step(s, i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3 + STEPS, 3 + 2 * STEPS):
            s, _ = step(s, i)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / STEPS * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.name.startswith("aten::") and e.cpu_parent is None]
    if not kernels:
        raise AssertionError(f"{label}: the profiler saw no device work")
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels]) / STEPS / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / STEPS / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    cs.log(f"[trace] {label}: step {wall:.3f} ms (host clock; "
           f"{wall_prof:.3f} ms under the profiler), device busy "
           f"{busy:.3f} ms, idle share {1 - busy / wall:.1%}; "
           f"{len(kernels) / STEPS:.0f} kernels and "
           f"{len(ops) / STEPS:.0f} top-level aten calls per step")
    for name, ms in top:
        cs.log(f"[trace]     {ms:.3f} ms/step  {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_step_trace: CUDA is not available", file=sys.stderr)
        return 2
    cs.log(f"[device] {torch.cuda.get_device_name(0)}, torch "
           f"{torch.__version__}")
    runs, _ = cs.main_path_runs()
    for label, state, forcing, cfg in runs:
        trace(label, state, forcing, cfg)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
