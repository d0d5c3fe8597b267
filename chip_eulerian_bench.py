#!/usr/bin/env python3
"""Time the port's Eulerian call against an earlier version of
``subzero_tpu_torch/diagnostics.py``, on one NVIDIA GPU:

    python3 chip_eulerian_bench.py --old OLD_diagnostics.py [--reps N]

On ``chip_smoke.py`` phase 6's state (the winter pack scaled to ~10,000
Voronoi floes, 20,000 slots, float32, AVERAGE on a 40x40 grid, after its
10 warm-up steps from step 60) it times, in one process, the two calls the
driver makes: the per-step AVERAGE accumulation (``exact_boundary=False``
with the chunk's cell window) and the output call (``sim.eulerian()``),
each through the earlier module (e.g. ``git show
15192ae:subzero_tpu_torch/diagnostics.py``, the version that clipped every
window pair with the CUDA clip kernel) and through this one, in turns old,
new, new, old: host clock around ``--reps`` calls ending in
``torch.cuda.synchronize()``.  It prints the card's name and power limit,
one line per measurement, the CUDA clip kernel's launches per call of each
version, and the largest difference of the floe area per cell between the
two (the segment-midpoint clip's collinear-edge loss, ROADMAP §C).
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time

import chip_smoke as smoke


def load_old(path):
    """The earlier diagnostics module, loaded inside the package so its
    relative imports resolve."""
    spec = importlib.util.spec_from_file_location(
        "subzero_tpu_torch._diagnostics_old", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_eulerian_bench: CUDA is not available", file=sys.stderr)
        return 2
    from subzero_tpu_torch import diagnostics as new
    from subzero_tpu_torch.kernels import clip as kclip

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smoke.log(f"[device] {smi.stdout.strip().splitlines()[0]}")
    old = load_old(args.old)
    sim, _ = smoke.big_winter()
    sim.run(smoke.BIG_WARMUP)
    st, cfg = sim.state, sim.cfg
    nx, ny = sim.nx_coarse, sim.ny_coarse
    win = new.cell_window(st, cfg, nx, ny)
    smoke.log(f"[eulerian] state at step {sim.step_idx}: {st.n} slots, "
              f"{int(st.alive.sum())} live floes, vertex rung {st.v_cap}, "
              f"{nx}x{ny} cells, window {win}")
    calls = {
        "AVERAGE per-step call": lambda m: m.eulerian_data(
            st, cfg, nx, ny, window=win, exact_boundary=False),
        "output call": lambda m: m.eulerian_data(st, cfg, nx, ny),
    }
    for label, call in calls.items():
        launches = {}
        for name, mod in (("old", old), ("new", new)):
            kclip.clip_stats_cuda.launches = 0
            call(mod)
            torch.cuda.synchronize()
            launches[name] = kclip.clip_stats_cuda.launches
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            mod = old if name == "old" else new
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                call(mod)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / args.reps * 1e3)
        d_area = float((call(old).area - call(new).area).abs().max())
        smoke.log(f"[eulerian] {label}: old {times['old'][0]:.3f} / "
                  f"{times['old'][1]:.3f} ms, new {times['new'][0]:.3f} / "
                  f"{times['new'][1]:.3f} ms a call ({args.reps} calls "
                  f"each, old-new-new-old); clip kernel launches a call: "
                  f"old {launches['old']}, new {launches['new']}; max |d "
                  f"area| {d_area:.6e} m^2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
