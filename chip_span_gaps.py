#!/usr/bin/env python3
"""Where the card idles inside the port's own spans, on one NVIDIA GPU.

    python3 chip_span_gaps.py --cell uniaxial-200 --seed 11 \
        [--cell uniaxial-10k --seed 12 ...] [--out FILE.json]

For each benchmark cell (``benchmark/workloads/<cell>.json``): the
benchmark's set-up (inputs and state from the seed, warm steps, one
throwaway segment), then one more segment of ``Simulation.run`` under
``torch.profiler`` (CPU and CUDA activity).  The card's idle gaps in that
segment (outside the union of its operations' intervals) are filed under
the innermost ``subzero.*`` range of the program's spans
(``subzero_tpu_torch/trace.py``) that holds each gap's midpoint, "driver"
where none does.  Prints, per cell, the segment's wall and busy seconds,
the idle seconds by span, and the program's host seconds by span
(``Simulation.phase_times`` of the profiled segment).
The last line names the card and its power limit.  Until the benchmark's
own profiled segment files gaps by ``subzero.*`` range (ROADMAP D0), this
script is where that split comes from.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path[:0] = [str(REPO / "benchmark"), str(REPO)]


def log(msg):
    print(msg, flush=True)


def cell_gaps(cell, seed, device="cuda", catalog=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchlib.replay import share_copy
    from benchlib.runner import Run
    from benchlib.trace import busy_us, gaps, gaps_by_phase

    r = Run(cell, seed, 0.0, False, device=device, catalog=catalog,
            log=lambda m: None)
    try:
        r.setup()
        sim = share_copy(r.start)
        sim.__dict__.pop("_phase_times", None)
        sim.lifecycle.__dict__.pop("pass_times", None)
        sync = torch.cuda.synchronize if device == "cuda" else (
            lambda: None)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch._C._profiler._RecordFunctionFast("gaps.segment"):
                sim.run(r.n_seg)
                sync()
    finally:
        r.hooks.uninstall()
    dev, spans, win = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(("bench.", "subzero.", "gaps.")):
                dev.append((e.start_ns(), e.end_ns()))
        elif name == "gaps.segment":
            win = (e.start_ns(), e.end_ns())
        elif name.startswith("subzero."):
            spans.append((name[len("subzero."):], e.start_ns(), e.end_ns()))
    dev = [(max(a, win[0]), min(b, win[1])) for a, b in dev
           if b > win[0] and a < win[1]]
    idle = gaps(dev, win[0], win[1])
    by_span = gaps_by_phase(idle, spans, top=40)
    pt = sim.phase_times
    return dict(
        cell=cell, seed=seed, steps=r.n_seg, live=r.live0,
        window_s=(win[1] - win[0]) * 1e-9, busy_s=busy_us(dev) * 1e-9,
        idle_s=sum(b - a for a, b in idle) * 1e-9,
        idle_by_span=[(n, s * 1e-9) for n, s in by_span],
        host_s={k: pt[k] for k in sorted(pt)},
        entries=dict(pt.entries), counts=dict(pt.counts),
        passes=dict(sim.lifecycle.pass_times),
        pass_counts=dict(sim.lifecycle.pass_times.counts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--seed", action="append", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if len(args.cell) != len(args.seed):
        ap.error("give one --seed per --cell")
    import torch

    if not torch.cuda.is_available():
        print("chip_span_gaps: CUDA is not available", file=sys.stderr)
        return 2
    log(f"[gaps] torch {torch.__version__}, CUDA {torch.version.cuda}")
    results = []
    for cell, seed in zip(args.cell, args.seed):
        res = cell_gaps(cell, seed)
        results.append(res)
        log(f"[gaps] {cell} seed {seed}: {res['steps']} steps, "
            f"{res['live']} live floes; window {res['window_s']:.6f} s, "
            f"busy {res['busy_s']:.6f} s, idle {res['idle_s']:.6f} s")
        for name, s in res["idle_by_span"]:
            log(f"[gaps] {cell} idle in {name}: {s:.6f} s")
        for k, v in res["host_s"].items():
            log(f"[spans] {cell} {k}: {v:.6f} s, "
                f"{res['entries'].get(k, 0)} entries")
        log(f"[spans] {cell} counts {res['counts']}; passes "
            f"{res['passes']}; pass counts {res['pass_counts']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "unknown"
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card,
                                                  cells=results)))
    log(f"[device] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
