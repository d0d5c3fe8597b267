#!/usr/bin/env python3
"""Readings for the limits of ``correct``: for each seed, one cell's
set-up and one timed segment on the card, then the numbers that decide
``correct`` for the program and for the control (the reference in the
program's place, in bfloat16: ``benchlib/check.py``), in one process.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds K] [--out readings.jsonl]

Prints one JSON line per seed; the control is read on the first K seeds
(all by default).  The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["USE_FLAX"] = "0"
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "4")
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=None)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchlib.catalog import Catalog
    from benchlib.runner import Run

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out = open(args.out, "a") if args.out else None
    seeds = [int(s) for s in args.seeds.split(",")]
    n_ctl = len(seeds) if args.control_seeds is None else args.control_seeds
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        r = Run(args.workload, seed, 0.0, False, device="cuda",
                catalog=Catalog(HERE), log=lambda m: None)
        try:
            r.setup()
            r.window()
            r.hooks.recorder.active = False
            prog = {n: v for n, (v, _) in r.check().items()}
            ctl = r.control() if k < n_ctl else None
        finally:
            r.hooks.uninstall()
        line = json.dumps({"cell": args.workload, "seed": seed,
                           "program": prog, "control": ctl,
                           "segment_s": r.seg_times,
                           "setup_s": r.setup_s,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
