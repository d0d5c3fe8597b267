#!/usr/bin/env python3
"""The benchmark of subzero_tpu_torch (the PyTorch and CUDA port).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA device it is started on:
builds the cell's inputs from the seed, warms up, replays fixed segments of
``Simulation.run`` for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones).  Exits non-zero without a result where there is no CUDA
device, where the program is missing, or where JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# the program's kernels build into its own _build/ inside the checkout;
# any other compiler cache stays at a fixed path inside it too
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(HERE / "_build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / "_build" / "triton"))
os.environ["USE_FLAX"] = "0"
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "4")
sys.path[:0] = [str(HERE), str(REPO)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchlib.catalog import Catalog
    from benchlib.runner import forbidden_modules, run

    cat = Catalog(HERE)
    chips = int(cat.cell(args.workload)["chips"])
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is false", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.set_num_threads(4)

    def log(msg):
        print(msg, flush=True)

    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 device="cuda", catalog=cat, t_start=T_START, log=log)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
