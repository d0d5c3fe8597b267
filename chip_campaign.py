#!/usr/bin/env python3
"""The validation campaign (``subzero_tpu_torch.campaign``) on one GPU, its
cases side by side:

    python3 chip_campaign.py [case ...] [--budget=SECONDS] [--resume]
                             [--copy=DIR] [--keep=STEP,...] [--steps=N]
                             [--device=...] [--dtype=...]
                             [--contact-impl=pallas|integral|xla]

Each case runs in a process of its own on the same card (the eager step
and the host lifecycle leave the card idle most of the time, so the cases
share it); ``nares`` is followed by ``nares_leg`` in the same slot.  At
``--budget`` seconds (default 2,400) the script writes the Nares STOP file,
so the export leg ends at its next leg boundary with its summary; a case
still running 300 s later is killed and resumes from its latest snapshot
with ``--resume``.  ``--resume``, ``--steps``, ``--device`` and ``--dtype``
are passed on to the cases.  ``--contact-impl`` runs every case under that
``NumericsConfig.contact_impl`` (through ``campaign.main``'s keyword: the
campaign's command line has no such option).  The kernels are built once
before the cases start.

Each case's output goes to its log, ``<copy>/<case>.log`` (default
``validation/out_torch/summary``); its mass series, ledger baseline,
distributions and latest snapshot (and those of the ``--keep`` steps) are
copied to ``<copy>/<case>/``, and ``validation/out_torch/RESULTS.md`` to
``<copy>/RESULTS.md``.  The card's
name and power limit are printed first; the exit code is non-zero if any
case failed or was killed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GRACE = 300.0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_campaign: CUDA is not available", file=sys.stderr)
        return 2
    from subzero_tpu_torch import campaign
    from subzero_tpu_torch.kernels import clip, clip_pallas
    from subzero_tpu_torch.native import poly_area

    budget, copy, flags = 2400.0, campaign.OUT / "summary", []
    keep, impl = set(), None
    for a in argv:
        if a.startswith("--contact-impl="):
            impl = a.split("=", 1)[1]
        elif a.startswith("--budget="):
            budget = float(a.split("=", 1)[1])
        elif a.startswith("--copy="):
            copy = Path(a.split("=", 1)[1])
        elif a.startswith("--keep="):
            keep = {int(k) for k in a.split("=", 1)[1].split(",")}
        elif a == "--resume" or a.startswith(("--steps=", "--device=",
                                               "--dtype=")):
            flags.append(a)
        elif a.startswith("--"):
            raise SystemExit(f"unknown option {a}")
    names = [a for a in argv if not a.startswith("--")] or list(
        campaign.CASES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"[campaign] {smi.stdout.strip().splitlines()[0]}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    clip.build()                # once, before the cases start
    clip_pallas.build()
    poly_area([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    copy.mkdir(parents=True, exist_ok=True)
    stop = campaign.OUT / "nares" / "STOP"
    stop.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "subzero_tpu_torch.campaign"]
    if impl:
        cmd = [sys.executable, "-c",
               "import sys; from subzero_tpu_torch.campaign import main; "
               f"sys.exit(main(sys.argv[1:], contact_impl={impl!r}))"]
    slots = {}
    for name in names:
        chain = [[*cmd, name, *flags]]
        if name == "nares":
            chain.append([*cmd, "nares_leg",
                          *(f for f in flags if f != "--resume")])
        log = open(copy / f"{name}.log", "w")
        slots[name] = [chain, subprocess.Popen(chain.pop(0), cwd=ROOT,
                                               env=env, stdout=log,
                                               stderr=subprocess.STDOUT),
                       log, []]
    t0 = time.time()
    while any(s[1] is not None for s in slots.values()):
        time.sleep(5)
        now = time.time() - t0
        if now > budget and not stop.exists():
            stop.parent.mkdir(parents=True, exist_ok=True)
            stop.touch()
            print(f"[campaign] budget {budget:.0f} s spent: STOP written",
                  flush=True)
        for name, s in slots.items():
            chain, proc, log, rcs = s
            if proc is None:
                continue
            if now > budget + GRACE and proc.poll() is None:
                proc.kill()
                print(f"[campaign] {name} killed at {now:.0f} s", flush=True)
            rc = proc.poll()
            if rc is None:
                continue
            rcs.append(rc)
            print(f"[campaign] {name}: step {len(rcs)} exited {rc} at "
                  f"{now:.0f} s", flush=True)
            s[1] = (subprocess.Popen(chain.pop(0), cwd=ROOT, env=env,
                                     stdout=log, stderr=subprocess.STDOUT)
                    if chain and rc == 0 else None)
    stop.unlink(missing_ok=True)
    for name in list(names) + (["nares_leg"] if "nares" in names else []):
        src = campaign.OUT / name
        if not src.exists():
            continue
        dst = copy / name
        shutil.rmtree(dst, ignore_errors=True)
        dst.mkdir(parents=True)
        for f in ("mass_series.npy", "m0.npy", "distributions.npz"):
            if (src / f).exists():
                shutil.copy2(src / f, dst / f)
        snaps = [m.parent for m in sorted(src.glob("snap*/meta.json"))]
        for snap in snaps[-1:] + [s for s in snaps[:-1]
                                  if int(s.name[4:]) in keep]:
            shutil.copytree(snap, dst / snap.name)
    results = campaign.OUT / "RESULTS.md"
    if results.exists():
        shutil.copy2(results, copy / "RESULTS.md")
        print(results.read_text(), flush=True)
    bad = {n: s[3] for n, s in slots.items() if any(s[3]) or not s[3]}
    print(f"[campaign] {time.time() - t0:.0f} s; exit codes "
          + ", ".join(f"{n} {s[3]}" for n, s in slots.items()), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
