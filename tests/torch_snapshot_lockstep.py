"""Resume a campaign snapshot in both packages on the CPU in float64 and run
them side by side: where a card campaign misses its gate, this says where
the packages part.

    JAX_PLATFORMS=cpu python tests/torch_snapshot_lockstep.py CASE SNAPSHOT \\
        STEPS [--m0=M0.npy] [--resync-from=STEP]

CASE names the campaign case whose builder gives the config and forcing
(``out_of_box``, ``uniaxial`` with the campaign's walls, ``nares``,
``nares_export``, ``winter``; float64 in both, no outputs).  Both
packages load SNAPSHOT (a port snapshot, float32 on the card: both cast
it) and run STEPS steps in chunks of ten.  Each chunk prints both ledgers
(floes + dissolved + exported, over M0 if given, else over the snapshot's
own total), the live counts (the boundary floes apart), and each
lifecycle boundary's edits in both:
kills, births (their count, total area and mean thickness), reshapes.
With ``--resync-from`` the port restarts every chunk from that step on
from JAX's state, config and lifecycle run state (a chunk-by-chunk
lockstep, as test_torch_sim.py's).  A winter chunk after the packing at
step 5,500 holds ~450 floes; the port's CPU step then needs ~25 GB.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)
import subzero_tpu.processes.lifecycle as jlc  # noqa: E402
import subzero_tpu.validation as jval  # noqa: E402
from subzero_tpu.sim import Simulation as JSimulation  # noqa: E402
from subzero_tpu.sim import out_of_box_sim as j_out_of_box  # noqa: E402

import subzero_tpu_torch.processes.lifecycle as tlc  # noqa: E402
import subzero_tpu_torch.validation as tval  # noqa: E402
from subzero_tpu_torch import campaign  # noqa: E402
from subzero_tpu_torch.sim import (  # noqa: E402
    out_of_box_sim as t_out_of_box,
)
from subzero_tpu_torch.native import poly_area  # noqa: E402
from test_torch_sim import resync  # noqa: E402

CPU64 = dict(device="cpu", dtype="float64")
BUILDERS = {
    "out_of_box": (lambda: j_out_of_box(seed=0, n_floes=10),
                   lambda: t_out_of_box(seed=0, n_floes=10, **CPU64)),
    "uniaxial": (lambda: jval.uniaxial_sim(n_floes=200, seed=0),
                 lambda: tval.uniaxial_sim(n_floes=200, seed=0, **CPU64)),
    "nares": (lambda: jval.nares_sim(n_floes=150, seed=0),
              lambda: tval.nares_sim(n_floes=150, seed=0, **CPU64)),
    "nares_export": (
        lambda: jval.nares_sim(n_floes=150, seed=0, full_basin=True),
        lambda: tval.nares_sim(n_floes=150, seed=0, full_basin=True,
                               **CPU64)),
    "winter": (lambda: jval.winter_sim(n_floes=100, seed=0),
               lambda: tval.winter_sim(n_floes=100, seed=0, **CPU64)),
}


def campaign_walls(steps=campaign.DEFAULT_STEPS["uniaxial"]):
    """uniaxial's walls as the campaign closes them over ``steps``."""
    rate = max(15.0, (1e5 - 8.5e4) / max(steps // 30, 1))
    return lambda s: (1e5, max(1e5 - rate * (s // 30), 8.5e4))


def record_edits(logs):
    for mod, key in ((jlc, "jax"), (tlc, "port")):
        orig = mod.apply_edits

        def rec(state, edit, cfg, seed=0, view=None, _o=orig, _k=key):
            logs[_k].append(edit)
            return _o(state, edit, cfg, seed=seed, view=view)

        mod.apply_edits = rec


def describe(edit) -> str:
    born = edit.new_floes
    area = sum(abs(poly_area(np.asarray(f.poly, np.float64))) for f in born)
    h = np.mean([float(f.h) for f in born]) if born else 0.0
    return (f"kills {len(edit.kills)} dissolve {len(edit.dissolve_kills)} "
            f"births {len(born)} (area {area:.6e} m^2, mean h {h:.6f} m) "
            f"reshapes {len(edit.reshapes)}")


def main(argv) -> int:
    case, snap, steps = argv[0], Path(argv[1]), int(argv[2])
    opts = dict(a[2:].split("=", 1) for a in argv[3:])
    torch.set_num_threads(4)
    j_build, p_build = BUILDERS[case]
    jbase, port = j_build(), p_build()
    cfg = jbase.cfg.replace(numerics=dataclasses.replace(
        jbase.cfg.numerics, dtype="float64"))
    js = JSimulation.load(snap, cfg, jbase.forcing)
    ps = campaign.Simulation.load(snap, port.cfg, port.forcing, device="cpu")
    walls = campaign_walls() if case == "uniaxial" else None
    for sim in (js, ps):
        sim.wall_fn = walls
        sim.lifecycle.shadow_ledger = True

    def total(sim):
        return (sim.total_mass() + float(np.sum(sim.dissolved))
                + sim.lifecycle.exported_mass)

    m0 = float(np.load(opts["m0"])) if "m0" in opts else total(ps)
    resync_from = int(opts.get("resync-from", 10 ** 12))
    logs = {"jax": [], "port": []}
    record_edits(logs)
    t0 = time.time()
    end = js.step_idx + steps
    while js.step_idx < end:
        if js.step_idx >= resync_from:
            resync(ps, js)
            ps.step_idx = js.step_idx
        nj, np_ = len(logs["jax"]), len(logs["port"])
        js.run(10)
        ps.run(10)
        ja, pa = np.asarray(js.state.alive), ps.state.alive.numpy()
        nb = ps.cfg.n_boundary
        print(f"step {js.step_idx}: ledger JAX {total(js) / m0:.8f} port "
              f"{total(ps) / m0:.8f}; live JAX {int(ja.sum())} port "
              f"{int(pa.sum())} (boundary floes {int(ja[:nb].sum())} and "
              f"{int(pa[:nb].sum())} of {nb}); {time.time() - t0:.0f} s",
              flush=True)
        for ej, ep in zip(logs["jax"][nj:], logs["port"][np_:]):
            print(f"  boundary: JAX {describe(ej)}", flush=True)
            print(f"            port {describe(ep)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
