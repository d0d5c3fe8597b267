#!/usr/bin/env python3
"""Writes the start state of the cell nares-150: the recipe run from its
published start until the pack presses on the coastline.

    python3 benchmark/configs/nares_start.py [--out PATH]

Builds the cell's configuration at step 0 from the published field (the
cell's ``layout_seed``, ordered by that seed) on the CUDA device, then
runs ``Simulation.run`` in chunks of ``CHUNK`` steps and reads the
program's count of floe-vs-coast force pairs (``contact.coast_pairs``) for
each.  It stops at the first chunk end S whose chunk averaged at least
``SHARE`` x the live free floes of coastline pairs a step; if none does by
``LIMIT`` steps, it takes the chunk end with the highest average.  It
writes S and every live free floe's world-frame polygon and fields
(``nares.py:write_start``; by default ``configs/nares-start.npz``), and
prints one line a chunk and a last JSON line.  The cell's ``start_step``
must then be S.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(BENCH / "_build" / "torch_extensions"))
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

CELL = "nares-150"
CHUNK = 1500
LIMIT = 30000
SHARE = 0.1


def live_free_floes(sim, names):
    """(world-frame polygons, {field: rows} of the fields ``names``) of
    the live free floes, on the host: polygons placed in float64 by the
    state's own transform, fields in the state's dtypes."""
    import torch

    st = sim.state
    alive = st.alive.clone()
    alive[:sim.cfg.n_boundary] = False
    rows = torch.nonzero(alive).flatten()
    d = torch.float64
    world = st.replace(verts_body=st.verts_body.to(d), x=st.x.to(d),
                       y=st.y.to(d), alpha=st.alpha.to(d)).verts_world()
    world = world[rows].cpu().numpy()
    nv = st.nv[rows].cpu().numpy()
    polys = [world[k, :nv[k]] for k in range(len(nv))]
    fields = {f: getattr(st, f)[rows].cpu().numpy() for f in names}
    return polys, fields


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(HERE / "nares-start.npz"))
    args = ap.parse_args(argv)

    import torch

    from benchlib.catalog import Catalog

    cat = Catalog(BENCH)
    cell = cat.cell(CELL)
    conf = cat.config(cell["config"])
    builder = cat.builder(conf)
    traffic = {k: v for k, v in cell["traffic"].items()
               if k not in ("start_state", "start_step")}
    seed = int(traffic["layout_seed"])
    t0 = time.perf_counter()
    sim, _ = builder.build(conf["recipe"], traffic, seed,
                           torch.device("cuda"))
    nb = sim.cfg.n_boundary
    best = None
    while sim.step_idx < LIMIT:
        c0 = sim.phase_times.counts.get("contact.coast_pairs", 0)
        t1 = time.perf_counter()
        sim.run(CHUNK)
        pairs = (sim.phase_times.counts["contact.coast_pairs"] - c0) / CHUNK
        live = int(sim.state.alive[nb:].sum())
        share = pairs / max(live, 1)
        print(f"[start] step {sim.step_idx}: {pairs:.3f} coast pairs a step,"
              f" {live} live free floes (share {share:.4f}), "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        if best is None or share > best[0]:
            best = (share, sim.step_idx, pairs, live) + live_free_floes(
                sim, builder.START_FIELDS)
        if share >= SHARE:
            break
    share, step, pairs, live, polys, fields = best
    builder.write_start(args.out, step, polys, fields,
                        coast_pairs_per_step=pairs, live_free_floes=live,
                        layout_seed=seed, modulus=sim.modulus,
                        met=share >= SHARE)
    print(json.dumps({
        "S": step, "coast_pairs_per_step": pairs, "live_free_floes": live,
        "share": share, "met": share >= SHARE,
        "max_neighbors": sim.cfg.capacity.max_neighbors,
        "bytes": os.path.getsize(args.out),
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
