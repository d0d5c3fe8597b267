#!/usr/bin/env python3
"""The port's spatial decomposition (``subzero_tpu_torch.parallel``) across
the GPUs of one host, one process per GPU on an NCCL group:

    python3 chip_spatial4.py            # every visible GPU (2 or more)

The script launches its ranks as subprocesses of itself (the environment
``torchrun`` would set: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR=127.0.0.1``, a free ``MASTER_PORT``), waits for them with a
timeout and kills them on an overrun.  Each rank, on GPU ``LOCAL_RANK``:

(a) joins the NCCL group through ``parallel.distributed.initialize()``
    and a gloo group over the same ranks; meshes: ("shards",) over the S
    ranks, (2, S/2) ("sx", "sy") tiles, and a CPU ("shards",) mesh on the
    gloo group.
(b) float64, 20 steps: the slab and tile steps against the single-device
    ``make_step_fn`` on the rank's own card (chip_smoke phase 3's periodic
    and walled 256-quad lattices, per-region contacts, ``overlap_halo`` on
    and off): the gathered live rows within rtol 1e-5, atol 1e-8, equal
    collision counts, no overflow (``chip_smoke.spatial_lockstep``).
(c) ``__graft_entry__.dryrun_multichip``'s pack in float64 (1,024 quads,
    doubly periodic, a column on every stripe edge, 5 steps) on the slab
    mesh against the single-device step: no floe lost, every floe owned by
    its stripe, migrations > 0, no overflow flag on any rank.
(d) float32, chip_smoke phase 4's aggregate periodic and default periodic
    10,240-quad lattices: the single-device step on each rank's card, then
    the slab step over the S cards (1.25x the slots, as a stripe holds more
    than 1/S of the lattice; ``max_ghosts`` 256), one warm-up and 30 timed
    steps: floe-steps/s of both per live floe, the slab step's per-phase
    CUDA-event times on rank 0, peak memory (largest rank), clip launches
    per rank (two a periodic step); the live floes over the mesh equal to
    the single-device step's, no overflow flag on any rank (each rank's
    neighbour table, ghost buffers and migration: ``step.overflow``).
(e) ``uniaxial_sim()`` (200 floes, the walls closing 1.5 km every 30
    steps, as the validation campaign closes them for a 300-step run) with
    ``mesh=`` on the NCCL slab mesh against the same on the gloo CPU mesh,
    float64, chunk by chunk (``chip_smoke.sim_lockstep``), through its first
    lifecycle boundary: 200 steps, its ``n_fracture`` (``--sim-steps``
    sets another depth), where floes fracture; it fails if no lifecycle
    pass ran.

``--phases`` picks which of (b)-(e) run (default all).

Rank 0's output is printed; the line before the last gives the first
card's name and power limit (``nvidia-smi``), the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": S}}``.
Any failure makes the script exit non-zero without that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

TIMEOUT = 1500.0          # seconds for the whole group


def launch(args, world: int) -> int:
    """Start one rank per device (``chip_smoke.RankGroup``), print rank 0's
    output, fail on any rank's failure or on the timeout (every rank
    killed)."""
    if world < 2 or world % 2:
        print(f"chip_spatial4: needs an even number >= 2 of devices, has "
              f"{world}", file=sys.stderr)
        return 2
    group = cs.RankGroup(
        [sys.executable, __file__, "--rank-main", "--floes", str(args.floes),
         "--steps", str(args.steps), "--phases", args.phases]
        + (["--sim-steps", str(args.sim_steps)] if args.sim_steps else []),
        world, TIMEOUT)
    try:
        group.wait()
    except RuntimeError as e:
        print(group.logs[0], end="")
        print(f"chip_spatial4: {e}", file=sys.stderr)
        return 1
    print(group.logs[0], end="")
    return 0


def run_rank(args) -> None:
    import torch
    import torch.distributed as dist

    from subzero_tpu_torch.forcing import uniform_forcing
    from subzero_tpu_torch.parallel import gather_state
    from subzero_tpu_torch.parallel.distributed import (
        Mesh, initialize, spatial_mesh,
    )
    from subzero_tpu_torch.state import state_from_polygons

    dev = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    t0 = time.perf_counter()
    initialize(device=dev)
    world = dist.get_world_size()
    gloo = dist.new_group(backend="gloo")
    meshes = {"slabs": spatial_mesh(device=dev),
              "tiles": Mesh((2, world // 2), ("sx", "sy"), device=dev),
              "gloo": Mesh((world,), ("shards",), device="cpu", group=gloo)}
    cs.log(f"[spatial4] (a) {world} ranks: {dist.get_backend()} and "
           f"{dist.get_backend(gloo)} groups in "
           f"{time.perf_counter() - t0:.1f} s; "
           + "; ".join(repr(m) for m in meshes.values()))

    try:
        # (b) float64 lockstep against the single-device step
        t_b = time.perf_counter()
        for label, seed, periodic in (("256 quads periodic", 3, True),
                                      ("256 quads walled", 1, False)
                                      ) if "b" in args.phases else ():
            polys, vel, lx = cs.lattice(256, seed=seed)
            for ov in (True, False):
                cfg = cs.lattice_config(256, lx, periodic=periodic,
                                        dtype="float64", n_mc=64, window=16,
                                        contact={},
                                        numerics=dict(overlap_halo=ov))
                for name in ("slabs", "tiles"):
                    cs.spatial_lockstep(f"{label}, overlap_halo={ov}",
                                        polys, vel, lx, cfg, meshes[name],
                                        steps=args.steps)

        # (c) the dryrun pack on the slab mesh
        t_c = time.perf_counter()
        if "c" in args.phases:
            dryrun_pack(meshes["slabs"])

        # (d) float32 timing: single-device step and slab step
        t_d = time.perf_counter()
        polys, vel, lx = cs.lattice(args.floes)
        forcing = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1, device=dev)
        # the slabs need headroom: a stripe of the lattice holds more than
        # 1/S of the floes (26 of its 102 columns at S=4)
        cap = -(-int(args.floes * 1.25) // (8 * world)) * 8 * world
        for label, contact in (("aggregate periodic", None),
                               ("(a) default periodic", {})
                               ) if "d" in args.phases else ():
            cfg = cs.lattice_config(args.floes, lx, periodic=True,
                                    dtype="float32", contact=contact,
                                    capacity=dict(max_ghosts=256))
            quads = state_from_polygons(polys, 0.5, cfg, velocities=vel,
                                        device=dev)
            _, rate1, _, s1, _, _ = cs.run_main_path(quads, cfg, forcing)
            alive1 = int(s1.alive.sum())
            del s1
            cfg = cfg.replace(capacity=dataclasses.replace(
                cfg.capacity, max_floes=cap))
            quads = state_from_polygons(polys, 0.5, cfg, velocities=vel,
                                        device=dev)
            torch.cuda.reset_peak_memory_stats()
            launches, rate, phase, s, aux, flag, n_alive = \
                cs.run_spatial_main(quads, cfg, forcing, meshes["slabs"])
            rate *= args.floes / cap     # per floe, not per slot
            peak = meshes["slabs"].pmax(torch.tensor(
                [torch.cuda.max_memory_allocated()],
                device=meshes["slabs"].device)).item() / 2 ** 30
            g = gather_state(s, meshes["slabs"])
            want = 2 * (cs.STEPS + 1)
            cs.log(f"[spatial4] (d) {label}, slab step over {world} "
                   f"devices ({cap} slots): {rate:.1f} floe-steps/s over "
                   f"{cs.STEPS} steps "
                   f"(single-device step on one: {rate1:.1f}); rank 0 per "
                   f"step (CUDA events, ms): "
                   + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
                   + f"; peak memory {peak:.2f} GiB (largest rank); clip "
                   f"launches {launches} on rank 0 (expected {want})")
            cs.log(f"[spatial4] (d) {label}: alive {n_alive} after "
                   f"{cs.STEPS + 1} steps (single-device step: {alive1}), "
                   f"collisions last step {int(aux.n_collisions)}, overflow "
                   f"on any rank {flag}")
            if launches != want or flag or int(aux.n_collisions) == 0 \
                    or n_alive != alive1 \
                    or not bool(torch.isfinite(g.x[g.alive]).all()):
                raise AssertionError(f"{label}: the slab step over {world} "
                                     f"devices failed its checks")
        if "d" in args.phases:
            del quads, s, aux, g

        # (e) the mesh driver with moving walls through a lifecycle
        # boundary, NCCL against gloo
        t_e = time.perf_counter()
        if "e" in args.phases:
            mesh_uniaxial(meshes, args.sim_steps)
        cs.log(f"[spatial4] (b) {t_c - t_b:.1f} s, (c) {t_d - t_c:.1f} s, "
               f"(d) {t_e - t_d:.1f} s, (e) "
               f"{time.perf_counter() - t_e:.1f} s")
    finally:
        dist.destroy_process_group()


CLOSE_IN = 300            # (e): the walls reach 85 km by this step


def mesh_uniaxial(meshes, steps=None) -> dict:
    """(e): ``uniaxial_sim()`` with ``mesh=`` on the NCCL slab mesh against
    the same on the gloo CPU mesh, float64, chunk by chunk
    (``chip_smoke.sim_lockstep``) for ``steps`` steps, by default through
    its first fracture boundary (its ProcessConfig's ``n_fracture``; it has
    no corners, and simplify waits for a floe of more than 30 vertices).
    The walls close as the validation campaign closes them for a
    CLOSE_IN-step run (1.5 km every 30 steps), so that the boundary
    fractures floes and the mesh rebalances its slabs.  Fails if no
    lifecycle pass ran.  Returns the passes' seconds."""
    import subzero_tpu_torch.validation as tval

    rate = (1e5 - 8.5e4) / (CLOSE_IN // 30)

    def uniaxial(device):
        sim = tval.uniaxial_sim(device=device, dtype="float64")
        sim.wall_fn = lambda s: (1e5, max(1e5 - rate * (s // 30), 8.5e4))
        sim.mesh = meshes["slabs" if device != "cpu" else "gloo"]
        sim.__post_init__()
        return sim

    if steps is None:
        steps = tval.uniaxial_sim(device="cpu").cfg.processes.n_fracture
    world = meshes["slabs"].size
    passes = cs.sim_lockstep(f"uniaxial_sim on {world} slabs", uniaxial,
                             steps)
    cs.log(f"[spatial4] (e) lifecycle passes on the NCCL mesh in {steps} "
           f"steps: " + ", ".join(f"{k} {v:.3f} s"
                                  for k, v in sorted(passes.items())))
    if not passes:
        raise AssertionError(f"(e): no lifecycle pass ran in {steps} steps")
    return passes


def dryrun_pack(mesh) -> None:
    """(c) The 1,024-quad pack of ``dryrun_multichip`` on the slab mesh,
    5 float64 steps, against the single-device step."""
    import torch

    from subzero_tpu_torch.config import (
        CapacityConfig, DomainConfig, NumericsConfig, ProcessConfig,
        SimConfig,
    )
    from subzero_tpu_torch.convert import state_from_numpy, state_to_numpy
    from subzero_tpu_torch.dynamics.step import make_step_fn
    from subzero_tpu_torch.forcing import uniform_forcing
    from subzero_tpu_torch.parallel import gather_state, shard_state
    from subzero_tpu_torch.parallel.spatial2d import mesh_step
    from subzero_tpu_torch.state import state_from_polygons

    s_n, n, side, pitch = mesh.size, 1024, 32, 4000.0
    lx = side * pitch / 2
    cap = -(-int(n * 1.25) // (8 * s_n)) * 8 * s_n
    cfg = SimConfig(
        capacity=CapacityConfig(max_floes=cap, max_verts=16, max_neighbors=8,
                                n_mc_points=64, stress_window=16,
                                max_ghosts=max(64, cap // 8)),
        numerics=NumericsConfig(dtype="float64"),
        domain=DomainConfig(lx=lx, ly=lx), processes=ProcessConfig(
            periodic=True))
    rng = np.random.default_rng(0)
    sq = 0.5 * np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    polys = [sq * pitch * 0.97 + rng.uniform(-0.03, 0.03, (4, 2)) * pitch
             + [-lx + (k % side) * pitch, -lx + (k // side + 0.5) * pitch]
             for k in range(n)]
    vel = rng.uniform(-2.0, 2.0, size=(n, 2))
    st0 = state_to_numpy(state_from_polygons(polys, 0.5, cfg, velocities=vel,
                                             device="cpu"))
    dev = mesh.device
    fc = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1, dtype=torch.float64,
                         device=dev)
    single = make_step_fn(cfg, fc, 1.6e8, device=dev)
    step, rebalance = mesh_step(cfg, fc, 1.6e8, 0.0, mesh)
    s1 = state_from_numpy(st0, device=dev, dtype=torch.float64)
    start = rebalance(s1)
    sn = shard_state(start, mesh)
    over = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(5):
        s1, _ = single(s1, i)
        sn, _ = step(sn, i)
        over = over | step.overflow
    over = bool(over)
    g = gather_state(sn, mesh)
    n_loc = cap // s_n
    w = 2 * lx / s_n

    def owners(st):
        a = st.alive.cpu().numpy()
        return np.nonzero(a)[0] // n_loc, st.x.cpu().numpy()[a]

    slots0, _ = owners(start)
    slots1, x = owners(g)
    stripe = np.clip(((x + lx) / w).astype(int), 0, s_n - 1)
    lo = -lx + slots1 * w
    on_edge = np.minimum(np.abs(x - lo), np.abs(x - lo - w)) < 1.0
    migrated = int(np.abs(np.bincount(slots1, minlength=s_n)
                          - np.bincount(slots0, minlength=s_n)).sum()) // 2
    r1, rn = cs.live_rows(s1), cs.live_rows(g)
    ok = r1.shape == rn.shape and np.allclose(rn, r1, rtol=1e-5, atol=1e-8)
    d = np.max(np.abs(rn - r1)) if r1.shape == rn.shape else float("inf")
    cs.log(f"[spatial4] (c) dryrun pack, {n} quads, 5 steps on {s_n} slabs: "
           f"alive {len(x)}, migrated >= {migrated}, mis-owned "
           f"{int(np.sum((slots1 != stripe) & ~on_edge))}, overflow on "
           f"any rank {over}; max|d| against the single-device step "
           f"{d:.3e}")
    if not ok or len(x) != n or migrated == 0 or over \
            or not np.all((slots1 == stripe) | on_edge):
        raise AssertionError("the dryrun pack failed its checks")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank-main", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--floes", type=int, default=cs.N_FLOES)
    ap.add_argument("--steps", type=int, default=cs.SPATIAL_STEPS)
    ap.add_argument("--sim-steps", type=int, default=None,
                    help="(e)'s depth; by default its first fracture step")
    ap.add_argument("--phases", default="bcde",
                    help="which of (b)-(e) to run, e.g. 'e'")
    args = ap.parse_args()
    if args.rank_main:
        run_rank(args)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_spatial4: CUDA is not available", file=sys.stderr)
        return 2
    rc = launch(args, torch.cuda.device_count())
    if rc:
        return rc
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
