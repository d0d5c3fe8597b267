#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``subzero_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and runs its main path there.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. Build the four CUDA kernels at once, one nvcc each:
   ``subzero_tpu_torch/csrc/clip.cu`` (the XLA twin's clip, the default
   "integral" route), ``csrc/clip_pallas.cu`` (the Pallas kernel's,
   phase 2b), ``csrc/broadphase.cu`` (the dense broad phase, phase 2c) and
   ``csrc/mc_mask.cu`` (the births' Monte-Carlo mask, phase 2d);
   print ptxas's registers, spills and static shared memory for every
   template instance, and check clip.cu's shared-memory mirror.
2. Hold clip.cu's kernel against its plain PyTorch version on the card, on seeded
   random convex and concave pairs at 1000 m scale, float32 and float64,
   intersection and difference: B=13, 81,920 and 81,921 (ragged last
   tile), B=1 and B one past a tile at Vp=Vq=16; 10,240 at 16x8; 4,096 at
   64x64; 2,048 at 64x8 and 8x64; triangles; pairs with mid-polygon
   duplicate vertices; collinear and touching squares; the nares_export
   campaign's floe and coastline, where the float32 clip of both versions
   reports a spurious overlap (ROADMAP §C) (f32: area within
   1e-5 max|area|, chord within 1e-2 m, n_cross exactly equal; f64 at 1e-9
   relative).  Then time it at 4,096x64x64 and at the model's default
   capacity (163,840 pairs of 64 slots, 10-30 real vertices; checked on
   its first 16,384 pairs), and on the main path's own pairs (below).
2b. ``contact_impl="pallas"``: the Hopper kernel of the Pallas kernel's
   clip (``csrc/clip_pallas.cu``, a different float32 function from
   clip.cu's XLA twin).  (a) Against its plain version
   (``geometry/clip_pallas.py``) on the card in float32 at phase 2's
   bounds, on the quad lattice's first-step overlap (81,920x16x16) and
   wall (10,240x16x8) pairs, the stars' active-pair pool batch
   (53,120x16x16), 4,096x64x64 and the default capacity (plain on its
   first 16,384 pairs), each timed, with a line per shape giving the kernel
   alone on the card, its bound and share, clip.cu alone on the same
   inputs, their ratio, the lane group G and ptxas's registers and spills;
   then phase 2's small and degenerate cases, both clips; on the
   nares_export coastline pair its overlap must be 0 (as JAX's kernel
   reports) or within 1e-5 of the floe's area.
   (b) Phase 4's aggregate periodic and (a) default walled quad lattices
   under "pallas", one warm-up and 30 timed steps: floe-steps/s, CUDA-event
   phase times and peak memory; with both launch counters zeroed just
   before and read just after, clip_pallas.cu launches once a periodic
   step and twice a walled one, clip.cu never.  (c) The walled 256-quad
   lattice under "pallas", CPU against CUDA in float64 for 20 steps:
   positions within 1e-2 m and velocities within 1e-3 m/s (the stats are
   float32 on both devices, see ``PALLAS_TOL_POS``), the same counts.
2c. The dense broad phase's kernel (``csrc/broadphase.cu``) against its
   plain version (``dynamics/broadphase.py:neighbor_candidates_plain``) on
   the card: idx, valid, shift, overflow and demand equal, bit for bit, at
   start states of the three benchmark cells' recipes at their scale
   (``BP_FIELDS``, built by the port's Voronoi field and state
   constructors: 20,000 float64 slots walled, 20,000 float32 slots
   periodic, 400 float32 slots walled; K grown on the state's demand as
   ``Simulation`` grows it) and at the first one's ~10,000 live floes alone;
   one launch a call.  Each timed alone on the card
   beside the plain version, with its bound (8 operations a pair test, 16
   on the torus, at 34 or 67 TFLOP/s) and share.
2d. The births' Monte-Carlo mask kernel (``csrc/mc_mask.cu``) against the
   host's numpy mask (``state.mc_inside``) on the card, bit for bit, from
   ``make_floe_arrays``' own points at winter-10k's shapes (400 points,
   rung 64): the cell's ~10,000-floe Voronoi field, its first 4,000 floes
   and 4,000 stars of 20-64 vertices; each timed alone beside the host's
   mask, with its bound (~10 float64 operations an edge test at 34 TFLOP/s,
   or its bytes) and share, and both whole ``make_floe_arrays`` routes
   timed.  Then ``winter_sim()`` on the card for 30 steps: the kernel
   launches once for every ``apply_edits`` call with births or reshapes,
   and at least once.
3. CPU against CUDA in float64, from the same numpy inputs, through
   ``make_step_fn(device="cpu")`` (plain clip) and ``device="cuda"``
   (kernel): a walled 256-quad lattice in aggregate mode for 20 steps; a
   walled cluster of 144 concave stars with per-region contacts for 20
   steps, then 10 steps each with the active-pair pool and with
   ``normal_dir="reclip"`` + ``region_dl="edge_mean"``; a periodic 256-quad
   lattice with the cell-list broad phase for 10 steps.  Positions within
   1e-6 m, velocities within 1e-9 m/s, the same collision count,
   region-pool demand and overflow flags every step; the star runs must
   decompose regions and never overflow.
4. Drive the main path at full size in float32 (V=16, K=8, 256 Monte-Carlo
   points, stress window 100, uniform 0.1 m/s ocean), one warm-up step then
   30 timed steps each, through ``make_step_fn``: the 10,240-floe dense quad
   lattice in aggregate mode, periodic and walled; (a) the same under the
   default ContactConfig (per-region contacts), periodic and walled; (b)
   bench.py's 10,240-floe concave-star lattice, periodic, with the region
   pool sized by a probe step as bench.py sizes it (it must never overflow
   and must decompose regions), and the same stars in aggregate mode, for
   the cost of the decomposition; (c) the quad lattice, periodic, with the
   cell-list broad phase (cell 1.5 pitch, 8 floes a cell).  Before the
   runs the kernel is held against the plain version (and timed) on the
   quad lattice's first-step pairs and on the stars' active-pair pool
   batch.  The kernel's launch counter is zeroed before each run and must
   read one launch per periodic step and two per walled step; the broad
   phase's one a step (none under the cell list).  Then
   ``contact_forces`` and ``boundary_contact`` run per-region and with the
   active-pair pool on run (b)'s end state under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync.

5. ``Simulation.run``, CPU against CUDA in float64, one chunk at a time
   (each chunk starts the CUDA run from the CPU run's state, config and
   lifecycle RNG: the packs amplify rounding, see ``sim_lockstep``):
   ``out_of_box_sim`` for 200 steps with the mass ledger held to 1e-9 and
   a CUDA checkpoint at step 100 that reloads field for field and runs one
   chunk on like the straight run; ``uniaxial_sim()`` for 70 steps (the
   walls move at 30 and 60); ``nares_sim(full_basin=True)`` for 60
   (topography, its exact union in the Eulerian fields); ``winter_sim()``
   with ``n_pack`` 50, AVERAGE and dissolved advection for 110 (merges
   first fire at 105).  Depths are cut from 1000/210/150/150 to keep the
   script in its time limit.  Every chunk: positions within 1e-6 m,
   velocities within 1e-9 m/s (floes lighter than the median live floe:
   the same bound on momentum), identical alive and nv, the same
   lifecycle edits (kills, births, masses; polygons vertex for vertex, or
   bounding the same region where the native boolean's vertex lists
   differ), dissolved grid and ledger within 1e-9; at each run's end the
   Eulerian fields of one state on both devices within 1e-9.  Every
   lifecycle pass (merges, ridge, raft, fracture, corners, weld,
   simplify, pack) must have run on CUDA.
6. The full-size run in float32 (``big_winter``): the winter configuration
   scaled in domain to lx = ly = 1e6 m with ~10,000 Voronoi floes of the
   published case's ~20 km, all processes, periodic, gyre ocean, AVERAGE
   on a 40x40 grid, the shadow ledger on; the cadence clock starts at step
   60, 10 warm-up steps, then 30 timed steps (cut from 150: the host passes
   take ~4.4 s a step at this size) through ``Simulation.run`` with the
   launch counts (the step's and the lifecycle's tables) zeroed just
   before and read just after (the broad phase's kernel at least once a
   step, the births' mask kernel at least once).  It prints
   floe-steps/s of the driver and of the bare ``make_step_fn`` step on the
   same state, ``phase_report()`` with the lifecycle's per-pass seconds,
   the live floe count before and after, peak memory and clip launches
   (one a step: the Eulerian calls clip with the segment-midpoint clip in
   plain PyTorch, as JAX's ``_overlap_one`` does), times the driver's
   per-step AVERAGE Eulerian call and its output call on the end state,
   and holds the kernel against the plain version on the output call's
   floe x cell pairs; it fails if the step launched the kernel fewer than
   once a step or an Eulerian call launched it at all, if a boundary's
   shadow-ledger drift, less the reference's known updated-winner leak
   (ROADMAP §C), reaches 1e-6 of the live mass, if corners, simplify,
   weld, ridge/raft or fracture never ran, or if a chunk was committed
   with a pool overflow.
7. The single-device remainder.  (a) The segment-midpoint clip
   (``overlap_stats_bm``, ``difference_stats_bm`` and the vmapped
   ``overlap_stats``; plain PyTorch on both devices), CUDA against CPU in
   float64 on phase 2's seeded pairs at 81,920x16x16 and 10,240x16x8 and
   the degenerate squares (the vmapped form against the CPU batch-minor
   overlap, which it equals within 1e-12 on the CPU): area, centroid and
   chord within 1e-9 of their scale, n_cross equal.  (b) The walled 256-quad lattice under
   ``contact_impl="xla"``, CPU against CUDA in float64 for 20 steps, as in
   phase 3, with no kernel launch.  (c) Phase 4's aggregate periodic
   10,240-quad lattice under ``contact_impl="xla"`` in float32, one
   warm-up and 30 timed steps: floe-steps/s, phase times and peak memory
   beside the "integral" run; the kernel's launch counter must read 0.
   (d) The CUDA step in float64 on the default "integral" route (the
   kernel, two launches a walled step) in lockstep with the serial oracle
   (``subzero_tpu_torch.oracle``) on test_golden.py's head-on blocks (400
   steps, cut from 1,200: the collision is over by step 300), complex
   concave floes with per-region contacts (2600) and 10-floe out-of-box
   gyre (500), at that file's check cadences and
   tolerances, kinetic energy dissipated in the two collisions; the
   oracle's floe-steps/s on the host beside the CUDA step's.  (e) If
   matplotlib imports, ``plot_basic`` of (d)'s end state (host copies) to
   a temporary PNG; otherwise one line saying no figure was drawn.
8. The spatial decomposition (``subzero_tpu_torch.parallel``) at world size
   1 (the machine has one GPU): (a) a world-size-1 NCCL group on
   ``tcp://127.0.0.1:<free port>`` with a ("shards",) and a 1x1 ("sx",
   "sy") mesh, and a gloo group over the same rank; (b) both meshes' steps
   against ``make_step_fn`` on the card in float64 for 20 steps on phase
   3's periodic and walled 256-quad lattices, per-region contacts,
   ``overlap_halo`` on and off: live rows within rtol 1e-5, atol 1e-8,
   equal collision counts, no overflow flag; (c) phase 4's aggregate
   periodic and default periodic lattices through the slab step in
   float32, one warm-up and 30 timed steps: floe-steps/s beside phase 4's,
   per-phase CUDA-event times (exchange, contact, band, wall, trajectory,
   migration), peak memory and the clip's launches (two a periodic step:
   the interior and band passes); before it the kernel on one slab step's
   interior and band batches against the plain version at phase 4's
   float32 bounds; after it the live floes equal to phase 4's and no
   overflow flag on any rank; one more step runs its exchange, contact
   and migration under ``torch.cuda.set_sync_debug_mode("error")``; (d)
   ``out_of_box_sim`` with ``mesh=`` on the NCCL group against the same on
   the gloo CPU group, float64, 60 steps through ``sim_lockstep``.
9. The validation campaign, ``subzero_tpu_torch.campaign`` through its
   command line (``campaign.main``), float32 on the card into a temporary
   directory: ``out_of_box`` for two output cadences (300 steps) straight,
   and the same in two legs with ``--resume`` at step 150; ``uniaxial``
   for 70 steps (its walls move at 30 and 60).  Every run exits 0 and its
   summary's ledger (floes + dissolved + exported over the step-0 total)
   is within 1e-6 of 1; the outputs (summaries, distributions, baselines,
   the mass series, the last snapshot) are written; the resumed leg ends
   at step 300 with the straight run's mass series rows, within 1e-6; the
   clip kernel launched at least twice a walled step.

Earlier lines report build time; at each timed shape the kernel's time per
wrapper call (host launch cost included, as the record's ``ms``), its card
time alone, the wrapper's host time per call, the plain version's time,
and the bound with the kernel's share of it; per run floe-steps/s,
per-phase CUDA-event times, peak memory, the region-pool sizes and the
largest region-pool demand.  The line before last holds the card's name
and power limit; before it, one JSON object with the kernels' records
(broadphase.cu's timed at phase 2c's first field, its ``max_abs_err``
the largest difference of idx and shift over phase 2c's fields, its
``launches`` summed over the seven phase-4 runs, one a step on the dense
route, and the phase-6 run; mc_mask.cu's timed at phase 2d's first set, its
``launches`` phase 2d's and phase 6's;
clip_pallas.cu's timed at the main path's overlap pairs, its ``launches``
from phase 2b (b)'s two runs; clip.cu's ``launches`` summed over the
seven phase-4 runs, the phase-6 run (the
step's clip, one a step, and the lifecycle passes'; the Eulerian calls
launch none), the three
phase-7 (d) runs, phase 8 (c)'s two slab-step runs and phase 9's four
campaign runs.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

MODULUS = 1.6e8          # the flagship workload's elastic modulus
N_FLOES = 10240
STEPS = 30


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def launch_counts(table):
    """(csrc/clip.cu, csrc/clip_pallas.cu) launches in a ``trace.Table``'s
    counts."""
    c = table.counts
    return c.get("clip.launches", 0), c.get("clip_pallas.launches", 0)


def bp_launches(table):
    """csrc/broadphase.cu launches in a ``trace.Table``'s counts."""
    return table.counts.get("broadphase.launches", 0)


def sim_launches(sim):
    """csrc/clip.cu launches of a Simulation's runs: the step's
    (``phase_times``) and the lifecycle passes' (``pass_times``)."""
    return sum(launch_counts(t)[0]
               for t in (sim.phase_times, sim.lifecycle.pass_times))


def random_pairs(b, vp, vq, seed, scale=1000.0, nv_range=None):
    """Seeded random pairs of star-shaped polygons (simple and CCW), padded
    by repeating vertex 0; about half of them concave.  Each polygon has
    3..V real vertices, or ``nv_range = (lo, hi)`` of them."""
    rng = np.random.default_rng(seed)

    def polys(v, center):
        lo, hi = nv_range or (3, v)
        nv = rng.integers(lo, hi + 1, size=b)
        k = np.arange(v)
        # nv increasing angles with gaps < pi: star-shaped about the
        # center, so simple and CCW
        th = 2 * np.pi * (k + 0.4 * rng.random((b, v))) / nv[:, None]
        r = rng.uniform(0.5, 1.0, size=(b, v))
        concave = (rng.random(b) < 0.5) & (nv >= 6)
        r = np.where(concave[:, None] & (k % 2 == 1), 0.4 * r, r)
        xy = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)
        xy = np.where((k < nv[:, None])[..., None], xy, xy[:, :1, :])
        return scale * (xy + center[:, None, :])

    p = polys(vp, np.zeros((b, 2)))
    q = polys(vq, rng.uniform(-1.2, 1.2, size=(b, 2)))
    return p, q


def with_duplicates(poly, v_out, seed):
    """Each [V, 2] row of ``poly`` widened to ``v_out`` slots by repeating
    randomly chosen slots in place (mid-polygon duplicate vertices) and
    padding with vertex 0: the same polygon, with zero-length edges
    inside."""
    rng = np.random.default_rng(seed)
    b, v, _ = poly.shape
    out = np.repeat(poly[:, :1], v_out, axis=1)
    for k in range(b):
        reps = 1 + rng.multinomial(v_out - v, np.ones(v) / v)
        reps = np.where(rng.random(v) < 0.5, reps, 1)
        row = np.repeat(poly[k], reps, axis=0)
        out[k, :len(row)] = row
    return out


def degenerate_pairs(v=16, scale=1000.0):
    """Collinear, touching, identical, nested and disjoint squares, padded
    by repeating vertex 0."""
    sq = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    cases = [(sq, sq), (sq, sq + [1.5, 0.0]), (sq, sq + [2.0, 0.0]),
             (sq, 0.25 * sq), (sq, sq + [1.0, 1.0]), (sq, sq + [5.0, 0.0]),
             (sq, sq + [2.0, 2.0]), (sq, sq + [0.0, 1.0])]

    def pad(a):
        return np.concatenate([a, np.repeat(a[:1], v - len(a), 0)])

    p = np.stack([pad(a) for a, _ in cases])
    q = np.stack([pad(c) for _, c in cases])
    return scale * p, scale * q


def lattice(n_floes, seed=0, pitch=4000.0):
    """The flagship dense pack (bench.py's ``build``): a ~sqrt(N) x sqrt(N)
    lattice of jittered quads at ~93% concentration, random velocities."""
    side = int(np.ceil(np.sqrt(n_floes)))
    lx = side * pitch / 2
    rng = np.random.default_rng(seed)
    sq = 0.5 * np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    polys = []
    for k in range(n_floes):
        i, j = divmod(k, side)
        center = np.array([-lx + (j + 0.5) * pitch, -lx + (i + 0.5) * pitch])
        jitter = rng.uniform(-0.03, 0.03, size=(4, 2)) * pitch
        polys.append(sq * pitch * 0.97 + jitter + center)
    vel = rng.uniform(-0.1, 0.1, size=(n_floes, 2))
    return polys, vel, lx


def star_lattice(n_floes, seed=0, pitch=4000.0):
    """bench.py's concave workload (``build_concave``): a ~sqrt(N) x
    sqrt(N) lattice of interlocking concave stars, 5-8 arms (10-16
    vertices), arm tips at 0.65 pitch, random velocities.  Nearly every
    contact crosses four or more times, so the region decomposition runs."""
    side = int(np.ceil(np.sqrt(n_floes)))
    lx = side * pitch / 2
    rng = np.random.default_rng(seed)
    polys = []
    for k in range(n_floes):
        i, j = divmod(k, side)
        cx, cy = -lx + (j + 0.5) * pitch, -lx + (i + 0.5) * pitch
        nv = 2 * int(rng.integers(5, 9))
        th = (np.linspace(0, 2 * np.pi, nv + 1)[:-1]
              + rng.uniform(0, np.pi / nv))
        r = 0.45 * pitch * (
            1 + 0.45 * np.where(np.arange(nv) % 2 == 0, 1.0, -1.0)
            + rng.uniform(-0.1, 0.1, nv))
        polys.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)],
                              axis=1))
    vel = rng.uniform(-0.1, 0.1, size=(n_floes, 2))
    return polys, vel, lx


def lattice_config(n_floes, lx, periodic, dtype, n_mc=256, window=100,
                   contact=None, numerics=None, capacity=None):
    """V=16, K=8 at ``n_floes``; ``contact`` / ``numerics`` / ``capacity``:
    ContactConfig, NumericsConfig and CapacityConfig fields (default:
    aggregate contacts)."""
    from subzero_tpu_torch.config import (
        CapacityConfig, ContactConfig, DomainConfig, NumericsConfig,
        ProcessConfig, SimConfig,
    )

    return SimConfig(
        capacity=CapacityConfig(max_floes=int(np.ceil(n_floes / 8)) * 8,
                                max_verts=16, max_neighbors=8,
                                n_mc_points=n_mc, stress_window=window,
                                **(capacity or {})),
        numerics=NumericsConfig(dtype=dtype, **(numerics or {})),
        domain=DomainConfig(lx=lx, ly=lx),
        processes=ProcessConfig(periodic=periodic),
        contact=ContactConfig(**({"per_region": False} if contact is None
                                 else contact)),
    )


def region_pool_slots(cfg):
    """(floe-floe, wall) region-pool sizes of ``_blend_regions_compact``."""
    import math

    frac = cfg.contact.region_pair_frac
    n = cfg.capacity.max_floes
    p = n * cfg.capacity.max_neighbors
    return (min(p, max(128, math.ceil(p * frac))),
            min(n, max(128, math.ceil(n * frac))))


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call of ``fn`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def card_ms(fn, reps=20, warmup=3):
    """(card milliseconds, host microseconds) per call of ``fn``.  A spin
    kernel of ~10 ms runs first, so the host queues all ``reps`` calls
    before the card reaches them: the CUDA events then time the card alone,
    and the host clock around the loop times the calls' host work alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - h0
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, host / reps * 1e6


def real_edges(poly):
    """Edges of non-zero length per polygon, [B] (the kernel skips the
    zero-length padding edges)."""
    import torch

    d = torch.roll(poly, -1, dims=1) - poly
    return ((d[..., 0] != 0) | (d[..., 1] != 0)).sum(dim=1)


def clip_bound_ms(p, q):
    """Least time the card could take for the clip on (p, q): the larger of
    bytes (each input read once, each output written once) over 3.35 TB/s
    and float operations over 67 TFLOP/s (f32 without tensor cores),
    counting 90 operations per (P edge, Q edge) pair per side, as the Pallas
    kernel's cost estimate does (clip_pallas.py:186-190), for the edges of
    non-zero length in this data."""
    b = p.shape[0]
    nbytes = (p.numel() + q.numel()) * p.element_size() + b * (
        5 * p.element_size() + 4)
    pairs = float((real_edges(p) * real_edges(q)).sum())
    flops = 2 * 90 * pairs
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = flops / 67e12 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def compare(got, want, dtype, where):
    """Kernel result against the plain version: raises on disagreement,
    returns the largest absolute differences."""
    import torch

    d_area = float((got.area - want.area).abs().max())
    d_chord = float((got.chord_p - want.chord_p).abs().max())
    ok_area = want.area.abs().max().item()
    ok_chord = want.chord_p.abs().max().item()
    if dtype == torch.float32:
        tol_area, tol_chord = 1e-5 * ok_area, 1e-2
    else:
        tol_area, tol_chord = 1e-9 * ok_area, 1e-9 * max(ok_chord, 1.0)
    bad_nc = int((got.n_cross != want.n_cross).sum())
    if d_area > tol_area or d_chord > tol_chord or bad_nc:
        raise AssertionError(
            f"kernel disagrees with plain at {where}: d_area {d_area} "
            f"(tol {tol_area}), d_chord {d_chord} (tol {tol_chord}), "
            f"{bad_nc} n_cross mismatches")
    return d_area, d_chord


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def ptxas_instances(log):
    """(instance, registers, spill stores B, spill loads B, static smem B)
    for each kernel instance in nvcc's ``-Xptxas -v`` report."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(_Z\w+)", line)
        if m:
            name = m.group(1)
            k = re.search(r"clip_kernelI([fd])Li(\d+)E", name)
            kp = re.search(r"clip_pallas_kernelILi(\d+)E", name)
            dtype = k and ("float" if k.group(1) == "f" else "double")
            cur = {"name": f"clip_kernel<{dtype}, G={k.group(2)}>" if k
                   else f"clip_pallas_kernel<G={kp.group(1)}>" if kp
                   else name}
            if not out or out[-1]["name"] != cur["name"]:
                out.append(cur)
            else:
                cur = out[-1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_st"], cur["spill_ld"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def phase_build():
    """The four kernel sources built at once, one nvcc each."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from subzero_tpu_torch.kernels import broadphase as kbp
    from subzero_tpu_torch.kernels import clip as kclip
    from subzero_tpu_torch.kernels import clip_pallas as kpallas
    from subzero_tpu_torch.kernels import mc_mask as kmc

    t0 = time.perf_counter()
    mods = (("clip.cu", kclip), ("clip_pallas.cu", kpallas),
            ("broadphase.cu", kbp), ("mc_mask.cu", kmc))
    with ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m[1].build(), mods))
    lib = libs[0]
    for src, mod in mods:
        log(f"[build] {src} -> {mod.build_info['path']} "
            f"(compiled here: {mod.build_info['compiled']}) in "
            f"{mod.build_info['seconds']:.3f} s")
        inst = ptxas_instances(mod.build_info["log"])
        if not inst:
            raise AssertionError(f"no ptxas report for {src}")
        for r in inst:
            log(f"[build] ptxas {r['name']}: {r.get('regs')} registers, "
                f"{r.get('spill_st')} B spill stores, {r.get('spill_ld')} B "
                f"spill loads, {r.get('smem')} B static shared memory")
    log(f"[build] all sources in {time.perf_counter() - t0:.3f} s")
    # the wrapper's shared-memory mirror must equal the kernel's own
    fn = lib.clip_tile_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for g in (1, 2, 4, 8, 16, 32):
        for vp, vq in ((16, 16), (16, 8), (64, 64), (3, 3)):
            for isz in (4, 8):
                if fn(g, vp, vq, isz) != kclip.tile_bytes(g, vp, vq, isz):
                    raise AssertionError(f"tile_bytes mirror differs at "
                                         f"G={g} Vp={vp} Vq={vq} {isz} B")


def coastline_pair(v=16):
    """The floe and the western coastline of the nares_export campaign at
    step 5,193 (float32 values in the floe's frame, padded to ``v`` slots
    by repeating vertex 0): the floe lies 6.6 m from the coastline's 270 km
    edge, and the float32 parity-integral clip reports an overlap of twice
    the floe's area where there is none (ROADMAP §C)."""
    floe = np.array([[-13804.852, 8189.8145], [-13827.055, -2929.4949],
                     [-2652.168, -8302.184], [8967.305, -8930.788],
                     [13596.332, -4865.3584], [12825.676, 4040.1536],
                     [11223.166, 6828.0137]], np.float32)
    coast = np.array([[-13798.238, -273057.47], [16201.762, -273057.47],
                      [16201.762, -123057.48], [-6298.2383, -13057.478],
                      [-13798.238, -3057.4778]], np.float32)

    def padded(poly):
        return np.concatenate([poly, np.repeat(poly[:1], v - len(poly), 0)])

    return (padded(floe)[None].astype(np.float64),
            padded(coast)[None].astype(np.float64))


def one_past_tile(vp, vq):
    """The smallest B whose pairs fill one kernel tile and one more pair."""
    from subzero_tpu_torch.kernels import clip as kclip

    return next(b for b in range(2, 10 ** 6)
                if b == kclip.THREADS // kclip.lane_group(b, vp, vq) + 1)


def check_shapes():
    """(label, p, q) numpy pairs that the kernel is held against the plain
    version on."""
    cases = []
    for b, vp, vq in [(13, 16, 16), (81920, 16, 16), (10240, 16, 8),
                      (4096, 64, 64), (2048, 64, 8), (2048, 8, 64),
                      (1, 16, 16), (one_past_tile(16, 16), 16, 16),
                      (81921, 16, 16), (4096, 3, 3)]:
        cases.append((f"B={b} Vp={vp} Vq={vq}",
                      *random_pairs(b, vp, vq, seed=b + vp + vq)))
    p, q = random_pairs(2048, 16, 16, seed=5)
    cases.append(("duplicates B=2048 Vp=Vq=24",
                  with_duplicates(p, 24, seed=6), with_duplicates(q, 24, 7)))
    cases.append(("degenerate B=8 Vp=Vq=16", *degenerate_pairs()))
    cases.append(("coastline B=1 Vp=Vq=16", *coastline_pair()))
    return cases


def phase_kernel_vs_plain():
    import torch

    from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
    from subzero_tpu_torch.kernels import clip as kclip

    worst = 0.0
    for label, p_np, q_np in check_shapes():
        g = kclip.lane_group(*p_np.shape[:2], q_np.shape[1])
        for dtype in (torch.float32, torch.float64):
            p = torch.from_numpy(p_np).to("cuda", dtype)
            q = torch.from_numpy(q_np).to("cuda", dtype)
            for diff in (False, True):
                got = kclip.clip_stats_cuda(p, q, diff)
                want = clip_integral_bm(p, q, diff)
                da, dc = compare(got, want, dtype,
                                 f"{label} {dtype} "
                                 f"{'difference' if diff else 'overlap'}")
                log(f"[kernel] {label:28s} G={g:2d} "
                    f"{str(dtype)[6:]:7s} {'diff' if diff else 'ovl '} "
                    f"max|d area| {da:.3e}  max|d chord| {dc:.3e}  "
                    f"n_cross equal")
                if dtype == torch.float32:
                    worst = max(worst, da)
    torch.cuda.synchronize()
    return worst


def time_kernel(name, a, b, diff, plain_on=None, pallas=False):
    """Kernel and plain-version times at (a, b) by ``cuda_ms``, with the
    bound and the kernel's share of it; the plain version runs on the first
    ``plain_on`` pairs where its [Vp, Vq, B] temporaries would not fit at
    full B.  A second line gives the kernel's card time alone and the
    wrapper's host time per call (``card_ms``).  ``pallas``: the Pallas
    kernel's clip (``csrc/clip_pallas.cu``) and its plain version, in place
    of clip.cu and ``clip_integral_bm``."""
    from subzero_tpu_torch.kernels import clip as kclip

    if pallas:
        from subzero_tpu_torch.geometry.clip_pallas import (
            _clip_pallas as plain_fn,
        )
        from subzero_tpu_torch.kernels.clip_pallas import (
            clip_pallas_cuda as launch,
        )
    else:
        from subzero_tpu_torch.geometry.clip_integral import (
            clip_integral_bm as plain_fn,
        )
        launch = kclip.clip_stats_cuda

    def kernel():
        launch(a, b, diff)

    ms = cuda_ms(kernel)
    card, host_us = card_ms(kernel)
    n = plain_on or a.shape[0]
    plain = cuda_ms(lambda: plain_fn(a[:n], b[:n], diff), reps=5)
    bound, by, nbytes, flops = clip_bound_ms(a, b)
    vp, vq = a.shape[1], b.shape[1]
    if pallas:
        from subzero_tpu_torch.kernels import clip_pallas as kpallas

        g = kpallas.lane_group(a.shape[0], vp, vq)
        smem = kclip.tile_bytes(g, vp, vq, 4)
    else:
        g = kclip.lane_group(a.shape[0], vp, vq)
        smem = kclip.tile_bytes(g, vp, vq, a.element_size())
    log(f"[time] {name}: B={a.shape[0]} Vp={vp} Vq={vq} "
        f"G={g}  kernel {ms:.4f} ms  plain {plain:.4f} ms"
        + (f" (on {n} pairs)" if plain_on else "")
        + f"  bound {bound:.4f} ms ({by}: {nbytes} B, {flops:.4g} flop)  "
        f"share of bound {bound / ms:.1%}  smem/block {smem} B")
    log(f"[time] {name}: card alone {card:.4f} ms (share of bound "
        f"{bound / card:.1%}), wrapper host {host_us:.1f} us per call")
    return ms, plain, bound, by


def phase_wide_shapes():
    """The kernel at 4,096 x 64 x 64 and at the model's default capacity
    (10,240 floes x K=16 pairs of 64 slots, 10-30 real vertices), timed;
    the latter held against the plain version on its first 16,384 pairs."""
    import torch

    from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
    from subzero_tpu_torch.kernels import clip as kclip

    p, q = (torch.from_numpy(x).to("cuda", torch.float32)
            for x in random_pairs(4096, 64, 64, seed=4096 + 128))
    time_kernel("wide 64x64", p, q, False)
    p, q = (torch.from_numpy(x).to("cuda", torch.float32)
            for x in random_pairs(163840, 64, 64, seed=11,
                                  nv_range=(10, 30)))
    n = 16384
    got = kclip.clip_stats_cuda(p, q, False)
    want = clip_integral_bm(p[:n], q[:n], False)
    sub = type(got)(*(x[:n] for x in got))
    da, dc = compare(sub, want, torch.float32, "default-capacity shape")
    log(f"[kernel] default capacity B=163840 Vp=Vq=64 (10-30 real): first "
        f"{n} pairs max|d area| {da:.3e}  max|d chord| {dc:.3e}  n_cross "
        f"equal")
    time_kernel("default capacity", p, q, False, plain_on=n)
    del p, q, got, want, sub
    torch.cuda.empty_cache()
    return da


# ---------------------------------------------------------------------------
# phase 2c: the dense broad phase's kernel
# ---------------------------------------------------------------------------

# Peak rates of one H100 SXM outside the tensor cores (NVIDIA's data sheet)
F64_FLOPS = 34e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
BP_SEED = 2026101813      # the cells' floe order and RNG


def broadphase_field(lx, n_floes, grid, dtype, periodic, seed, device):
    """The positions, radii and liveness of a Voronoi floe field built by
    the port's own constructors (``init.voronoi_floe_field``,
    ``state.state_from_polygons``) on ``2 n_floes`` slots, with the
    published recipes' 4e6 m^2 Voronoi cull, and the state's config."""
    from subzero_tpu_torch.config import (
        CapacityConfig, DomainConfig, NumericsConfig, ProcessConfig,
        SimConfig,
    )
    from subzero_tpu_torch.init import voronoi_floe_field
    from subzero_tpu_torch.state import state_from_polygons

    cfg = SimConfig(
        processes=ProcessConfig(periodic=periodic),
        numerics=NumericsConfig(dtype=dtype),
        domain=DomainConfig(lx=lx, ly=lx),
        capacity=CapacityConfig(max_floes=2 * n_floes, max_verts=64,
                                max_neighbors=12, n_mc_points=400,
                                stress_window=1000))
    polys, heights = voronoi_floe_field(cfg, np.ones((grid, grid)), n_floes,
                                        height_mean=1.0, min_floe_size=4e6,
                                        seed=seed)
    st = state_from_polygons(polys, heights, cfg, seed=seed, device=device)
    return (st.x, st.y, st.rmax, st.alive), cfg


# Phase 2c's fields: the three benchmark cells' recipes at their scale
# (half-width m, floes, target-concentration grid, dtype, periodic)
BP_FIELDS = (("uniaxial-10k", 707000.0, 10000, 25, "float64", False),
             ("winter-10k", 1e6, 10000, 25, "float32", True),
             ("uniaxial-200", 1e5, 200, 1, "float32", False))


def broadphase_inputs(seed=BP_SEED, device="cuda"):
    """Phase 2c's inputs: a start state of each benchmark cell's recipe at
    its scale (``BP_FIELDS``), and the first one's live floes alone,
    ``[(label, (x, y, rmax, alive), k, periodic, lx, ly, n_skip)]``.  K is
    the recipes' ``max_neighbors``, grown as ``Simulation._grow_pools``
    grows it on this state's demand."""
    from subzero_tpu_torch.dynamics.broadphase import neighbor_candidates
    from subzero_tpu_torch.sim import _ladder_k

    out = []
    for name, lx, n_floes, grid, dtype, periodic in BP_FIELDS:
        args, cfg = broadphase_field(lx, n_floes, grid, dtype, periodic,
                                     seed, device)
        k, n_skip = cfg.capacity.max_neighbors, cfg.n_boundary
        demand = int(neighbor_candidates(*args, k, periodic, lx, lx,
                                         n_skip_rows=n_skip).demand)
        if demand > k:
            k = min(_ladder_k(max(int(demand * 1.1) + 1, k + 1)),
                    args[0].shape[0])
        out.append((f"{name} ({args[0].dtype}, "
                    f"{'periodic' if periodic else 'walled'})", args, k,
                    periodic, lx, lx, n_skip))
    # the first field's live floes alone (without its dead slots)
    label, args, k, periodic, lx, ly, n_skip = out[0]
    keep = args[3].clone()
    keep[:n_skip] = True
    live = tuple(a[keep].contiguous() for a in args)
    name = BP_FIELDS[0][0]
    out.insert(1, (f"{name} live floes{label[len(name):]}", live, k,
                   periodic, lx, ly, n_skip))
    return out


def broadphase_bound_ms(args, k, periodic, n_skip):
    """(least ms, "operations" or "bytes") of the table at these inputs:
    8 operations a pair test (16 on the torus) over the rows that test (alive
    and not skipped) against every source slot, at the dtype's rate; or
    every input byte read once and the table written once."""
    x, _, _, alive = args
    n, item = x.shape[0], x.element_size()
    rows = int(alive[n_skip:].sum())
    ops = rows * n * (16 if periodic else 8)
    rate = F64_FLOPS if item == 8 else F32_FLOPS
    nbytes = n * (3 * item + 1) + n * k * (4 + 1 + 2 * item) + 4
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_broadphase(record):
    """Phase 2c: the dense broad phase's kernel (``csrc/broadphase.cu``)
    against its plain version on the card, bit for bit in every field of
    the table, at the three benchmark cells' start states and the first
    one's live floes; each timed alone on the card (``card_ms``) beside the
    plain version, with its bound and share."""
    import torch

    from subzero_tpu_torch import trace
    from subzero_tpu_torch.dynamics import broadphase as bp

    t0 = time.perf_counter()
    cases = broadphase_inputs()
    log(f"[broadphase] built the cells' start states in "
        f"{time.perf_counter() - t0:.1f} s")
    fields = ("idx", "valid", "shift", "overflow", "demand")
    for label, args, k, periodic, lx, ly, n_skip in cases:
        def kernel():
            return bp.neighbor_candidates(*args, k, periodic, lx, ly,
                                          n_skip_rows=n_skip)

        def plain():
            return bp.neighbor_candidates_plain(*args, k, periodic, lx, ly,
                                                n_skip_rows=n_skip)

        with trace.recording(trace.Table()) as table:
            got = kernel()
        want = plain()
        torch.cuda.synchronize()
        for f in fields:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"broad phase {label}: {f} differs "
                                     f"from the plain version's")
        err = max(float((getattr(got, f).double() - getattr(want, f).double()
                         ).abs().max()) for f in ("idx", "shift"))
        record["max_abs_err"] = max(record["max_abs_err"], err)
        if bp_launches(table) != 1:
            raise AssertionError(f"broad phase {label}: "
                                 f"{bp_launches(table)} launches")
        ms, host_us = card_ms(kernel)
        plain_ms, _ = card_ms(plain, reps=3, warmup=1)
        bound, by = broadphase_bound_ms(args, k, periodic, n_skip)
        n = args[0].shape[0]
        log(f"[broadphase] {label}: N=M={n}, K={k}, demand "
            f"{int(want.demand)}, {int(want.valid.sum())} candidates: table "
            f"equal; kernel alone {ms:.4f} ms ({host_us:.1f} us host a "
            f"call), bound {bound:.4f} ms ({by}), share {bound / ms:.1%}; "
            f"plain {plain_ms:.3f} ms ({plain_ms / ms:.0f}x)")
        if "ms" not in record:
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by)
        del got, want
    torch.cuda.empty_cache()


# Phase 2d's shapes: the births of a winter-10k segment (~4,000 floes a
# boundary at rung 64, 400 points) and the cell's 10,000-floe build
MC_P = 400
MC_V = 64
MC_BIRTHS = 4000
MC_SEED = 2026101818


def mc_mask_inputs(seed=MC_SEED):
    """Phase 2d's floe sets, ``[(label, polygons)]``: winter-10k's start
    field (``BP_FIELDS``' recipe through ``init.voronoi_floe_field``, ~10,000
    Voronoi cells of 5-10 vertices), its first ``MC_BIRTHS`` floes, and
    ``MC_BIRTHS`` star-shaped floes of 20-64 vertices (the welded and
    fractured floes that grow the rung to 64)."""
    from subzero_tpu_torch.config import (
        CapacityConfig, DomainConfig, SimConfig,
    )
    from subzero_tpu_torch.init import voronoi_floe_field

    cfg = SimConfig(domain=DomainConfig(lx=1e6, ly=1e6),
                    capacity=CapacityConfig(max_floes=20000, max_verts=MC_V,
                                            n_mc_points=MC_P))
    polys, _ = voronoi_floe_field(cfg, np.ones((25, 25)), 10000,
                                  min_floe_size=4e6, seed=seed)
    rng = np.random.default_rng(seed)
    stars = []
    for nv in rng.integers(20, MC_V + 1, MC_BIRTHS):
        ang = (np.arange(nv) + rng.uniform(0.1, 0.9, nv)) * (2 * np.pi / nv)
        rad = 1e4 * rng.uniform(0.4, 1.0, nv)
        stars.append(np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)
                     + rng.uniform(-1e6, 1e6, 2))
    return cfg, [(f"winter-10k field, {len(polys)} floes", polys),
                 (f"winter-10k field, first {MC_BIRTHS}", polys[:MC_BIRTHS]),
                 (f"{MC_BIRTHS} stars of 20-{MC_V} vertices", stars)]


def mc_mask_bound_ms(nv, b, v, p):
    """(least ms, "operations" or "bytes") of the mask: ~10 float64
    operations an edge test over each floe's real edges, or the points,
    vertices and counts read once and the mask written once."""
    ops = 10.0 * p * float(np.sum(nv))
    nbytes = b * p * (16 + 1) + b * v * 16 + b * 4
    t_ops, t_bytes = ops / F64_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_mc_mask(record):
    """Phase 2d: the births' Monte-Carlo mask kernel (``csrc/mc_mask.cu``)
    against the host's numpy mask (``state.mc_inside``) at winter-10k's
    shapes, bit for bit, from ``make_floe_arrays``' own points; each timed
    alone on the card beside the host's mask and both whole
    ``make_floe_arrays`` routes; then a winter run's births must launch it
    once for every ``apply_edits`` call that births or reshapes."""
    import torch

    from subzero_tpu_torch import trace
    from subzero_tpu_torch.kernels.mc_mask import mc_mask_cuda
    from subzero_tpu_torch.state import make_floe_arrays, mc_inside
    from subzero_tpu_torch.validation import winter_sim

    t0 = time.perf_counter()
    cfg, cases = mc_mask_inputs()
    log(f"[mc_mask] built the floe sets in {time.perf_counter() - t0:.1f} s")
    for label, polys in cases:
        b, heights = len(polys), np.ones(len(polys))
        t0 = time.perf_counter()
        host = make_floe_arrays(polys, heights, cfg, seed=MC_SEED, v_cap=MC_V)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with trace.recording(trace.Table()) as table:
            card = make_floe_arrays(polys, heights, cfg, seed=MC_SEED,
                                    v_cap=MC_V, device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        if table.counts != {"mc_mask.launches": 1, "mc_mask.floes": b}:
            raise AssertionError(f"mc_mask {label}: counts {table.counts}")
        record["launches"] += 1
        if not np.array_equal(card["mc_xy"].cpu().numpy(), host["mc_xy"]):
            raise AssertionError(f"mc_mask {label}: points differ")
        miss = int((card["mc_in"].cpu() != torch.from_numpy(
            host["mc_in"])).sum())
        if miss:
            raise AssertionError(f"mc_mask {label}: {miss} mask bits differ "
                                 f"from the host's")
        verts = torch.from_numpy(host["verts_body"]).cuda()
        nv = torch.from_numpy(host["nv"]).cuda()
        pts = card["mc_xy"]
        ms, host_us = card_ms(lambda: mc_mask_cuda(verts, nv, pts))
        t0 = time.perf_counter()
        mc_inside(host["verts_body"], host["mc_xy"])
        numpy_ms = (time.perf_counter() - t0) * 1e3
        bound, by = mc_mask_bound_ms(host["nv"], b, MC_V, MC_P)
        log(f"[mc_mask] {label}: B={b}, V={MC_V}, P={MC_P}, "
            f"{int(host['nv'].sum())} real edges, "
            f"{int(host['mc_in'].sum())} points inside: mask equal; kernel "
            f"alone {ms:.4f} ms ({host_us:.1f} us host a call), bound "
            f"{bound:.4f} ms ({by}), share {bound / ms:.1%}; host numpy mask "
            f"{numpy_ms:.1f} ms ({numpy_ms / ms:.0f}x); make_floe_arrays "
            f"host route {host_s:.3f} s, card route {card_s:.3f} s "
            f"(upload and kernel included)")
        if "ms" not in record:
            record.update(ms=ms, plain_ms=numpy_ms, bound_ms=bound,
                          bound_by=by)
    # the route: a winter run's births and reshapes go through the kernel,
    # one launch an apply_edits call that has any
    sim = winter_sim(device="cuda")
    t0 = time.perf_counter()
    sim.run(MC_WINTER_STEPS)
    torch.cuda.synchronize()
    pt = sim.lifecycle.pass_times
    launches = pt.counts.get("mc_mask.launches", 0)
    calls = pt.entries.get("apply_edits/floe_arrays", 0)
    log(f"[mc_mask] winter_sim, {MC_WINTER_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s: {launches} kernel launches for "
        f"{pt.counts.get('mc_mask.floes', 0)} floes, {calls} apply_edits "
        f"calls with births or reshapes")
    if not launches or launches != calls:
        raise AssertionError(f"phase 2d: {launches} mask launches for "
                             f"{calls} apply_edits calls with births")
    record["launches"] += launches
    torch.cuda.empty_cache()


MC_WINTER_STEPS = 30      # phase 2d: births at the boundaries 10, 20, 25, 30


# ---------------------------------------------------------------------------
# phase 2b: contact_impl="pallas", the Pallas kernel's clip
# ---------------------------------------------------------------------------

PALLAS_TOL_POS = 1e-2     # m: phase 2b (c), CPU against CUDA under "pallas"
PALLAS_TOL_VEL = 1e-3     # m/s


def pallas_shapes(built):
    """Phase 2b's five timed shapes, float32 on the card, as ``[(label, p,
    q, difference, plain_on)]``: the quad lattice's first-step overlap and
    wall pairs, the stars' active-pair pool batch (from ``built``, the
    return of ``main_path_runs``), 4,096 x 64 x 64 and the default capacity
    (the plain version on its first 16,384 pairs)."""
    import torch

    from subzero_tpu_torch.dynamics import contact as tcontact
    from subzero_tpu_torch.dynamics.broadphase import neighbor_candidates
    from subzero_tpu_torch.dynamics.step import domain_polygon

    runs, (stars, _, cfg_pool, slx) = built

    def on_card(*arrays):
        return [torch.from_numpy(x).to(stars.device, torch.float32)
                for x in arrays]

    _, quads, _, cfg_p = runs[0]
    p, q, fw, wq = main_path_pairs(quads, cfg_p)
    nbr = neighbor_candidates(stars.x, stars.y, stars.rmax, stars.alive, 8,
                              True, slx, slx)
    (pp, pq), = captured_clip_inputs(lambda: tcontact.contact_forces(
        stars.verts_world(), stars.x, stars.y, stars.u, stars.v, stars.ksi,
        stars.h, stars.area, nbr, MODULUS, cfg_pool, nv=stars.nv,
        domain_verts=domain_polygon(cfg_pool, device=stars.device)))
    return [("main-path overlap", p, q, False, None),
            ("main-path wall difference", fw, wq, True, None),
            ("pair-pool batch", pp, pq, False, None),
            ("wide 64x64", *on_card(*random_pairs(4096, 64, 64,
                                                  seed=4096 + 128)),
             False, None),
            ("default capacity", *on_card(*random_pairs(
                163840, 64, 64, seed=11, nv_range=(10, 30))), False, 16384)]


def ptxas_of(log_text, name):
    """(registers, spill stores B, spill loads B) of kernel instance
    ``name`` (as ``ptxas_instances`` names it) in an nvcc report."""
    r = next((r for r in ptxas_instances(log_text) if r["name"] == name), {})
    return r.get("regs"), r.get("spill_st"), r.get("spill_ld")


def beside_clip_cu(label, a, b, diff):
    """Phase 2b's line per timed shape: clip_pallas.cu alone on the card
    (``card_ms``), its bound and share, clip.cu alone on the same inputs
    in the same call, their ratio, each kernel's lane group G and ptxas's
    registers and spills for that instance.  clip.cu's arithmetic and lane
    groups do not change with this kernel, so the ratio compares across
    calls and machines."""
    from subzero_tpu_torch.kernels import clip as kclip
    from subzero_tpu_torch.kernels import clip_pallas as kpallas

    n, vp, vq = a.shape[0], a.shape[1], b.shape[1]
    g, g_cu = kpallas.lane_group(n, vp, vq), kclip.lane_group(n, vp, vq)
    ms, _ = card_ms(lambda: kpallas.clip_pallas_cuda(a, b, diff))
    ms_cu, _ = card_ms(lambda: kclip.clip_stats_cuda(a, b, diff))
    bound, by, _, _ = clip_bound_ms(a, b)
    regs, st, ld = ptxas_of(kpallas.build_info["log"],
                            f"clip_pallas_kernel<G={g}>")
    log(f"[pallas] {label}: alone {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
        f"share {bound / ms:.1%}; clip.cu alone {ms_cu:.4f} ms (G={g_cu}); "
        f"ratio to clip.cu {ms / ms_cu:.2f}; G={g}, {regs} registers, "
        f"{st} B spill stores, {ld} B spill loads")


def phase_pallas(record, built):
    """Phase 2b: the Hopper kernel of the Pallas kernel's clip
    (``csrc/clip_pallas.cu``), float32.  (a) Against its plain version on
    the card at the main path's shapes (the quad lattice's first-step
    overlap and wall pairs, the stars' active-pair pool batch), 4,096 x 64
    x 64, the default capacity (plain on the first 16,384 pairs), phase 2's
    small and degenerate cases and the nares_export coastline pair, timed
    at the five main shapes beside clip.cu (``beside_clip_cu``).  (b)
    Phase 4's aggregate periodic and (a) default walled quad lattices
    under ``contact_impl="pallas"``, one
    warm-up and STEPS timed steps: the kernel launches once a periodic step
    and twice a walled one, clip.cu never.  (c) The walled 256-quad lattice
    under "pallas", CPU against CUDA in float64 for 20 steps."""
    import torch

    from subzero_tpu_torch.geometry.clip_pallas import _clip_pallas
    from subzero_tpu_torch.kernels import clip_pallas as kpallas

    t0 = time.perf_counter()
    runs, (stars, _, _, _) = built

    def on_card(*arrays):
        return [torch.from_numpy(x).to(stars.device, torch.float32)
                for x in arrays]

    def check(label, a, b, diff, n=None):
        got = kpallas.clip_pallas_cuda(a, b, diff)
        if n is not None:
            got = type(got)(*(x[:n] for x in got))
            a, b = a[:n], b[:n]
        want = _clip_pallas(a, b, diff)
        da, dc = compare(got, want, torch.float32, f"pallas {label}")
        log(f"[pallas] {label:34s} {'diff' if diff else 'ovl '} max|d area| "
            f"{da:.3e}  max|d chord| {dc:.3e}  n_cross equal")
        return da

    # (a) the main shapes: the quads' first-step pairs, the stars' pool
    worst = 0.0
    shapes = pallas_shapes(built)
    for label, a, b, diff, n in shapes:
        worst = max(worst, check(label, a, b, diff, n))
        ms, plain, bound, by = time_kernel(f"pallas {label}", a, b, diff,
                                           plain_on=n, pallas=True)
        beside_clip_cu(label, a, b, diff)
        if label == "main-path overlap":
            record.update(ms=ms, plain_ms=plain, bound_ms=bound,
                          bound_by=by)
    del shapes, a, b
    torch.cuda.empty_cache()

    # (a) phase 2's small and degenerate cases, both clips
    small = [c for c in check_shapes()
             if not c[0].startswith(("B=81920", "B=81921", "B=10240",
                                     "B=4096 Vp=64", "coastline"))]
    for label, p_np, q_np in small:
        a, b = on_card(p_np, q_np)
        for diff in (False, True):
            worst = max(worst, check(label, a, b, diff))
    # (a) the nares_export pair: JAX's kernel reports no overlap
    floe_np, coast_np = coastline_pair()
    floe, coast = on_card(floe_np, coast_np)
    check("coastline B=1 Vp=Vq=16", floe, coast, False)
    area = float(kpallas.clip_pallas_cuda(floe, coast, False).area[0])
    fx, fy = floe_np[0, :, 0], floe_np[0, :, 1]
    floe_area = 0.5 * float(np.sum(fx * np.roll(fy, -1) - np.roll(fx, -1) * fy))
    log(f"[pallas] coastline pair: overlap {area} m² (the floe: "
        f"{floe_area} m²; the XLA twin's kernel reports 9.31e8)")
    if not (area == 0.0 or abs(area - floe_area) <= 1e-5 * floe_area):
        raise AssertionError(f"pallas: coastline overlap {area} m²")
    record["max_abs_err"] = worst
    t_a = time.perf_counter()

    # (b) the main path under "pallas"
    total = 0
    for label, st0, fc, cfg in (runs[0], runs[3]):
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, contact_impl="pallas"))
        torch.cuda.reset_peak_memory_stats()
        (other, launches, _), rate, phase, s, aux, most = run_main_path(
            st0, cfg, fc)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = (STEPS + 1) * (1 if cfg.processes.periodic else 2)
        n_col, n_alive = int(aux.n_collisions), int(s.alive.sum())
        log(f'[pallas] {label}, contact_impl="pallas": {rate:.1f} '
            f"floe-steps/s over {STEPS} steps; per step (CUDA events, ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
            + f"; clip_pallas launches {launches} (expected {want}), "
            f"clip.cu launches {other}; peak memory {peak:.2f} GiB; alive "
            f"{n_alive}, collisions last step {n_col}, region_overflow "
            f"{bool(most['region_overflow'])}")
        if launches != want or other:
            raise AssertionError(f"pallas {label}: {launches} clip_pallas "
                                 f"and {other} clip.cu launches")
        for k in ("x", "y", "u", "v", "ksi", "alpha"):
            if not bool(torch.isfinite(getattr(s, k)).all()):
                raise AssertionError(f"pallas {label}: state.{k} not finite")
        if n_col == 0 or n_alive < N_FLOES * 0.9:
            raise AssertionError(f"pallas {label}: implausible end state")
        total += launches
    record["launches"] = total
    t_b = time.perf_counter()

    # (c) CPU against CUDA under "pallas", float64 configuration: float32
    # stats on both devices, the per-edge integrals equal, the Green's sums
    # added in another order (lane groups against torch.sum), so a wall
    # contact (terms of ~2.4e8 m², one ulp 16 m²) differs by up to ~1e-4
    # m/s a step, and the pack compounds it
    polys, vel, lx = lattice(256, seed=1)
    lockstep('256 quads walled, contact_impl="pallas"', polys, vel, lx,
             lattice_config(256, lx, periodic=False, dtype="float64",
                            n_mc=64, window=16,
                            numerics=dict(contact_impl="pallas")), 20,
             tol=(PALLAS_TOL_POS, PALLAS_TOL_VEL))
    log(f"[pallas] phase 2b in {time.perf_counter() - t0:.1f} s: (a) "
        f"{t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, (c) "
        f"{time.perf_counter() - t_b:.1f} s")


def main_path_pairs(state, cfg):
    """The clip inputs of the main path's first step: the floe-floe pairs
    in each floe's frame and the floe-vs-domain pairs, as contact_forces and
    boundary_contact build them."""
    import torch

    from subzero_tpu_torch.dynamics.broadphase import neighbor_candidates
    from subzero_tpu_torch.dynamics.step import domain_polygon

    vw = state.verts_world()
    nbr = neighbor_candidates(state.x, state.y, state.rmax, state.alive,
                              cfg.capacity.max_neighbors, True,
                              cfg.domain.lx, cfg.domain.ly)
    ci = torch.stack([state.x, state.y], dim=-1)
    vj = vw[nbr.idx.long()] + nbr.shift[:, :, None, :] - ci[:, None, None]
    vi = (vw[:, None] - ci[:, None, None]).expand(vj.shape)
    v = vw.shape[1]
    dom = domain_polygon(cfg, device=state.device)
    wall_q = (dom[None].expand(state.n, -1, -1) - ci[:, None]).contiguous()
    return (vi.reshape(-1, v, 2).contiguous(), vj.reshape(-1, v, 2),
            (vw - ci[:, None]).contiguous(), wall_q)


def lockstep(label, polys, vel, lx, cfg, steps, need_regions=False,
             tol=(1e-6, 1e-9)):
    """``steps`` float64 steps of one configuration with ``device="cpu"``
    (plain clip) and ``device="cuda"`` (kernel) from the same numpy inputs:
    positions within ``tol[0]`` m, velocities within ``tol[1]`` m/s, and
    the same collision count, region-pool demand and overflow flags every
    step; one launch of the route's kernel per periodic step, two per
    walled step, on CUDA only (clip.cu under "integral", clip_pallas.cu
    under "pallas", and none of either under ``contact_impl="xla"``, the
    segment-midpoint clip)."""
    import torch

    from subzero_tpu_torch.convert import state_to_numpy, state_from_numpy
    from subzero_tpu_torch.dynamics.step import make_step_fn
    from subzero_tpu_torch.forcing import uniform_forcing
    from subzero_tpu_torch import trace
    from subzero_tpu_torch.state import state_from_polygons

    st0 = state_to_numpy(state_from_polygons(polys, 0.5, cfg,
                                             velocities=vel, device="cpu"))
    runs = {}
    for dev in ("cpu", "cuda"):
        fc = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1, va=5.0,
                             dtype=torch.float64, device=dev)
        step = make_step_fn(cfg, fc, MODULUS, device=dev)
        st = state_from_numpy(st0, device=dev, dtype=torch.float64)
        traj, counts, walls = [], [], 0
        with trace.recording(trace.Table()) as table:
            for i in range(steps):
                st, aux = step(st, i)
                traj.append({k: getattr(st, k).cpu().numpy()
                             for k in ("x", "y", "u", "v", "ksi")})
                counts.append(tuple(int(getattr(aux, k)) for k in (
                    "n_collisions", "region_pool_need", "region_overflow",
                    "pair_pool_need", "pair_pool_overflow")))
                walls += int(aux.boundary_contact.sum())
        runs[dev] = (traj, counts, walls, launch_counts(table))
    (tc, cc, wc, lc), (tg, cg, wg, lg) = runs["cpu"], runs["cuda"]
    periodic = cfg.processes.periodic
    per = steps * (1 if periodic else 2)
    want = {"xla": (0, 0), "pallas": (0, per)}.get(
        cfg.numerics.contact_impl, (per, 0))
    if lc != (0, 0) or lg != want:
        raise AssertionError(f"{label}: (clip.cu, clip_pallas.cu) launches "
                             f"cpu={lc} cuda={lg}, expected (0, 0) and "
                             f"{want}")
    dpos = max(np.max(np.abs(a[k] - b[k])) for a, b in zip(tc, tg)
               for k in ("x", "y"))
    dvel = max(np.max(np.abs(a[k] - b[k])) for a, b in zip(tc, tg)
               for k in ("u", "v", "ksi"))
    ncol = [c[0] for c in cg]
    need = [c[1] for c in cg]
    log(f"[step f64] {label}, {steps} steps: max|d pos| {dpos:.3e} m, "
        f"max|d vel| {dvel:.3e} m/s, collisions/step {ncol} (equal: "
        f"{cc == cg}), region-pool demand/step {need}, wall contacts "
        f"{wc}/{wg}")
    if cc != cg or dpos > tol[0] or dvel > tol[1] or sum(ncol) == 0:
        raise AssertionError(f"{label}: CPU and CUDA steps disagree (or "
                             f"never collided)")
    if not periodic and wg == 0:
        raise AssertionError(f"{label}: no floe touched a wall")
    if need_regions and (max(need) == 0 or any(c[2] or c[4] for c in cg)):
        raise AssertionError(f"{label}: the region decomposition never ran, "
                             f"or a pool overflowed")


def phase_step_parity():
    polys, vel, lx = lattice(256, seed=1)
    lockstep("256 quads walled, aggregate", polys, vel, lx,
             lattice_config(256, lx, periodic=False, dtype="float64",
                            n_mc=64, window=16), 20)
    # a walled cluster of 144 concave stars: the star tips cross the walls,
    # so both the floe-floe and the wall region pools run
    polys, vel, lx = star_lattice(144, seed=2)
    runs = [
        ("144 stars walled, per-region", dict(region_pair_frac=0.25), 20),
        ("144 stars walled, pair pool + per-region",
         dict(region_pair_frac=0.25, pair_pool=True, pair_pool_frac=1.0), 10),
        ("144 stars walled, reclip + edge_mean",
         dict(region_pair_frac=0.25, normal_dir="reclip",
              region_dl="edge_mean"), 10),
    ]
    for label, contact, steps in runs:
        lockstep(label, polys, vel, lx,
                 lattice_config(144, lx, periodic=False, dtype="float64",
                                n_mc=64, window=16, contact=contact),
                 steps, need_regions=True)
    polys, vel, lx = lattice(256, seed=3)
    lockstep("256 quads periodic, cell-list broad phase", polys, vel, lx,
             lattice_config(256, lx, periodic=True, dtype="float64", n_mc=64,
                            window=16, contact={},
                            numerics=dict(broadphase="cells",
                                          cell_size=1.5 * 4000.0),
                            capacity=dict(max_per_cell=8)), 10)


def run_main_path(state, cfg, forcing):
    """Warm-up step + STEPS timed steps; returns ((clip.cu launches,
    clip_pallas.cu launches, broadphase.cu launches), rate, phase ms per
    step, final state, aux, timed-step maxima).  The maxima of the
    pool demands and the OR of the overflow flags over the timed steps are
    gathered on the device and read after the timing."""
    import torch

    from subzero_tpu_torch import trace
    from subzero_tpu_torch.dynamics.step import make_step_fn

    step = make_step_fn(cfg, forcing, MODULUS)
    marks = []

    def timer(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    keys = ("region_pool_need", "region_overflow", "pair_pool_need",
            "pair_pool_overflow", "nbr_overflow")
    with trace.recording(trace.Table()) as table:
        s, aux = step(state, 0)
        torch.cuda.synchronize()
        marks.clear()
        most = None
        t0 = time.perf_counter()
        for i in range(1, STEPS + 1):
            s, aux = step(s, i, timer=timer)
            vals = [getattr(aux, k).to(torch.int32) for k in keys]
            most = vals if most is None else [torch.maximum(a, b)
                                              for a, b in zip(most, vals)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    phase = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name != "end":
            phase[name] = phase.get(name, 0.0) + a.elapsed_time(b) / STEPS
    most = {k: int(v) for k, v in zip(keys, most)}
    # the dense broad phase launches its kernel once a step, the cell list
    # (run (c)'s grid is wide enough for it) never
    want = 0 if cfg.numerics.broadphase == "cells" else STEPS + 1
    if bp_launches(table) != want:
        raise AssertionError(f"{bp_launches(table)} broad-phase kernel "
                             f"launches in {STEPS + 1} steps, expected "
                             f"{want}")
    return ((*launch_counts(table), bp_launches(table)),
            state.n * STEPS / wall, phase, s, aux, most)


def captured_clip_inputs(call):
    """The (p, q) of every overlap clip that ``call()`` makes through the
    contact module (the active-pair pool's gathered batch, for one)."""
    from subzero_tpu_torch.dynamics import contact as tcontact

    saved = tcontact.overlap_stats
    got = []

    def overlap(p, q):
        got.append((p.contiguous(), q.contiguous()))
        return saved(p, q)

    tcontact.overlap_stats = overlap
    try:
        call()
    finally:
        tcontact.overlap_stats = saved
    return got


def main_path_runs():
    """The phase-4 runs, ``[(label, state, forcing, cfg)]``, and the star
    lattice's ``(state, per-region cfg, active-pair pool cfg, lx)``.  The
    stars' pools are sized by a probe step at generous fractions, as
    bench.py's measure_concave sizes the region pool: 1.25 x demand + 1,
    rounded up to a multiple of 128."""
    import torch

    from subzero_tpu_torch.dynamics.step import make_step_fn
    from subzero_tpu_torch.forcing import uniform_forcing
    from subzero_tpu_torch.state import state_from_polygons

    t0 = time.perf_counter()
    polys, vel, lx = lattice(N_FLOES)
    quads = state_from_polygons(polys, 0.5, lattice_config(
        N_FLOES, lx, periodic=True, dtype="float32"), velocities=vel)
    forcing = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1)
    torch.cuda.synchronize()
    log(f"[main] built {N_FLOES} quads in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    spolys, svel, slx = star_lattice(N_FLOES)
    p_slots = N_FLOES * 8

    def star_config(**contact):
        return lattice_config(N_FLOES, slx, periodic=True, dtype="float32",
                              contact=contact)

    stars = state_from_polygons(spolys, 0.5, star_config(), velocities=svel)
    sforcing = uniform_forcing(lx=4 * slx, dx=slx / 8, uo=0.1)
    _, aux = make_step_fn(star_config(region_pair_frac=0.25, pair_pool=True,
                                      pair_pool_frac=1.0),
                          sforcing, MODULUS)(stars, 0)
    need, p_need = int(aux.region_pool_need), int(aux.pair_pool_need)
    slots, p_pool = (max(128, -(-int(d * 1.25 + 1) // 128) * 128)
                     for d in (need, p_need))
    cfg_s = star_config(region_pair_frac=slots / p_slots)
    cfg_pool = star_config(region_pair_frac=slots / p_slots, pair_pool=True,
                           pair_pool_frac=p_pool / p_slots)
    torch.cuda.synchronize()
    log(f"[main] built {N_FLOES} concave stars in "
        f"{time.perf_counter() - t0:.3f} s; probe step: region-pool demand "
        f"{need} -> {slots} slots, active-pair demand {p_need} -> {p_pool} "
        f"slots")

    def quad_config(periodic, **kw):
        return lattice_config(N_FLOES, lx, periodic=periodic,
                              dtype="float32", **kw)

    runs = [
        ("aggregate periodic", quads, forcing, quad_config(True)),
        ("aggregate walled", quads, forcing, quad_config(False)),
        ("(a) default periodic", quads, forcing,
         quad_config(True, contact={})),
        ("(a) default walled", quads, forcing,
         quad_config(False, contact={})),
        ("(b) stars periodic", stars, sforcing, cfg_s),
        ("stars periodic, aggregate", stars, sforcing, star_config(
            per_region=False)),
        ("(c) cells periodic", quads, forcing, quad_config(
            True, contact={},
            numerics=dict(broadphase="cells", cell_size=1.5 * 4000.0),
            capacity=dict(max_per_cell=8))),
    ]
    return runs, (stars, cfg_s, cfg_pool, slx)


def phase_main_path(kernel_record, built, bp_record):
    import torch

    from subzero_tpu_torch.dynamics import contact as tcontact
    from subzero_tpu_torch.dynamics.broadphase import neighbor_candidates
    from subzero_tpu_torch.dynamics.step import domain_polygon
    from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
    from subzero_tpu_torch.kernels import clip as kclip

    runs, (stars, cfg_s, cfg_pool, slx) = built

    # The kernel at the main path's own inputs (the quads' first-step
    # pairs), against the plain version on the same tensors, and timed.
    _, quads, _, cfg_p = runs[0]
    p, q, fw, wq = main_path_pairs(quads, cfg_p)
    for name, (a, b, diff) in (("overlap", (p, q, False)),
                               ("wall difference", (fw, wq, True))):
        got = kclip.clip_stats_cuda(a, b, diff)
        want = clip_integral_bm(a, b, diff)
        da, dc = compare(got, want, torch.float32, f"main-path {name}")
        log(f"[kernel] main-path {name}: max|d area| {da:.3e}  "
            f"max|d chord| {dc:.3e}  n_cross equal")
        ms, plain, bound, by = time_kernel(f"main-path {name}", a, b, diff)
        if not diff:
            kernel_record.update(max_abs_err=da, ms=ms, plain_ms=plain,
                                 bound_ms=bound, bound_by=by)
    del p, q, fw, wq

    # The kernel at the active-pair pool's gathered batch of the stars'
    # first step, against the plain version, and timed.
    vw = stars.verts_world()
    nbr = neighbor_candidates(stars.x, stars.y, stars.rmax, stars.alive,
                              8, True, slx, slx)
    dom = domain_polygon(cfg_pool, device=stars.device)
    (a, b), = captured_clip_inputs(lambda: tcontact.contact_forces(
        vw, stars.x, stars.y, stars.u, stars.v, stars.ksi, stars.h,
        stars.area, nbr, MODULUS, cfg_pool, nv=stars.nv, domain_verts=dom))
    got = kclip.clip_stats_cuda(a, b, False)
    want = clip_integral_bm(a, b, False)
    da, dc = compare(got, want, torch.float32, "pair-pool batch")
    log(f"[kernel] pair-pool batch B={a.shape[0]} (stars): max|d area| "
        f"{da:.3e}  max|d chord| {dc:.3e}  n_cross equal")
    time_kernel("pair-pool batch", a, b, False)
    kernel_record["max_abs_err"] = max(kernel_record["max_abs_err"], da)
    del a, b, got, want, vw, nbr
    torch.cuda.empty_cache()

    total = 0
    results = {}
    for label, st0, fc, cfg in runs:
        periodic = cfg.processes.periodic
        torch.cuda.reset_peak_memory_stats()
        (launches, other, bp_n), rate, phase, s, aux, most = run_main_path(
            st0, cfg, fc)
        want = (STEPS + 1) * (1 if periodic else 2)
        pools = (region_pool_slots(cfg) if cfg.contact.per_region
                 else "off")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[label] = (rate, phase, peak, int(s.alive.sum()))
        log(f"[main] {label}: {rate:.1f} floe-steps/s over {STEPS} steps; "
            f"per step (CUDA events, ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
            + f"; clip launches {launches} (expected {want}); "
            f"peak memory {peak:.2f} "
            f"GiB; region pool slots (floe, wall) {pools}, "
            f"max region_pool_need {most['region_pool_need']}, "
            f"region_overflow {bool(most['region_overflow'])}")
        if launches != want or other:
            raise AssertionError(f"{label}: {launches} clip launches, "
                                 f"expected {want}, and {other} of "
                                 f"clip_pallas.cu, expected 0")
        for k in ("x", "y", "u", "v", "ksi", "alpha"):
            t = getattr(s, k)
            if t.shape != (cfg.capacity.max_floes,) or \
                    not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label}: state.{k} not finite")
        n_alive = int(s.alive.sum())
        n_col = int(aux.n_collisions)
        log(f"[main] {label}: alive {n_alive}, collisions last step "
            f"{n_col}, broad-phase overflow {bool(most['nbr_overflow'])}")
        if n_col == 0 or n_alive < N_FLOES * 0.9:
            raise AssertionError(f"{label}: implausible end state")
        if label.startswith("(b)"):
            if most["region_overflow"] or most["region_pool_need"] == 0:
                raise AssertionError(f"{label}: the region pool overflowed "
                                     f"or never ran (aggregate fallback)")
            stars_end = s
        total += launches
        bp_record["launches"] += bp_n
    kernel_record["launches"] = total
    phase_sync_check(stars_end, cfg_s, cfg_pool, slx)
    return runs, results


def phase_sync_check(state, cfg_region, cfg_pool, lx):
    """contact_forces and boundary_contact, per-region and with the
    active-pair pool, on the star run's end state, under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    import torch

    from subzero_tpu_torch.dynamics import contact as tcontact
    from subzero_tpu_torch.dynamics.broadphase import neighbor_candidates
    from subzero_tpu_torch.dynamics.step import domain_polygon

    vw = state.verts_world()
    nbr = neighbor_candidates(state.x, state.y, state.rmax, state.alive,
                              8, True, lx, lx)
    dom = domain_polygon(cfg_region, device=state.device)

    def calls(cfg):
        pc = tcontact.contact_forces(
            vw, state.x, state.y, state.u, state.v, state.ksi, state.h,
            state.area, nbr, MODULUS, cfg, nv=state.nv, domain_verts=dom)
        bc = tcontact.boundary_contact(
            vw, state.x, state.y, state.u, state.v, state.ksi, state.h,
            state.area, state.alive, dom, MODULUS, cfg, nv=state.nv)
        return pc, bc

    for name, cfg in (("per-region", cfg_region), ("pair pool", cfg_pool)):
        calls(cfg)                       # first use: allocator, lazy init
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pc, bc = calls(cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        log(f"[sync] contact_forces + boundary_contact, {name}: no host "
            f"sync (region need {int(pc.region_need)} + "
            f"{int(bc.region_need)}, pair-pool need "
            f"{int(pc.pair_pool_need)})")


# ---------------------------------------------------------------------------
# phases 5 and 6: the Simulation driver (lifecycle, diagnostics, output)
# ---------------------------------------------------------------------------

SIM_TOL_POS = 1e-6       # m
SIM_TOL_VEL = 1e-9       # m/s (light floes: the same bound on momentum)


def boundary_gap(p, q):
    """Largest distance (m) from a vertex of either contour to the other
    contour's boundary: 0 for the same region, whatever collinear or
    near-duplicate points either vertex list carries and wherever it
    starts."""
    def one(a, b):
        d = np.roll(b, -1, axis=0) - b
        len2 = np.maximum(np.sum(d * d, axis=1), 1e-300)
        t = np.clip(np.sum((a[:, None] - b[None]) * d[None], axis=-1) / len2,
                    0.0, 1.0)
        near = b[None] + t[..., None] * d[None]
        return float(np.max(np.min(np.hypot(*(a[:, None] - near).T), axis=0)))

    return max(one(p, q), one(q, p))


def compare_edits(ea, eb, where):
    """"same" when two boundaries' StateEdits agree vertex for vertex
    (polygons within 1e-6 m; masses, updates and dissolved masses within
    1e-9 relative); "same polygons" when a polygon's vertex list differs
    but it bounds the same region (every vertex within 1e-6 m of the other
    contour) — the native boolean keeps or drops split points on coincident
    edges, and places the crossing of nearly parallel edges, by the inputs'
    last bits; raises otherwise."""
    def close(a, b):
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b), 1.0)

    ok = (ea.kills == eb.kills and ea.dissolve_kills == eb.dissolve_kills
          and ea.updates.keys() == eb.updates.keys()
          and ea.reshapes.keys() == eb.reshapes.keys()
          and len(ea.new_floes) == len(eb.new_floes)
          and close(ea.export_mass, eb.export_mass)
          and len(ea.dissolve_mass) == len(eb.dissolve_mass))
    ok = ok and all(close(v, eb.updates[s][k]) for s in ea.updates
                    for k, v in ea.updates[s].items())
    ok = ok and all(close(a[2], b[2]) for a, b in zip(
        sorted(ea.dissolve_mass, key=lambda r: r[2]),
        sorted(eb.dissolve_mass, key=lambda r: r[2])))
    pairs = [(f.poly, g.poly, f.mass, g.mass)
             for f, g in zip(ea.new_floes, eb.new_floes)]
    pairs += [(ea.reshapes[s][0], eb.reshapes[s][0], ea.reshapes[s][1],
               eb.reshapes[s][1]) for s in ea.reshapes if ok]
    verdict = "same"
    for p, q, m, w in pairs if ok else ():
        p, q = np.asarray(p), np.asarray(q)
        if (m is None) != (w is None) or (m is not None and not close(m, w)):
            ok = False
        if p.shape != q.shape or float(np.max(np.abs(p - q))) >= 1e-6:
            verdict = "same polygons"
            ok = ok and boundary_gap(p, q) < 1e-6
    if not ok:
        raise AssertionError(f"{where}: the lifecycle edits differ")
    return verdict


def copy_run_state(dst, src):
    """Set the Simulation ``dst`` (on its own device) to ``src``'s run
    state: config, floe state, step, dissolved grid, lifecycle RNG and
    ledgers, and every name of the driver's run state
    (``sim.run_state_defaults``), tensors moved to ``dst``'s device."""
    import copy

    import torch

    from subzero_tpu_torch.convert import state_from_numpy, state_to_numpy
    from subzero_tpu_torch.sim import run_state_defaults

    dev = dst.state.device
    dst.cfg = src.cfg
    dst.state = state_from_numpy(state_to_numpy(src.state), device=dev,
                                 dtype=str(src.state.x.dtype)[6:])
    dst.step_idx = src.step_idx
    dst.dissolved = np.array(src.dissolved)
    dst.__post_init__()
    if dst.mesh is not None:
        # keep src's slot layout (the rebuild rebalanced the slabs)
        dst.state = state_from_numpy(state_to_numpy(src.state), device=dev,
                                     dtype=str(src.state.x.dtype)[6:])
    dst._chunk_frozen = True
    for k in ("amax", "exported_mass", "last_birth_nv"):
        setattr(dst.lifecycle, k, getattr(src.lifecycle, k))
    dst.lifecycle.rng.bit_generator.state = \
        src.lifecycle.rng.bit_generator.state

    def moved(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if hasattr(v, "_asdict"):           # the AVERAGE accumulator
            return type(v)(*(t.to(dev) for t in v))
        return copy.deepcopy(v)

    for k in run_state_defaults():
        setattr(dst, k, moved(getattr(src, k)))
    torch.cuda.synchronize()


def snapshot(state):
    """The fields the lockstep compares, as numpy arrays."""
    return {k: getattr(state, k).cpu().numpy()
            for k in ("x", "y", "u", "v", "ksi", "mass", "alive", "nv")}


def run_deltas(sa, sb, step, keep=None):
    """(max |d position|, max |d velocity|) of two snapshots over the slots
    in ``keep`` (all by default), velocity deltas of floes lighter than the
    median live floe scaled by their mass share; raises if alive or nv
    differ there."""
    keep = np.ones(sa["x"].shape, bool) if keep is None else keep
    if not (np.array_equal(sa["alive"][keep], sb["alive"][keep])
            and np.array_equal(sa["nv"][keep], sb["nv"][keep])):
        raise AssertionError(f"step {step}: alive/nv differ")
    w = np.minimum(1.0, sa["mass"] / np.median(sa["mass"][sa["alive"]]))
    dpos = max(float(np.max(np.abs(sa[k] - sb[k])[keep]))
               for k in ("x", "y"))
    dvel = max(float(np.max((np.abs(sa[k] - sb[k]) * w)[keep]))
               for k in ("u", "v", "ksi"))
    return dpos, dvel


def ledger(sim):
    """floes + dissolved + exported mass of a Simulation, kg."""
    return (sim.total_mass() + float(np.sum(sim.dissolved))
            + sim.lifecycle.exported_mass)


def sim_lockstep(label, build, steps, save_at=None, check_ledger=False):
    """``steps`` float64 steps of one validation Simulation on the CPU
    (plain clip) and on CUDA (kernel), one chunk at a time: each chunk
    starts the CUDA run from the CPU run's state, config and lifecycle RNG,
    and both must end it with positions within SIM_TOL_POS, velocities
    within SIM_TOL_VEL and identical alive and nv, both just before the
    boundary's edits and after them, the same lifecycle edits
    (``compare_edits``), and the same dissolved grid and ledger within
    1e-9.  Where the edits are the same polygons in other vertex lists, the
    slots they wrote are left out after the boundary: vertex capping and
    simplification act on the lists.  Chunk by chunk, because the packs amplify
    rounding: in the JAX package alone a 1e-8 m nudge to one floe grows to
    1.3e-6 m and 4.9e-8 m/s in 300 out-of-box steps.  ``save_at``: save the
    CUDA run there, load it into a new Simulation (state equal field by
    field) and hold one chunk of each to the tolerances.  Returns the CUDA
    run's lifecycle pass times."""
    import tempfile

    import torch

    import subzero_tpu_torch.processes.lifecycle as tlc
    from subzero_tpu_torch.convert import state_to_numpy
    from subzero_tpu_torch.sim import Simulation

    logs = {"cpu": [], "cuda": [], "checkpoint": []}
    running = ["cpu"]
    orig = tlc.apply_edits

    def logged(state, edit, cfg, seed=0, view=None):
        logs[running[0]].append((edit, snapshot(state)))
        return orig(state, edit, cfg, seed=seed, view=view)

    tlc.apply_edits = logged
    try:
        cpu, gpu = build("cpu"), build("cuda")
        m0 = ledger(cpu)
        worst = [0.0, 0.0, 0.0]
        verdicts, t_cpu, t_gpu = [], 0.0, 0.0
        while cpu.step_idx < steps:
            copy_run_state(gpu, cpu)
            n = min(cpu._chunk, steps - cpu.step_idx)
            t0 = time.perf_counter()
            running[0] = "cpu"
            cpu.run(n)
            t_cpu += time.perf_counter() - t0
            t0 = time.perf_counter()
            running[0] = "cuda"
            gpu.run(n)
            torch.cuda.synchronize()
            t_gpu += time.perf_counter() - t0
            if len(logs["cpu"]) != len(logs["cuda"]):
                raise AssertionError(f"{label} step {cpu.step_idx}: a "
                                     f"lifecycle boundary ran on one device")
            keep = None
            checks = []
            if len(logs["cpu"]) > len(verdicts):
                # the chunk's physics, up to the boundary's edits
                (ea, pre), (eb, pre_b) = logs["cpu"][-1], logs["cuda"][-1]
                checks.append(run_deltas(pre, pre_b, cpu.step_idx))
                verdict = compare_edits(ea, eb,
                                        f"{label} step {cpu.step_idx}")
                verdicts.append(verdict)
                if verdict != "same":
                    # the same polygons in other vertex lists: capping
                    # (_cap_vertices) and simplification act on the lists,
                    # so the slots the edits wrote may differ; hold the rest
                    born = snapshot(cpu.state)["alive"].copy()
                    born[:len(pre["alive"])] &= ~pre["alive"]  # may grow
                    keep = ~born
                    keep[list(ea.kills | ea.dissolve_kills
                              | set(ea.reshapes))] = False
            checks.append(run_deltas(snapshot(cpu.state),
                                     snapshot(gpu.state), cpu.step_idx,
                                     keep))
            dpos = max(c[0] for c in checks)
            dvel = max(c[1] for c in checks)
            dled = abs(ledger(cpu) - ledger(gpu)) / m0
            worst = [max(worst[0], dpos), max(worst[1], dvel),
                     max(worst[2], dled)]
            if dpos > SIM_TOL_POS or dvel > SIM_TOL_VEL or dled > 1e-9:
                raise AssertionError(
                    f"{label} step {cpu.step_idx}: CPU and CUDA runs differ "
                    f"(d pos {dpos:.3e} m, d vel {dvel:.3e} m/s, d ledger "
                    f"{dled:.3e})")
            if check_ledger:
                drift = abs(ledger(cpu) - m0) / m0
                if drift > 1e-9:
                    raise AssertionError(f"{label} step {cpu.step_idx}: "
                                         f"ledger drift {drift:.3e}")
            if cpu.step_idx == save_at:
                with tempfile.TemporaryDirectory() as d:
                    gpu.save(d)
                    loaded = Simulation.load(d, gpu.cfg, gpu.forcing,
                                             device="cuda")
                a, b = state_to_numpy(gpu.state), state_to_numpy(
                    loaded.state)
                if any(not np.array_equal(a[k], b[k]) for k in a):
                    raise AssertionError(f"{label}: a loaded checkpoint "
                                         f"differs from the saved state")
                running[0] = "checkpoint"
                gpu.run(cpu._chunk)
                loaded.run(cpu._chunk)
                dp, dv = run_deltas(snapshot(gpu.state),
                                    snapshot(loaded.state), gpu.step_idx)
                if dp > SIM_TOL_POS or dv > SIM_TOL_VEL:
                    raise AssertionError(f"{label}: the run resumed at step "
                                         f"{save_at} differs from the "
                                         f"straight run")
                log(f"[sim5] {label}: CUDA checkpoint at step {save_at} "
                    f"reloads equal field by field; one chunk on: d pos "
                    f"{dp:.3e} m, d vel {dv:.3e} m/s")
        # the Eulerian fields of one state on both devices (the boundary
        # union, the floe x cell clip: kernel against plain)
        copy_run_state(gpu, cpu)
        ea, eb = cpu.eulerian(), gpu.eulerian()
        for k in ea._fields:
            a, b = getattr(ea, k).numpy(), getattr(eb, k).cpu().numpy()
            if np.max(np.abs(a - b)) > 1e-9 * max(np.max(np.abs(a)), 1e-300):
                raise AssertionError(f"{label}: Eulerian {k} differs")
    finally:
        tlc.apply_edits = orig
    n_alive = int(gpu.state.alive.sum())
    log(f"[sim5] {label}: {steps} steps in {len(verdicts)} lifecycle "
        f"boundaries ({verdicts.count('same polygons')} with the same "
        f"polygons in other vertex lists); max d pos {worst[0]:.3e} m, max d vel "
        f"{worst[1]:.3e} m/s, max d ledger {worst[2]:.3e}; alive {n_alive}; "
        f"CPU {t_cpu:.1f} s, CUDA {t_gpu:.1f} s; passes "
        f"{sorted(getattr(gpu.lifecycle, 'pass_times', {}))}")
    return dict(getattr(gpu.lifecycle, "pass_times", {}))


def phase_sim_parity():
    """Phase 5: the validation runs, CPU against CUDA in float64."""

    import subzero_tpu_torch.validation as tval
    from subzero_tpu_torch.sim import out_of_box_sim

    def winter(dev):
        sim = tval.winter_sim(device=dev, dtype="float64")
        sim.cfg = sim.cfg.replace(processes=dataclasses.replace(
            sim.cfg.processes, n_pack=50, average=True,
            advect_dissolved=True))
        return sim

    # Depths cut to keep the script inside its time limit: the CPU side of
    # this phase took 926 s at 1000/210/150/150 steps on the H100's host.
    # The 1000-step mass ledger stays in tests/test_torch_diagnostics.py;
    # fracture runs in the winter run (75); merges first fire at step 105
    # of the winter run, so it keeps 110 steps.
    fired = set()
    fired |= set(sim_lockstep(
        "out_of_box_sim", lambda d: out_of_box_sim(device=d,
                                                   dtype="float64"),
        200, save_at=100, check_ledger=True))
    fired |= set(sim_lockstep(
        "uniaxial_sim", lambda d: tval.uniaxial_sim(device=d,
                                                    dtype="float64"), 70))
    fired |= set(sim_lockstep(
        "nares_sim(full_basin=True)",
        lambda d: tval.nares_sim(full_basin=True, device=d,
                                 dtype="float64"), 60))
    fired |= set(sim_lockstep("winter_sim(n_pack=50, average, advect)",
                              winter, 110))
    passes = ("merges", "ridge", "raft", "fracture", "corners", "weld",
              "simplify", "pack")
    missing = [p for p in passes if p not in fired]
    log(f"[sim5] lifecycle passes that ran on CUDA: {sorted(fired)}")
    if missing:
        raise AssertionError(f"lifecycle passes never ran: {missing}")


N_BIG = 10000             # phase 6: Voronoi floes of the scaled winter pack
# Cut from the 150 steps after 10 of the first design: the host passes at
# 10,000 floes take ~4.4 s a step (663 s for 150 steps on the H100's host),
# past the script's time limit.  The cadence clock starts at step 60, so
# the 30 timed steps (71-100) hold fracture and weld (75), simplify (80,
# 100), weld (100) and corners, ridge and raft every 10 steps.
BIG_START = 60
BIG_WARMUP = 10
BIG_STEPS = 30
EUL_REPS = 5              # timed Eulerian calls on the end state


def big_winter(seed=0):
    """The winter configuration (all processes, periodic, freezing) scaled
    in domain, not in floe size: lx = ly = 1e6 m and ~10,000 Voronoi floes
    (the ~20 km floes of the 100-floe published case), built on a 25x25
    target-concentration grid so bounded_voronoi stays cheap.  The minimum
    floe sizes keep the published case's absolute values (Voronoi cull
    4e6 m^2, cfg.min_floe_size 2e6 m^2).  Capacity as winter_sim sets it
    (2x floes, 64 vertices, K 12, 400 Monte-Carlo points, stress window
    1000), the gyre ocean scaled with the domain (its grid and transport
    x10: the same currents over a 10x larger box), AVERAGE on a 40x40 grid,
    the shadow ledger on; float32 on CUDA."""
    from subzero_tpu_torch.config import (
        CapacityConfig, DomainConfig, NumericsConfig, PhysicsConfig,
        ProcessConfig, SimConfig,
    )
    from subzero_tpu_torch.forcing import gyre_ocean, thermo_params
    from subzero_tpu_torch.init import default_modulus, voronoi_floe_field
    from subzero_tpu_torch.sim import Simulation
    from subzero_tpu_torch.state import state_from_polygons

    cfg = SimConfig(
        physics=PhysicsConfig(mu_friction=0.3),
        processes=ProcessConfig(
            collision=True, fractures=True, corners=True, welding=True,
            ridging=True, rafting=True, packing=True, periodic=True,
            keep_min=True, n_pack=5500, average=True),
        numerics=NumericsConfig(dt=10.0),
        domain=DomainConfig(lx=1e6, ly=1e6),
        capacity=CapacityConfig(max_floes=2 * N_BIG, max_verts=64,
                                max_neighbors=12, n_mc_points=400,
                                stress_window=1000),
    )
    polys, heights = voronoi_floe_field(
        cfg, np.ones((25, 25)), N_BIG, height_mean=0.25, height_delta=0.0,
        min_floe_size=4e6, seed=seed)
    st = state_from_polygons(polys, heights, cfg, seed=seed)
    modulus = default_modulus(st.area[: len(polys)].cpu().numpy())
    heat_flux, _ = thermo_params(cfg.numerics.dt, cfg.processes.n_pack)
    cfg = cfg.replace(min_floe_size=2e6, heat_flux=heat_flux)
    sim = Simulation(cfg=cfg, state=st,
                     forcing=gyre_ocean(lx=4e6, dx=1e5, transport=5e4),
                     modulus=modulus, heat_flux=heat_flux, seed=seed,
                     nx_coarse=40, ny_coarse=40, step_idx=BIG_START)
    sim.lifecycle.shadow_ledger = True
    return sim, len(polys)


def phase_big_run(kernel_record, bp_record, mc_record):
    """Phase 6: the scaled winter pack through ``Simulation.run`` in
    float32 on CUDA — the port's main path at full size."""
    import torch

    from subzero_tpu_torch.dynamics.step import make_step_fn
    from subzero_tpu_torch import trace
    from subzero_tpu_torch.kernels import clip as kclip
    from subzero_tpu_torch.sim import Simulation

    t0 = time.perf_counter()
    sim, n_polys = big_winter()
    torch.cuda.synchronize()
    log(f"[big] built the scaled winter pack: {n_polys} Voronoi floes in "
        f"{N_BIG * 2} slots in {time.perf_counter() - t0:.1f} s")
    overflowed = []
    orig = Simulation._grow_pools

    def watched(self, s):
        grew = orig(self, s)
        if not grew and (s.region_overflow or s.nbr_overflow
                         or s.pair_pool_overflow):
            overflowed.append(self.step_idx)   # committed with an overflow
        return grew

    # The reference's known leak (ROADMAP §C): a ridge or raft winner's
    # gained mass is an update, and a later pass of the same boundary that
    # kills or reshapes the winner works from its pre-update mass.  Each
    # boundary's shadow-ledger drift minus that loss must stay below 1e-6
    # of the live mass.
    import subzero_tpu_torch.processes.lifecycle as tlc

    boundaries = []
    orig_apply, orig_step = tlc.apply_edits, tlc.Lifecycle.step

    def leak_of(state, edit, cfg, seed=0, view=None):
        cut = edit.kills | edit.dissolve_kills | set(edit.reshapes)
        boundaries[-1]["leak"] = sum(
            kv["mass"] - float(view.mass[s]) for s, kv in edit.updates.items()
            if s in cut and "mass" in kv)
        return orig_apply(state, edit, cfg, seed=seed, view=view)

    def step_drift(self, *a, **k):
        boundaries.append({"leak": 0.0, "before": self.ledger_drift})
        out = orig_step(self, *a, **k)
        boundaries[-1]["drift"] = self.ledger_drift - boundaries[-1]["before"]
        return out

    Simulation._grow_pools = watched
    tlc.apply_edits, tlc.Lifecycle.step = leak_of, step_drift
    try:
        sim.run(BIG_WARMUP)
        torch.cuda.synchronize()
        alive0 = int(sim.state.alive.sum())
        mass0 = sim.total_mass()
        sim.phase_times.clear()
        sim.lifecycle.pass_times.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim.run(BIG_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sim_launches(sim)
        bp_steps = bp_launches(sim.phase_times)
        mc_calls = sim.lifecycle.pass_times.counts.get("mc_mask.launches", 0)
    finally:
        Simulation._grow_pools = orig
        tlc.apply_edits, tlc.Lifecycle.step = orig_apply, orig_step
    alive1 = int(sim.state.alive.sum())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = sim.state.n * BIG_STEPS / wall
    live_rate = alive0 * BIG_STEPS / wall
    log(f"[big] Simulation.run: {BIG_STEPS} steps (from step "
        f"{BIG_START + BIG_WARMUP}) in {wall:.2f} s after "
        f"{BIG_WARMUP} warm-up steps: {rate:.1f} floe-steps/s over "
        f"{sim.state.n} slots ({live_rate:.1f} over the {alive0} live "
        f"floes); live floes {alive0} -> {alive1}; peak memory {peak:.2f} "
        f"GiB; clip launches {launches}; broad-phase kernel launches "
        f"{bp_steps}; Monte-Carlo mask kernel launches {mc_calls}; chunk "
        f"{sim._chunk} steps")
    if bp_steps < BIG_STEPS:
        raise AssertionError(f"phase 6: {bp_steps} broad-phase kernel "
                             f"launches in {BIG_STEPS} steps")
    if not mc_calls:
        raise AssertionError("phase 6: the births never launched the "
                             "Monte-Carlo mask kernel")
    bp_record["launches"] += bp_steps
    mc_record["launches"] += mc_calls
    for line in sim.phase_report().splitlines():
        log(f"[big] {line}")
    lc = sim.lifecycle
    unexplained = max((abs(b["drift"] + b["leak"]) for b in boundaries
                       if "drift" in b), default=0.0)
    leak = sum(b["leak"] for b in boundaries)
    log(f"[big] shadow ledger: drift max {lc.ledger_drift_max:+.6e} kg "
        f"({lc.ledger_drift_max / mass0:+.3e} of the live mass), summed "
        f"{lc.ledger_drift:+.6e} kg over {len(boundaries)} boundaries, of "
        f"which the reference's updated-winner leak explains "
        f"{-leak:+.6e} kg; largest unexplained drift of a boundary "
        f"{unexplained:.6e} kg ({unexplained / mass0:.3e}); pools K "
        f"{sim.cfg.capacity.max_neighbors}, region_pair_frac "
        f"{sim.cfg.contact.region_pair_frac:.4g}, vertex rung "
        f"{sim.state.v_cap}; committed chunks with an overflow: "
        f"{overflowed}")
    # the bare physics step on the same state, no driver around it
    step = make_step_fn(sim.cfg, sim.forcing, sim.modulus, sim.heat_flux)
    st = sim.state
    st, _ = step(st, sim.step_idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, 21):
        st, _ = step(st, sim.step_idx + i)
    torch.cuda.synchronize()
    bare = sim.state.n * 20 / (time.perf_counter() - t0)
    log(f"[big] bare make_step_fn step on the same state: {bare:.1f} "
        f"floe-steps/s over {sim.state.n} slots (20 steps)")
    # the Eulerian calls: the segment-midpoint clip in plain PyTorch (JAX's
    # _overlap_one), no kernel launch.  Both timed, the driver's per-step
    # AVERAGE call (world frame, as JAX's traced path) and the output call
    # (floe frame); then the kernel held against its plain version on the
    # output call's floe x cell pairs
    from subzero_tpu_torch import diagnostics as tdiag
    from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm

    win = tdiag.cell_window(sim.state, sim.cfg, sim.nx_coarse, sim.ny_coarse)
    calls = {
        "AVERAGE per-step": lambda: tdiag.eulerian_data(
            sim.state, sim.cfg, sim.nx_coarse, sim.ny_coarse, window=win,
            exact_boundary=False),
        "output": sim.eulerian,
    }
    captured = []
    saved = tdiag.overlap_stats

    def capture(p, q):
        captured.append((p.contiguous(), q.contiguous()))
        return saved(p, q)

    tdiag.overlap_stats = capture
    try:
        with trace.recording(trace.Table()) as table:
            for call in calls.values():
                call()
        torch.cuda.synchronize()
        per_call = launch_counts(table)[0]
    finally:
        tdiag.overlap_stats = saved
    eul_ms = {}
    for label, call in calls.items():
        t0 = time.perf_counter()
        for _ in range(EUL_REPS):
            call()
        torch.cuda.synchronize()
        eul_ms[label] = (time.perf_counter() - t0) / EUL_REPS * 1e3
    _, (a, b) = captured
    n = min(a.shape[0], 131072)
    got = kclip.clip_stats_cuda(a, b, False)
    want = clip_integral_bm(a[:n], b[:n], False)
    da, dc = compare(type(got)(*(x[:n] for x in got)), want, torch.float32,
                     "Eulerian floe x cell pairs")
    log(f"[kernel] Eulerian floe x cell B={a.shape[0]} Vp={a.shape[1]} "
        f"Vq={b.shape[1]}: first {n} pairs max|d area| {da:.3e}  max|d "
        f"chord| {dc:.3e}  n_cross equal")
    time_kernel("Eulerian floe x cell", a, b, False,
                plain_on=n if n < a.shape[0] else None)
    log(f"[big] Eulerian calls (segment-midpoint clip on the "
        f"{captured[0][0].shape[0]} and {a.shape[0]} floe x cell pairs whose "
        f"bounding circles meet): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in eul_ms.items())
        + f" a call over {EUL_REPS} calls; clip launches "
        f"{launches / BIG_STEPS:.2f} per step in Simulation.run (the step's "
        f"overlap clip and the lifecycle's), {per_call} in the two "
        f"Eulerian calls")
    if launches < BIG_STEPS or per_call:
        raise AssertionError(f"phase 6: {launches} clip launches in "
                             f"{BIG_STEPS} steps and {per_call} in an "
                             f"Eulerian call: expected one a step and none")
    if unexplained >= 1e-6 * mass0:
        raise AssertionError(f"a boundary's shadow-ledger drift, less the "
                             f"reference's known leak, is {unexplained} kg: "
                             f"1e-6 of the live mass or more")
    fired = set(getattr(lc, "pass_times", {}))
    missing = [p for p in ("corners", "simplify", "weld", "fracture")
               if p not in fired]
    if not fired & {"ridge", "raft"}:
        missing.append("ridge/raft")
    if missing:
        raise AssertionError(f"phase 6: lifecycle passes never ran: "
                             f"{missing}")
    if overflowed:
        raise AssertionError(f"chunks committed with a pool overflow at "
                             f"steps {overflowed}")
    for k in ("x", "y", "u", "v"):
        t = getattr(sim.state, k)[sim.state.alive]
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"phase 6: state.{k} not finite")
    kernel_record["max_abs_err"] = max(kernel_record["max_abs_err"], da)
    kernel_record["launches"] += launches
    return launches


# ---------------------------------------------------------------------------
# phase 7: the single-device remainder (segment-midpoint clip, the "xla"
# contact route, the serial oracle, plotting)
# ---------------------------------------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
SQ1 = np.array([[2, 2], [5, 2], [5, 5], [2, 5]], float) * 1e4
SQ2 = np.array([[6, 2], [9, 2], [9, 5], [6, 5]], float) * 1e4


def complex_floe(n, translate=(0.0, 0.0), max_v=60):
    """conservation_test.m's concave fixture floe poly(n) (FloeShapes.mat,
    extracted to tests/fixtures/), Douglas-Peucker'd under the vertex cap;
    CCW order."""
    from subzero_tpu_torch.processes.simplify import douglas_peucker

    poly = np.load(FIXTURES / f"floeshapes_poly{n}.npy")
    poly = poly[~np.isnan(poly).any(axis=1)]
    tol = 10.0
    simp = douglas_peucker(poly, tol)
    while len(simp) > max_v:
        tol *= 1.5
        simp = douglas_peucker(poly, tol)
    x, y = simp[:, 0], simp[:, 1]
    if np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) < 0:
        simp = simp[::-1]
    return simp + np.asarray(translate)


def golden_modulus(polys):
    """Subzero.m:77 (exactly 9e7 for the two-block scenarios)."""
    from subzero_tpu_torch.oracle import _poly_area

    r = np.array([np.sqrt(_poly_area(np.asarray(p))) for p in polys])
    return float(1.5e3 * (r.mean() + r.min()))


def gyre_floes():
    """The out-of-box golden scenario's floes: ~10 Voronoi floes at 0.4
    concentration (seed 3), those of at most 30 vertices."""
    from subzero_tpu_torch.config import SimConfig
    from subzero_tpu_torch.init import voronoi_floe_field

    polys, _ = voronoi_floe_field(SimConfig(), target_concentration=0.4,
                                  n_floes=10, height_mean=0.25, seed=3)
    return [p for p in polys if len(p) <= 30]


def golden_config(n_floes, max_verts=64, ocean=False, contact=None):
    """The golden scenarios' configuration (float64, walled, corners off)."""
    from subzero_tpu_torch.config import (
        CapacityConfig, ContactConfig, NumericsConfig, PhysicsConfig,
        ProcessConfig, SimConfig,
    )

    return SimConfig(
        physics=PhysicsConfig(ocean_coupling=ocean),
        processes=ProcessConfig(collision=True, corners=False),
        numerics=NumericsConfig(dtype="float64"),
        capacity=CapacityConfig(max_floes=max(8, n_floes), max_neighbors=8,
                                max_verts=max_verts),
        **({} if contact is None else {"contact": ContactConfig(**contact)}))


def golden_lockstep(polys, vels, n_steps, device, check_every=50,
                    max_verts=64, forcing=None, ocean=False, contact=None):
    """The physics step (``make_step_fn`` on ``device``, float64) in lockstep
    with the serial oracle (``subzero_tpu_torch.oracle``), as the golden
    scenarios run them: kinetic energy of the oracle every step, position
    and velocity gaps of the floes the oracle keeps alive every
    ``check_every`` steps.  Returns the gaps, the energy series, both end
    states, the clip kernel's launches and the seconds spent in each."""
    import torch

    from subzero_tpu_torch import trace
    from subzero_tpu_torch.dynamics.step import make_step_fn
    from subzero_tpu_torch.forcing import uniform_forcing
    from subzero_tpu_torch.oracle import (
        floes_from_state, kinetic_energy, oracle_step,
    )
    from subzero_tpu_torch.state import state_from_polygons

    cfg = golden_config(len(polys), max_verts, ocean, contact)
    modulus = golden_modulus(polys)
    st = state_from_polygons(polys, 0.25, cfg, seed=0,
                             velocities=np.asarray(vels), device=device)
    floes = floes_from_state(st, cfg, n=len(polys))
    if forcing is None:
        forcing = uniform_forcing(lx=4e5, dx=1e4, device="cpu")
    step = make_step_fn(cfg, forcing, modulus, device=device)
    sync = torch.cuda.synchronize if st.device.type == "cuda" else (
        lambda: None)

    k_series = [kinetic_energy(floes)]
    max_dx = max_du = t_step = t_oracle = 0.0
    n = len(polys)
    table = trace.Table()
    for s in range(n_steps):
        t0 = time.perf_counter()
        with trace.recording(table):
            st, _ = step(st, s)
        sync()
        t1 = time.perf_counter()
        oracle_step(floes, forcing, cfg, modulus, s)
        t_oracle += time.perf_counter() - t1
        t_step += t1 - t0
        k_series.append(kinetic_energy(floes))
        if s % check_every == check_every - 1 or s == n_steps - 1:
            got = {k: getattr(st, k)[:n].cpu().numpy()
                   for k in ("x", "y", "u", "v")}
            for i, f in enumerate(floes):
                if f.alive:
                    max_dx = max(max_dx, abs(got["x"][i] - f.x),
                                 abs(got["y"][i] - f.y))
                    max_du = max(max_du, abs(got["u"][i] - f.u),
                                 abs(got["v"][i] - f.v))
    launches = launch_counts(table)[0]
    m, u, v, inertia, ksi = (getattr(st, k)[:n].cpu().numpy() for k in (
        "mass", "u", "v", "inertia", "ksi"))
    k_step = float(np.sum(0.5 * m * (u ** 2 + v ** 2)
                          + 0.5 * inertia * ksi ** 2))
    return dict(k=np.array(k_series), k_end_step=k_step, max_dx=max_dx,
                max_du=max_du, state=st, floes=floes, cfg=cfg,
                launches=launches, t_step=t_step, t_oracle=t_oracle)


def assert_dissipation(r, where):
    """conservation_test.m's K(end)/K(1) < 1, and K never above K0, for the
    oracle; K(end)/K(1) < 1 for the step."""
    k = r["k"]
    if not (k[-1] / k[0] < 1.0 and k.max() / k[0] < 1.0 + 1e-9
            and r["k_end_step"] / k[0] < 1.0):
        raise AssertionError(f"{where}: kinetic energy was not dissipated")


def golden_scenarios():
    """(label, polys, velocities, steps, lockstep kwargs, max |d pos| m,
    max |d vel| m/s, energy dissipated) — test_golden.py's head-on blocks,
    complex concave floes with per-region contacts and out-of-box gyre
    scenarios at their check cadences and tolerances.  Depths are
    test_golden.py's but for the head-on blocks, cut from 1,200 steps to
    400 to keep phase 7 near its time budget: they touch at step ~200 and
    part by step 300 (their kinetic energy is the same at 300 and 1,200)."""
    from subzero_tpu_torch.forcing import gyre_ocean

    gyre = gyre_floes()
    return [
        ("head-on blocks", [SQ1, SQ2 - [9.5e3, 0]],
         [[0.15, 0.02], [-0.1, 0.02]], 400, {}, 1e-5, 1e-9, True),
        ("complex concave floes, per-region",
         [complex_floe(5), complex_floe(4, translate=(-1e4 + 1.2e3, -4e4))],
         [[-0.11, 0.02], [0.1, 0.02]], 2600,
         dict(contact=dict(per_region=True, region_cap=16)), 1e-6, 1e-9,
         True),
        ("out-of-box gyre", gyre, np.zeros((len(gyre), 2)), 500,
         dict(check_every=25, max_verts=32, ocean=True,
              forcing=gyre_ocean(lx=4e5, dx=1e4, dtype="float64",
                                 device="cpu")), 0.1, 1e-3, False),
    ]


def phase_clip_midpoint():
    """Phase 7(a): the segment-midpoint clip, CUDA against CPU in float64."""
    import torch

    from subzero_tpu_torch.geometry.clip import overlap_stats
    from subzero_tpu_torch.geometry.clip_batched import (
        difference_stats_bm, overlap_stats_bm,
    )

    cases = [(f"B={b} Vp={vp} Vq={vq}", *random_pairs(b, vp, vq,
                                                      seed=b + vp + vq))
             for b, vp, vq in ((81920, 16, 16), (10240, 16, 8))]
    cases.append(("degenerate B=8 Vp=Vq=16", *degenerate_pairs()))
    # (name, function, the CPU reference it is held to: the vmapped form
    # to the CPU batch-minor overlap, which equals the CPU vmapped one
    # within 1e-12 (tests/test_torch_geometry.py) and saves the slowest
    # CPU call)
    fns = (("overlap_stats_bm", overlap_stats_bm, None),
           ("difference_stats_bm", difference_stats_bm, None),
           ("overlap_stats (vmapped)", overlap_stats, "overlap_stats_bm"))
    for label, p_np, q_np in cases:
        p, q = torch.from_numpy(p_np), torch.from_numpy(q_np)
        pg, qg = p.cuda(), q.cuda()
        cpu = {}
        for name, fn, ref in fns:
            t0 = time.perf_counter()
            want = cpu[name] = cpu[ref] if ref else fn(p, q)
            t_cpu = time.perf_counter() - t0
            ms = cuda_ms(lambda: fn(pg, qg), reps=3, warmup=1)
            got = fn(pg, qg)
            gaps = []
            for k in ("area", "centroid", "chord_p"):
                a, b = getattr(got, k).cpu(), getattr(want, k)
                gap = float((a - b).abs().max())
                gaps.append(gap)
                if gap > 1e-9 * max(float(b.abs().max()), 1.0):
                    raise AssertionError(f"{name} {label}: CUDA and CPU "
                                         f"differ in {k} by {gap}")
            bad = int((got.n_cross.cpu() != want.n_cross).sum())
            if bad:
                raise AssertionError(f"{name} {label}: {bad} n_cross "
                                     f"mismatches")
            log(f"[clip7] {name:24s} {label:24s} f64 CUDA vs CPU"
                + (f" {ref}" if ref else "") + f": max|d area| "
                f"{gaps[0]:.3e}  max|d centroid| {gaps[1]:.3e}  max|d "
                f"chord| {gaps[2]:.3e}  n_cross equal; CUDA {ms:.3f} ms"
                + ("" if ref else f", CPU {t_cpu * 1e3:.1f} ms"))
        del pg, qg
    torch.cuda.empty_cache()


def phase_remainder(runs, results, kernel_record):
    """Phase 7: the single-device remainder of the port on the card."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    phase_clip_midpoint()
    t_a = time.perf_counter()

    # (b) the "xla" route, CPU against CUDA in float64
    polys, vel, lx = lattice(256, seed=1)
    lockstep('256 quads walled, contact_impl="xla"', polys, vel, lx,
             lattice_config(256, lx, periodic=False, dtype="float64",
                            n_mc=64, window=16,
                            numerics=dict(contact_impl="xla")), 20)
    t_b = time.perf_counter()

    # (c) the "xla" route on the aggregate periodic quad lattice, float32
    label, quads, forcing, cfg = runs[0]
    cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                   contact_impl="xla"))
    torch.cuda.reset_peak_memory_stats()
    (launches, other, _), rate, phase, s, aux, _ = run_main_path(
        quads, cfg, forcing)
    launches += other
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r_int, p_int, m_int, _ = results[label]
    log(f'[xla] {label}, contact_impl="xla": {rate:.1f} floe-steps/s over '
        f"{STEPS} steps; per step (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
        + f"; peak memory {peak:.2f} GiB; clip launches {launches}")
    log(f'[xla] {label}, contact_impl="integral" (phase 4): {r_int:.1f} '
        f"floe-steps/s; per step (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in p_int.items())
        + f"; peak memory {m_int:.2f} GiB")
    if launches != 0:
        raise AssertionError(f'contact_impl="xla" launched the clip kernel '
                             f"{launches} times")
    if int(aux.n_collisions) == 0 or not bool(torch.isfinite(s.x).all()):
        raise AssertionError('contact_impl="xla": implausible end state')
    t_c = time.perf_counter()

    # (d) the CUDA step (clip kernel) in lockstep with the serial oracle
    total = 0
    end = None
    for label, polys, vels, steps, kw, tol_x, tol_u, dissipates in \
            golden_scenarios():
        r = golden_lockstep(polys, vels, steps, "cuda", **kw)
        n = len(polys)
        log(f"[oracle] {label}, {n} floes, {steps} steps: max|d pos| "
            f"{r['max_dx']:.3e} m (tol {tol_x}), max|d vel| "
            f"{r['max_du']:.3e} m/s (tol {tol_u}); K end oracle "
            f"{r['k'][-1]:.6e} J, step {r['k_end_step']:.6e} J, K0 "
            f"{r['k'][0]:.6e} J; clip launches "
            f"{r['launches']}; oracle {n * steps / r['t_oracle']:.1f} "
            f"floe-steps/s on the host, CUDA step "
            f"{n * steps / r['t_step']:.1f} floe-steps/s")
        if r["launches"] != 2 * steps:
            raise AssertionError(f"{label}: {r['launches']} clip launches, "
                                 f"expected 2 per (walled) step")
        if r["max_dx"] >= tol_x or r["max_du"] >= tol_u:
            raise AssertionError(f"{label}: the CUDA step left the oracle's "
                                 f"trajectory")
        if dissipates:
            assert_dissipation(r, label)
        total += r["launches"]
        end = r
    kernel_record["launches"] += total
    t_d = time.perf_counter()

    # (e) a figure of (d)'s end state, drawn from host copies
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log("[plot] this machine has no matplotlib, so no figure was drawn")
    else:
        from subzero_tpu_torch.plotting import plot_basic

        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "golden_end.png"
            plot_basic(end["state"], end["cfg"], path=str(path),
                       color_by="speed")
            log(f"[plot] plot_basic of the gyre scenario's end state: "
                f"{path.stat().st_size} B")
    log(f"[phase7] (a) {t_a - t_phase:.1f} s, (b) {t_b - t_a:.1f} s, (c) "
        f"{t_c - t_b:.1f} s, (d) {t_d - t_c:.1f} s, (e) "
        f"{time.perf_counter() - t_d:.1f} s")


# ---------------------------------------------------------------------------
# phase 8: the spatial decomposition (parallel/) at world size 1
# ---------------------------------------------------------------------------

SPATIAL_STEPS = 20        # (b) float64 lockstep depth
SPATIAL_GHOSTS = 256      # (c) ghost buffers: the x-edge bands hold ~100 floes


def free_port() -> int:
    """A free TCP port on 127.0.0.1: a group's rendezvous needs no network."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankGroup:
    """``world`` processes of ``argv``, one per rank, started in the
    background, each with the environment ``torchrun --nproc-per-node``
    would give it on top of ``env``: ``RANK`` = ``LOCAL_RANK`` = its rank,
    ``WORLD_SIZE``, ``MASTER_ADDR=127.0.0.1`` and a free ``MASTER_PORT``.
    ``wait()`` returns what each rank printed (stdout and stderr together,
    also kept in ``logs``).  It raises ``RuntimeError`` when a rank failed,
    or when the group outlives ``timeout`` seconds from its start, and then
    every rank has been killed."""

    def __init__(self, argv, world: int, timeout: float, env=None,
                 cwd=None):
        import os

        base = dict(os.environ if env is None else env,
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                    WORLD_SIZE=str(world))
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self.logs = [""] * world
        self.procs = [subprocess.Popen(
            argv, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]

    def wait(self) -> list:
        try:
            for r, p in enumerate(self.procs):
                self.logs[r] = p.communicate(timeout=max(
                    self.deadline - time.monotonic(), 0.1))[0]
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for r, p in enumerate(self.procs):
                if p.stdout is not None and not p.stdout.closed:
                    self.logs[r] = p.communicate()[0]
            raise RuntimeError(f"{len(self.procs)} ranks ran past "
                               f"{self.timeout} s and were killed")
        bad = [r for r, p in enumerate(self.procs) if p.returncode]
        if bad:
            raise RuntimeError("".join(
                f"rank {r} failed (exit {self.procs[r].returncode}):\n"
                f"{self.logs[r][-4000:]}\n" for r in bad))
        return self.logs


def spatial_meshes(device="cuda"):
    """(a) The world-size-1 groups: the default group on ``device`` (NCCL
    for CUDA) with a 1-D ("shards",) and a 1x1 ("sx", "sy") mesh over it,
    and a gloo group over the same rank with a CPU 1-D mesh."""
    import torch.distributed as dist

    from subzero_tpu_torch.parallel.distributed import Mesh, initialize

    initialize(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
               rank=0, device=device)
    gloo = dist.new_group(backend="gloo")
    meshes = {"1-D": Mesh((1,), ("shards",), device=device),
              "2-D": Mesh((1, 1), ("sx", "sy"), device=device),
              "gloo": Mesh((1,), ("shards",), device="cpu", group=gloo)}
    log(f"[spatial] groups: {dist.get_backend()} (default) and "
        f"{dist.get_backend(gloo)}, world size {dist.get_world_size()}; "
        + "; ".join(repr(m) for m in meshes.values()))
    return meshes


def live_rows(state):
    """Sorted (x, y, u, v, h) rows of the live floes (test_spatial.py)."""
    a = state.alive.cpu().numpy()
    rows = np.stack([getattr(state, k).cpu().numpy()[a]
                     for k in ("x", "y", "u", "v", "h")], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def spatial_lockstep(label, polys, vel, lx, cfg, mesh, steps=SPATIAL_STEPS):
    """(b) ``steps`` float64 steps of the mesh's step against the port's
    ``make_step_fn`` on the mesh's device, from the same numpy state: the
    gathered live rows within rtol 1e-5, atol 1e-8 (JAX's test_spatial.py
    bar), the same collision count every step, no overflow flag."""
    import torch

    from subzero_tpu_torch.convert import state_from_numpy, state_to_numpy
    from subzero_tpu_torch.dynamics.step import make_step_fn
    from subzero_tpu_torch.forcing import uniform_forcing
    from subzero_tpu_torch.parallel import gather_state, shard_state
    from subzero_tpu_torch.parallel.spatial2d import mesh_step
    from subzero_tpu_torch.state import state_from_polygons

    dev = mesh.device
    st0 = state_to_numpy(state_from_polygons(polys, 0.5, cfg,
                                             velocities=vel, device="cpu"))
    fc = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1, va=5.0,
                         dtype=torch.float64, device=dev)
    single = make_step_fn(cfg, fc, MODULUS, device=dev)
    step, rebalance = mesh_step(cfg, fc, MODULUS, 0.0, mesh)
    s1 = state_from_numpy(st0, device=dev, dtype=torch.float64)
    sn = shard_state(rebalance(s1), mesh)
    ncol, flags = [], []
    for i in range(steps):
        s1, a1 = single(s1, i)
        sn, an = step(sn, i)
        ncol.append((int(a1.n_collisions), int(an.n_collisions)))
        flags.append(bool(step.overflow) or any(bool(getattr(an, k)) for k
                                                in ("region_overflow",
                                                    "pair_pool_overflow")))
    r1, rn = live_rows(s1), live_rows(gather_state(sn, mesh))
    ok = r1.shape == rn.shape and np.allclose(rn, r1, rtol=1e-5, atol=1e-8)
    d = np.max(np.abs(rn - r1), axis=0) if r1.shape == rn.shape else None
    log(f"[spatial] (b) {label}, {mesh.axis_names}, {steps} steps: max|d| "
        f"x,y {max(d[:2]):.3e} m, u,v {max(d[2:4]):.3e} m/s, h "
        f"{d[4]:.3e} m; collisions/step {[c[1] for c in ncol]} (equal: "
        f"{all(a == b for a, b in ncol)}); overflow {any(flags)}")
    if not ok or any(a != b for a, b in ncol) or any(flags) \
            or sum(c[1] for c in ncol) == 0:
        raise AssertionError(f"{label}: the mesh step left the single-device "
                             f"step (or overflowed, or never collided)")


def run_spatial_main(state, cfg, forcing, mesh):
    """(c) Warm-up step + STEPS timed steps of the slab step from the
    global ``state``; returns (launches, rate, phase ms per step, end slab,
    aux, overflow seen on any rank, live floes over the mesh after the
    timed steps).  One more step after the timing runs its exchange,
    contact and migration under ``torch.cuda.set_sync_debug_mode("error")``
    (the trajectory update keeps its one host sync)."""
    import torch

    from subzero_tpu_torch import trace
    from subzero_tpu_torch.parallel import shard_state
    from subzero_tpu_torch.parallel.spatial2d import mesh_step

    step, rebalance = mesh_step(cfg, forcing, MODULUS, 0.0, mesh)
    slab = shard_state(rebalance(state), mesh)
    marks = []

    def timer(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    flag = torch.zeros((), dtype=torch.bool, device=mesh.device)
    with trace.recording(trace.Table()) as table:
        s, aux = step(slab, 0)
        torch.cuda.synchronize()
        marks.clear()
        t0 = time.perf_counter()
        for i in range(1, STEPS + 1):
            s, aux = step(s, i, timer=timer)
            # step.overflow: every rank's neighbour table, ghosts and
            # migration
            flag = flag | step.overflow | aux.region_overflow \
                | aux.pair_pool_overflow
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts(table)[0]
    n_alive = int(mesh.psum(s.alive.sum()[None]).item())
    phase = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name != "end":
            phase[name] = phase.get(name, 0.0) + a.elapsed_time(b) / STEPS

    def strict(name):
        # host syncs raise everywhere but in the trajectory update
        torch.cuda.set_sync_debug_mode(
            0 if name in ("trajectory", "end") else "error")

    try:
        s, aux = step(s, STEPS + 1, timer=strict)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    flag = flag | step.overflow
    return (launches, state.n * STEPS / wall, phase, s, aux, bool(flag),
            n_alive)


def check_spatial_clips(state, cfg, forcing, mesh, label):
    """(c) The clip kernel on the inputs of one slab step's two overlap
    calls, the interior pass's and the band pass's (band rows against the
    ghosts: a batch no other phase gives it), against the plain version
    at phase 4's float32 bounds.  Returns the largest area difference."""
    import torch

    from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
    from subzero_tpu_torch.kernels import clip as kclip
    from subzero_tpu_torch.parallel import shard_state
    from subzero_tpu_torch.parallel.spatial2d import mesh_step

    step, rebalance = mesh_step(cfg, forcing, MODULUS, 0.0, mesh)
    slab = shard_state(rebalance(state), mesh)
    got = captured_clip_inputs(lambda: step(slab, 0))
    if len(got) != 2:
        raise AssertionError(f"{label}: {len(got)} overlap clips in a slab "
                             f"step, expected 2")
    worst = 0.0
    for name, (a, b) in zip(("interior", "band"), got):
        da, dc = compare(kclip.clip_stats_cuda(a, b, False),
                         clip_integral_bm(a, b, False), torch.float32,
                         f"{label} {name} pass")
        log(f"[kernel] slab step {label}, {name} pass B={a.shape[0]} "
            f"Vp={a.shape[1]} Vq={b.shape[1]}: max|d area| {da:.3e}  "
            f"max|d chord| {dc:.3e}  n_cross equal")
        worst = max(worst, da)
    return worst


def phase_spatial(results, kernel_record, device="cuda"):
    """Phase 8: the spatial decomposition on the card at world size 1."""
    import torch
    import torch.distributed as dist

    from subzero_tpu_torch.forcing import uniform_forcing
    from subzero_tpu_torch.sim import out_of_box_sim
    from subzero_tpu_torch.state import state_from_polygons

    t_phase = time.perf_counter()
    meshes = spatial_meshes(device)
    try:
        # (b) float64 lockstep on phase 3's quad lattices, default
        # per-region contacts, overlapped halo on and off
        t_a = time.perf_counter()
        for label, seed, periodic in (("256 quads periodic", 3, True),
                                      ("256 quads walled", 1, False)):
            polys, vel, lx = lattice(256, seed=seed)
            for ov in (True, False):
                cfg = lattice_config(256, lx, periodic=periodic,
                                     dtype="float64", n_mc=64, window=16,
                                     contact={},
                                     numerics=dict(overlap_halo=ov))
                for name in ("1-D", "2-D"):
                    spatial_lockstep(f"{label}, overlap_halo={ov}", polys,
                                     vel, lx, cfg, meshes[name])
        t_b = time.perf_counter()

        # (c) float32 at full width through the slab step
        polys, vel, lx = lattice(N_FLOES)
        forcing = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1)
        quads = state_from_polygons(polys, 0.5, lattice_config(
            N_FLOES, lx, periodic=True, dtype="float32"), velocities=vel)
        total = 0
        for label, contact in (("aggregate periodic", None),
                               ("(a) default periodic", {})):
            cfg = lattice_config(N_FLOES, lx, periodic=True,
                                 dtype="float32", contact=contact,
                                 capacity=dict(max_ghosts=SPATIAL_GHOSTS))
            kernel_record["max_abs_err"] = max(
                kernel_record["max_abs_err"],
                check_spatial_clips(quads, cfg, forcing, meshes["1-D"],
                                    label))
            torch.cuda.reset_peak_memory_stats()
            launches, rate, phase, s, aux, flag, n_alive = run_spatial_main(
                quads, cfg, forcing, meshes["1-D"])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            # interior pass + band pass: two overlap clips a periodic step
            want = 2 * (STEPS + 1)
            r1, p1, m1, alive1 = results[label]
            log(f"[spatial] (c) {label}, slab step S=1: {rate:.1f} "
                f"floe-steps/s over {STEPS} steps (single-device step, "
                f"phase 4: {r1:.1f}); per step (CUDA events, ms): "
                + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
                + f"; peak memory {peak:.2f} GiB (phase 4: {m1:.2f}); clip "
                f"launches {launches} (expected {want}: "
                f"{launches / (STEPS + 1):.0f} per step)")
            log(f"[spatial] (c) {label}: exchange, contact and migration "
                f"ran under set_sync_debug_mode('error'); alive {n_alive} "
                f"after {STEPS + 1} steps (single-device step: {alive1}), "
                f"collisions last step {int(aux.n_collisions)}, overflow "
                f"on any rank {flag}")
            if launches != want:
                raise AssertionError(f"{label}: {launches} clip launches in "
                                     f"the slab step, expected {want}")
            if flag or int(aux.n_collisions) == 0 or n_alive != alive1 \
                    or not bool(torch.isfinite(s.x).all()):
                raise AssertionError(f"{label}: the slab step overflowed or "
                                     f"ended implausibly")
            total += launches
        kernel_record["launches"] += total
        del quads, s, aux
        torch.cuda.empty_cache()
        t_c = time.perf_counter()

        # (d) Simulation(mesh=...) on the NCCL group against the gloo group
        def oob(dev):
            sim = out_of_box_sim(device=dev, dtype="float64")
            sim.mesh = meshes["1-D" if dev == "cuda" else "gloo"]
            sim.__post_init__()
            return sim

        sim_lockstep("out_of_box_sim on a 1-shard mesh", oob, 60)
        t_d = time.perf_counter()
        log(f"[phase8] (a) {t_a - t_phase:.1f} s, (b) {t_b - t_a:.1f} s, "
            f"(c) {t_c - t_b:.1f} s, (d) {t_d - t_c:.1f} s")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 9: the validation campaign
# ---------------------------------------------------------------------------

CAMPAIGN_EVERY = 150      # out_of_box_sim's output cadence (n_dt_out)
CAMPAIGN_UNIAXIAL = 70    # uniaxial steps: its walls move at 30 and 60


def campaign_ledgers(results: Path) -> list:
    """[(case heading, ledger)] of the summary blocks in a RESULTS.md, in
    order."""
    key = "- ledger (floes+dissolved+exported)/m0: "
    out, head = [], None
    for line in results.read_text().splitlines():
        if line.startswith("## "):
            head = line[3:]
        elif line.startswith(key):
            out.append((head, float(line[len(key):])))
    return out


def phase_campaign(kernel_record):
    """Phase 9: ``subzero_tpu_torch.campaign`` on the card, float32, into a
    temporary directory, through its command line: ``out_of_box`` for two
    output cadences straight, and the same in two legs with ``--resume``
    in the middle; ``uniaxial`` for CAMPAIGN_UNIAXIAL steps."""
    import tempfile

    import torch

    from subzero_tpu_torch import campaign
    from subzero_tpu_torch.sim import Simulation

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        straight, legs = Path(tmp) / "straight", Path(tmp) / "legs"
        runs = [["out_of_box", f"--steps={2 * CAMPAIGN_EVERY}",
                 f"--out={straight}"],
                ["out_of_box", f"--steps={CAMPAIGN_EVERY}", f"--out={legs}"],
                ["out_of_box", f"--steps={2 * CAMPAIGN_EVERY}", "--resume",
                 f"--out={legs}"],
                ["uniaxial", f"--steps={CAMPAIGN_UNIAXIAL}",
                 f"--out={straight}"]]
        # each run's Simulation counts its own launches (phase_times and
        # its lifecycle's pass_times): note every one the campaign drives
        sims, run0 = {}, Simulation.run

        def noted(sim, *a, **kw):
            sims[id(sim)] = sim
            return run0(sim, *a, **kw)

        Simulation.run = noted
        try:
            rcs = [campaign.main(argv) for argv in runs]
        finally:
            Simulation.run = run0
        torch.cuda.synchronize()
        launches = sum(sim_launches(sim) for sim in sims.values())
        wall = time.perf_counter() - t0
        if any(rcs):
            raise AssertionError(f"phase 9: campaign runs exited {rcs}")
        ledgers = (campaign_ledgers(straight / "RESULTS.md")
                   + campaign_ledgers(legs / "RESULTS.md"))
        missing = [str(f) for f in (
            straight / "out_of_box" / "distributions.npz",
            straight / "uniaxial" / "distributions.npz",
            straight / "out_of_box" / "m0.npy",
            straight / "uniaxial" / "m0.npy",
            legs / "out_of_box" / f"snap{2 * CAMPAIGN_EVERY:07d}" /
            "eulerian.npz") if not f.exists()]
        sa = np.load(straight / "out_of_box" / "mass_series.npy")
        sb = np.load(legs / "out_of_box" / "mass_series.npy")
        resumed = json.loads((legs / "out_of_box" /
                              f"snap{2 * CAMPAIGN_EVERY:07d}" /
                              "meta.json").read_text())["step_idx"]
    # float32 on the card: index_add_'s atomics make two runs agree to
    # rounding, not bit for bit
    series_d = float(np.max(np.abs(sa - sb) / np.maximum(np.abs(sa), 1.0)))
    worst = max(abs(v - 1.0) for _, v in ledgers)
    total = 4 * CAMPAIGN_EVERY + CAMPAIGN_UNIAXIAL
    log(f"[campaign] 4 runs ({total} steps, walled: 2 clip launches a "
        f"step) in {wall:.1f} s; ledgers "
        + ", ".join(f"{h.split(' ')[0]} {v:.8f}" for h, v in ledgers)
        + f"; resumed out_of_box ends at step {resumed}, mass series rows "
        f"{sb[:, 0].astype(int).tolist()} within {series_d:.3e} of the "
        f"straight run's; clip launches {launches}")
    if missing:
        raise AssertionError(f"phase 9: outputs missing: {missing}")
    if len(ledgers) != 4 or worst > 1e-6:
        raise AssertionError(f"phase 9: ledgers {ledgers}: 1e-6 from 1")
    if (resumed != 2 * CAMPAIGN_EVERY or series_d > 1e-6
            or sb[:, 0].tolist() != sa[:, 0].tolist()):
        raise AssertionError("phase 9: the resumed leg does not continue the "
                             "straight run")
    if launches < 2 * total:
        raise AssertionError(f"phase 9: {launches} clip launches in {total} "
                             f"walled steps")
    kernel_record["launches"] += launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"[device] {smi.stdout.strip().splitlines()[0]}")

    t_all = time.perf_counter()
    phase_build()
    worst = phase_kernel_vs_plain()
    worst = max(worst, phase_wide_shapes())
    bp_record = {
        "name": "broadphase", "route": "cuda",
        "source": "subzero_tpu_torch/csrc/broadphase.cu",
        "replaces": "none: XLA in subzero_tpu/dynamics/broadphase.py:"
                    "neighbor_candidates",
        "launches": 0, "max_abs_err": 0.0, "library_ms": None,
    }
    phase_broadphase(bp_record)
    mc_record = {
        "name": "mc_mask", "route": "cuda",
        "source": "subzero_tpu_torch/csrc/mc_mask.cu",
        "replaces": "none: numpy in subzero_tpu/state.py:make_floe_arrays",
        "launches": 0, "max_abs_err": 0.0, "library_ms": None,
    }
    phase_mc_mask(mc_record)
    built = main_path_runs()
    pallas_record = {
        "name": "clip_pallas", "route": "cuda",
        "source": "subzero_tpu_torch/csrc/clip_pallas.cu",
        "replaces": "subzero_tpu/geometry/clip_pallas.py:125",
        "library_ms": None,
    }
    phase_pallas(pallas_record, built)
    phase_step_parity()
    record = {
        "name": "clip", "route": "cuda",
        "source": "subzero_tpu_torch/csrc/clip.cu",
        "replaces": "subzero_tpu/geometry/clip_integral.py:clip_integral_bm",
        "library_ms": None,
    }
    runs, results = phase_main_path(record, built, bp_record)
    record["max_abs_err"] = max(record["max_abs_err"], worst)
    phase_sim_parity()
    phase_big_run(record, bp_record, mc_record)
    phase_remainder(runs, results, record)
    phase_spatial(results, record)
    phase_campaign(record)
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (record, pallas_record,
                                            bp_record, mc_record)]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
