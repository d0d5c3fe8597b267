"""Spatial domain decomposition over a device mesh — port of
``subzero_tpu/parallel/spatial.py`` on ``torch.distributed``.

The domain is cut into S vertical stripes along x, one per rank.  Each rank
holds the slab of ``n_loc = max_floes / S`` floe slots whose centroids lie
in its stripe (slab s = global slots ``[s*n_loc, (s+1)*n_loc)``).  Per step
every rank runs the same code on its own slab:

1. **Halo exchange** — floes within a halo width of a stripe edge are packed
   into fixed-capacity ghost buffers and sent to the ring neighbour
   (``Mesh.shift``: one collective per direction; each floe travels as one
   row of a byte buffer that holds all its fields).  On a doubly periodic
   domain the ring wraps, so the periodic seam is one more stripe
   boundary.
2. **Contact** — local queries against local + ghost sources; the chord's
   antisymmetry gives Newton's third law with no cross-rank force
   reduction: the mirrored pair is computed by the neighbour rank.  With
   ``NumericsConfig.overlap_halo`` an interior pass (local sources only)
   and a packed band pass (band floes against the ghosts) are merged into
   the standard [N, K] tables.
3. **Trajectory update** — local.
4. **Migration** — floes whose centroid crossed into a neighbouring stripe
   are packed and shifted one stripe along the ring into free slots.

Every buffer has a fixed capacity and every branch before a collective is
on static data (the config, the rank's mesh coordinate), so every rank
issues the same collectives in the same order.  ``shard_state`` takes a
rank's slab of the global state and ``gather_state`` rebuilds the global
state from the slabs (the counterpart of reading a sharded ``jax.Array``);
lifecycle surgery runs on the global state and ``rebalance_slabs`` restores
the ownership invariant afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig
from ..dynamics.broadphase import neighbor_candidates
from ..dynamics.contact import boundary_contact, contact_forces
from ..dynamics.step import StepAux, domain_polygon
from ..dynamics.trajectory import (
    push_stress, stress_from_sums, trajectory_update,
)
from ..forcing import Forcing
from ..state import FloeState, rotate
from .distributed import Mesh

AXIS = "shards"

# ghost-exchange payload: the fields a neighbour needs for contact
GHOST_FIELDS = ("verts_body", "nv", "x", "y", "alpha", "u", "v", "ksi",
                "h", "area", "rmax", "alive")

_FIELDS = tuple(f.name for f in dataclasses.fields(FloeState))


def slab_bounds(cfg: SimConfig, n_shards: int, s):
    """x-range of stripe s on [-lx, lx]."""
    w = 2.0 * cfg.domain.lx / n_shards
    lo = -cfg.domain.lx + s * w
    return lo, lo + w


def _pack(mask: torch.Tensor, cap: int):
    """Indices of up to ``cap`` True entries (packed first, in slot order),
    their valid mask and the overflow flag: a fixed-shape compaction.  The
    stable sort runs on an integer view of the mask, as ``jnp.argsort`` of
    a bool is stable."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = order[:cap]
    return idx, mask[idx], torch.sum(mask) > cap


def _pack_rows(fields: dict):
    """``{name: [n, ...] tensor}`` as one ``[n, B]`` byte buffer (each row
    holds every field of one slot) and its layout ``{name: (dtype, shape,
    first byte, bytes)}``: one exchange, gather or scatter moves whole
    floes whatever the fields and dtypes."""
    n = next(iter(fields.values())).shape[0]
    parts, layout, off = [], {}, 0
    for name, t in fields.items():
        b = t.reshape(n, -1).contiguous().view(torch.uint8)
        parts.append(b)
        layout[name] = (t.dtype, tuple(t.shape[1:]), off, b.shape[1])
        off += b.shape[1]
    return torch.cat(parts, dim=1), layout


def _unpack_rows(buf: torch.Tensor, layout: dict) -> dict:
    return {name: buf[:, off:off + w].contiguous().view(dtype).reshape(
        (buf.shape[0],) + shape)
        for name, (dtype, shape, off, w) in layout.items()}


def _gather_ghost(buf, layout: dict, idx, valid) -> torch.Tensor:
    """The rows ``idx`` of a ``_pack_rows`` buffer with their ``alive``
    byte and'ed with ``valid``: a ghost (or migrant) payload."""
    rows = buf[idx]
    a = layout["alive"][2]
    rows[:, a] = rows[:, a] * valid
    return rows


def _exchange(mesh: Mesh, fields: dict, hi_mask, lo_mask, cap: int,
              axis: str, coord: str, lo_edge: bool, hi_edge: bool,
              span: float, periodic: bool):
    """Halo exchange along one mesh axis: the slots in ``hi_mask`` go to
    the next rank of the ring, those in ``lo_mask`` to the previous one
    (one ring shift each).  Returns the ghosts (from the previous rank
    first) and the overflow flag.  Walled: the edge ranks discard the
    wrapped-around ghosts; periodic: ghosts crossing the torus edge are
    shifted by the period along ``coord``."""
    buf, layout = _pack_rows(fields)
    hi_idx, hi_val, of_hi = _pack(hi_mask, cap)
    lo_idx, lo_val, of_lo = _pack(lo_mask, cap)
    from_lo = mesh.shift(_gather_ghost(buf, layout, hi_idx, hi_val), axis, 1)
    from_hi = mesh.shift(_gather_ghost(buf, layout, lo_idx, lo_val), axis,
                         -1)
    if not periodic:
        a = layout["alive"][2]
        if lo_edge:
            from_lo[:, a] = 0
        if hi_edge:
            from_hi[:, a] = 0
    ghosts = _unpack_rows(torch.cat([from_lo, from_hi]), layout)
    if periodic:
        c = ghosts[coord]
        if lo_edge:
            c[:cap] = c[:cap] + (-span)
        if hi_edge:
            c[cap:] = c[cap:] + span
    return ghosts, of_hi | of_lo


def _cat(a: dict, *rest: dict) -> dict:
    return {f: torch.cat([a[f]] + [r[f] for r in rest]) for f in a}


def _world(g: dict) -> torch.Tensor:
    """World-frame vertices of a ghost payload."""
    pos = torch.stack([g["x"], g["y"]], dim=-1)
    return rotate(g["alpha"], g["verts_body"]) + pos[:, None, :]


def _put(dst: torch.Tensor, rows, cols, vals, k_cap: int) -> torch.Tensor:
    """``dst`` with ``dst[rows, cols] = vals``, where ``cols == k_cap``
    marks a write that is dropped (a dummy column that is sliced off)."""
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    return ext.index_put_((rows, cols), vals)[:, :k_cap]


def _merge_band(pc_i, nbr_i, pc_b, nbr_b, b_idx, b_val, kg: int,
                k_cap: int, n_loc: int, band_of):
    """Merge the packed band pass's pair tables into the interior tables
    (shared by the 1-D slab and 2-D tile meshes).  Both row kinds are
    valid-prefix (the top-K argmax selects valid candidates first), so band
    entries append at each row's interior count; ghost indices are offset
    past the local slots, the concatenated-source convention downstream
    consumers expect."""
    dev = b_idx.device
    v_int = torch.sum(nbr_i.valid.to(torch.int32), dim=1)       # [N]
    pos = v_int[b_idx][:, None] + torch.arange(kg, device=dev)[None, :]
    okw = nbr_b.valid & b_val[:, None]
    # out of range or not written -> the dummy column (dropped)
    pos_w = torch.where(okw & (pos < k_cap), pos, k_cap)
    rows = b_idx[:, None].expand(pos.shape)

    def put(dst, srcv):
        return _put(dst, rows, pos_w, srcv, k_cap)

    pc = pc_i._replace(
        fx=put(pc_i.fx, pc_b.fx), fy=put(pc_i.fy, pc_b.fy),
        px=put(pc_i.px, pc_b.px), py=put(pc_i.py, pc_b.py),
        tq=put(pc_i.tq, pc_b.tq),
        sxx=put(pc_i.sxx, pc_b.sxx), syy=put(pc_i.syy, pc_b.syy),
        sxy=put(pc_i.sxy, pc_b.sxy),
        overlap=put(pc_i.overlap, pc_b.overlap),
        merge_i=put(pc_i.merge_i, pc_b.merge_i),
        merge_j=put(pc_i.merge_j, pc_b.merge_j),
        region_overflow=pc_i.region_overflow | pc_b.region_overflow,
        region_need=pc_i.region_need + pc_b.region_need,
        pair_pool_overflow=(pc_i.pair_pool_overflow
                            | pc_b.pair_pool_overflow),
        pair_pool_need=(pc_i.pair_pool_need
                        + pc_b.pair_pool_need).to(torch.int32),
    )
    n_ok = torch.sum(okw.to(torch.int32), dim=1) * b_val
    vg = torch.zeros((n_loc,), dtype=torch.int32, device=dev).index_add_(
        0, b_idx, n_ok.to(torch.int32))
    # Demand upper bound covering the band rows' pre-clamp ghost candidate
    # counts (nbr_b.demand): a band row with more ghost contacts than kg
    # must raise overflow and report a demand that, once adopted as K,
    # stops the truncation.  It is taken over different rows (a quirk of
    # the reference, kept for parity).
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    band_int_max = torch.max(torch.where(b_val, v_int[b_idx], zero))
    demand = torch.maximum(torch.max(v_int + vg),
                           torch.maximum(nbr_i.demand,
                                         band_int_max + nbr_b.demand))
    nbr = nbr_i._replace(
        idx=put(nbr_i.idx, nbr_b.idx + n_loc),
        valid=put(nbr_i.valid, okw),
        overflow=(nbr_i.overflow | nbr_b.overflow | band_of
                  | (torch.max(v_int + vg) > k_cap)
                  | torch.any(okw & (pos >= k_cap))),
        demand=demand.to(torch.int32),
    )
    return pc, nbr


def _local_physics(state: FloeState, ghosts: dict, band_mask, step_idx: int,
                   forcing: Forcing, dom, modulus: float, heat_flux: float,
                   cfg: SimConfig, n_loc: int, reducers,
                   bp_periodic: bool, bp_lx: float, bp_ly: float, mark):
    """Contact of the local floes against local + ghost sources, wall
    contact, force reductions, kill flags, trajectory update and the
    periodic wrap: the part of a spatial step between the halo exchange and
    the migration, shared by the slab and tile steps.  ``bp_*`` are the
    broad phase's periodicity arguments (the ghost rings realize the wrap
    along decomposed axes).  Returns (state, pieces of the StepAux)."""
    periodic = cfg.processes.periodic
    dev = state.x.device
    pos = torch.stack([state.x, state.y], dim=-1)
    verts_loc = state.verts_rot() + pos[:, None, :]
    verts_gho = _world(ghosts)
    k_cap = cfg.capacity.max_neighbors
    dom_gate = None if periodic else dom
    if cfg.numerics.overlap_halo:
        # The interior pass (local floes against local sources only) does
        # not need the ghosts; only the packed band pass (floes within a
        # halo width of an edge, against the arrived ghosts) does.  Its
        # results merge into the standard [N, K] tables.
        mark("contact")
        nbr_i = neighbor_candidates(
            state.x, state.y, state.rmax, state.alive, k_cap,
            bp_periodic, bp_lx, bp_ly)
        pc_i = contact_forces(
            verts_loc, state.x, state.y, state.u, state.v, state.ksi,
            state.h, state.area, nbr_i, modulus, cfg,
            nv=state.nv, domain_verts=dom_gate, axis_names=reducers)
        mark("band")
        n_gho_tot = int(ghosts["x"].shape[0])
        n_band = max(min(n_gho_tot, n_loc), 1)
        b_idx, b_val, band_of = _pack(band_mask, n_band)
        kg = min(k_cap, n_gho_tot)
        nbr_b = neighbor_candidates(
            state.x[b_idx], state.y[b_idx], state.rmax[b_idx],
            state.alive[b_idx] & b_val, kg, bp_periodic, bp_lx, bp_ly,
            src=(ghosts["x"], ghosts["y"], ghosts["rmax"],
                 ghosts["alive"], 0))
        pc_b = contact_forces(
            verts_loc[b_idx], state.x[b_idx], state.y[b_idx],
            state.u[b_idx], state.v[b_idx], state.ksi[b_idx],
            state.h[b_idx], state.area[b_idx], nbr_b, modulus, cfg,
            src=(verts_gho, ghosts["x"], ghosts["y"], ghosts["u"],
                 ghosts["v"], ghosts["ksi"], ghosts["h"], ghosts["area"]),
            nv=state.nv[b_idx], nv_s=ghosts["nv"],
            domain_verts=dom_gate, axis_names=reducers)
        pc, nbr = _merge_band(pc_i, nbr_i, pc_b, nbr_b, b_idx, b_val, kg,
                              k_cap, n_loc, band_of)
    else:
        mark("contact")
        x_src = torch.cat([state.x, ghosts["x"]])
        y_src = torch.cat([state.y, ghosts["y"]])
        r_src = torch.cat([state.rmax, ghosts["rmax"]])
        a_src = torch.cat([state.alive, ghosts["alive"]])
        nbr = neighbor_candidates(
            state.x, state.y, state.rmax, state.alive, k_cap,
            bp_periodic, bp_lx, bp_ly,
            src=(x_src, y_src, r_src, a_src, n_loc))
        src = (torch.cat([verts_loc, verts_gho]), x_src, y_src,
               torch.cat([state.u, ghosts["u"]]),
               torch.cat([state.v, ghosts["v"]]),
               torch.cat([state.ksi, ghosts["ksi"]]),
               torch.cat([state.h, ghosts["h"]]),
               torch.cat([state.area, ghosts["area"]]))
        pc = contact_forces(
            verts_loc, state.x, state.y, state.u, state.v, state.ksi,
            state.h, state.area, nbr, modulus, cfg, src=src, nv=state.nv,
            nv_s=torch.cat([state.nv, ghosts["nv"]]),
            domain_verts=dom_gate, axis_names=reducers)

    mark("wall")
    if not periodic:
        bc = boundary_contact(
            verts_loc, state.x, state.y, state.u, state.v, state.ksi,
            state.h, state.area, state.alive, dom, modulus, cfg,
            nv=state.nv, axis_names=reducers)
        b_fx, b_fy, b_tq = bc.fx, bc.fy, bc.tq
        b_sxx, b_syy, b_sxy = bc.sxx, bc.syy, bc.sxy
        b_overlap, b_absorb, b_out = bc.overlap, bc.absorb, bc.out
        b_rov, b_need = bc.region_overflow, bc.region_need
    else:
        zn = torch.zeros_like(state.x)
        b_fx = b_fy = b_tq = b_sxx = b_syy = b_sxy = b_overlap = zn
        b_absorb = b_out = torch.zeros_like(state.alive)
        b_rov = torch.zeros((), dtype=torch.bool, device=dev)
        b_need = torch.zeros((), dtype=torch.int32, device=dev)

    mark("trajectory")
    f_valid = (torch.abs(pc.fx) + torch.abs(pc.fy)) > 0
    b_valid = (torch.abs(b_fx) + torch.abs(b_fy)) > 0
    cf_x = torch.sum(pc.fx, dim=1) + b_fx
    cf_y = torch.sum(pc.fy, dim=1) + b_fy
    cf_t = torch.sum(pc.tq, dim=1) + b_tq

    s_new = stress_from_sums(
        state,
        torch.sum(pc.sxx, dim=1) + b_sxx,
        torch.sum(pc.syy, dim=1) + b_syy,
        torch.sum(pc.sxy, dim=1) + b_sxy)
    state = push_stress(state, s_new, step_idx)
    state = state.replace(
        overlap_area=torch.sum(pc.overlap, dim=1) + b_overlap)

    alive_before = state.alive
    killed = b_absorb | b_out
    if cfg.processes.kill_below_ymin and not periodic:
        killed = killed | (state.alive & (
            torch.amin(verts_loc[..., 1], dim=1) < torch.amin(dom[:, 1])))
    exported = alive_before & killed  # mass leaves the domain
    if not cfg.processes.keep_min:
        killed = killed | (state.area < cfg.min_floe_size)
    state = state.replace(alive=state.alive & ~killed)

    do_int = (int(step_idx) % cfg.processes.n_ocean_force) == 0
    state = trajectory_update(
        state, forcing, cf_x, cf_y, cf_t, heat_flux, do_int, cfg)

    if periodic:
        lx, ly = cfg.domain.lx, cfg.domain.ly
        xw, yw = state.x, state.y
        xw = torch.where(torch.abs(xw) > lx, xw - 2 * lx * torch.sign(xw), xw)
        yw = torch.where(torch.abs(yw) > ly, yw - 2 * ly * torch.sign(yw), yw)
        state = state.replace(x=xw, y=yw)

    parts = dict(
        pc=pc, nbr=nbr, f_valid=f_valid, b_valid=b_valid, cf_x=cf_x,
        cf_y=cf_y, cf_t=cf_t, b_absorb=b_absorb, b_overlap=b_overlap,
        b_rov=b_rov, b_need=b_need, alive_before=alive_before,
        exported=exported)
    return state, parts


def _step_aux(mesh: Mesh, state: FloeState, p: dict, overflow):
    """The step's StepAux and the mesh-wide overflow flag.  The aux's
    scalars are the same on every rank: the collision count sums every
    rank's contacts (a cross-rank pair contributes one endpoint to each of
    two ranks, so the sum comes first, then the halving), the region flag
    is OR'd and the demand is the maximum over the mesh (two collectives).
    The pool demands are summed inside the contact functions.

    ``nbr_overflow`` is rank 0's own flag (its neighbour table, ghost
    buffers and migration), sent to every rank: the JAX step returns each
    shard's flag under a replicated out-spec, so reading it gives shard
    0's.  A quirk of the reference, kept for parity (ROADMAP §C).  The
    second result ORs every rank's flag, in the same collective."""
    pc, nbr = p["pc"], p["nbr"]
    i64 = torch.int64
    sums = mesh.psum(torch.stack([
        torch.sum(p["f_valid"].to(i64)), torch.sum(p["b_valid"].to(i64)),
        (pc.region_overflow | p["b_rov"]).to(i64)]))
    flag = (nbr.overflow | overflow).to(i64)
    maxes = mesh.pmax(torch.stack([
        nbr.demand.to(i64), flag if mesh.rank == 0 else flag * 0, flag]))
    aux = StepAux(
        n_collisions=(sums[0] // 2 + sums[1]).to(torch.int32),
        # the slab and tile steps give slots < n_boundary no coastline rule
        n_coast_pairs=torch.zeros((), dtype=torch.int32,
                                  device=sums.device),
        merge_i=pc.merge_i, merge_j=pc.merge_j,
        absorb_boundary=p["b_absorb"],
        killed=p["alive_before"] & ~state.alive,
        exported=p["exported"],
        nbr_overflow=maxes[1] > 0,
        nbr_demand=maxes[0].to(torch.int32),
        overlap_area=state.overlap_area,
        collision_force=torch.stack([p["cf_x"], p["cf_y"]], -1),
        collision_torque=p["cf_t"],
        nbr_idx=nbr.idx.to(torch.int32),
        pair_valid=p["f_valid"],
        pair_px=pc.px, pair_py=pc.py,
        pair_fx=pc.fx, pair_fy=pc.fy, pair_overlap=pc.overlap,
        boundary_contact=p["b_valid"] | (p["b_overlap"] > 0),
        region_overflow=sums[2] > 0,
        # the contact functions' region needs are already global sums
        region_pool_need=(pc.region_need + p["b_need"]).to(torch.int32),
        pair_pool_overflow=pc.pair_pool_overflow,
        pair_pool_need=pc.pair_pool_need.to(torch.int32),
    )
    return aux, maxes[2] > 0


def _direction_masks(state: FloeState, lo: float, hi: float, coord, span,
                     periodic: bool, first: bool, last: bool):
    """(go_hi, go_lo): live floes whose centroid left [lo, hi) along one
    axis.  Periodic: by the minimum-image offset from the cell centre (a
    floe that wrapped across the torus seam is one hop to the wrapping
    neighbour, not S-1 hops the other way).  Walled: the edge cells keep
    what leaves the domain."""
    if periodic:
        d = coord - 0.5 * (lo + hi)
        d = d - span * torch.round(d / span)
        return (state.alive & (d >= 0.5 * (hi - lo)),
                state.alive & (d < -0.5 * (hi - lo)))
    go_hi = state.alive & (coord >= hi)
    go_lo = state.alive & (coord < lo)
    if last:
        go_hi = torch.zeros_like(go_hi)
    if first:
        go_lo = torch.zeros_like(go_lo)
    return go_hi, go_lo


def make_spatial_step(cfg: SimConfig, forcing: Forcing, modulus: float,
                      heat_flux: float, mesh: Mesh):
    """Build ``step(state, step_idx, domain=None, timer=None) -> (state,
    aux)`` over a 1-D ``("shards",)`` mesh, run by every rank on its slab.

    ``state`` is this rank's slab (``shard_state``) on the mesh's device;
    the capacity must divide by the shard count.  ``domain``: a runtime
    domain polygon (moving walls; the x-stripes stay fixed).  ``timer``:
    optional ``timer(name)`` called at the start of each phase
    ("exchange", "contact", "band", "wall", "trajectory", "migration") and
    with "end".  ``aux``'s per-floe arrays are the slab's; its scalars are
    global.  After a call ``step.overflow`` holds the OR over every rank of
    its neighbour-table, ghost-buffer and migration overflow (a device
    bool; ``aux.nbr_overflow`` is rank 0's own, as the reference's).
    """
    if mesh.axis_names != (AXIS,):
        raise ValueError(f"a slab step needs a ('shards',) mesh, got "
                         f"{mesh.axis_names}")
    n_shards = mesh.size
    cap_total = cfg.capacity.max_floes
    if cap_total % n_shards:
        raise ValueError(f"max_floes {cap_total} does not divide by "
                         f"{n_shards} shards")
    n_loc = cap_total // n_shards
    n_ghost = max(min(cfg.capacity.max_ghosts, n_loc), 1)
    dev = mesh.device
    forcing = forcing.to(device=dev)
    domain_verts = domain_polygon(cfg, device=dev)
    lx, ly = cfg.domain.lx, cfg.domain.ly
    periodic = cfg.processes.periodic
    s = mesh.axis_index(AXIS)
    x_lo, x_hi = slab_bounds(cfg, n_shards, s)
    reducers = (mesh.psum,)

    def step(state: FloeState, step_idx: int, domain=None, timer=None):
        if state.device != dev or state.n != n_loc:
            raise ValueError(f"the step takes this rank's slab of {n_loc} "
                             f"slots on {dev}, got {state.n} on "
                             f"{state.device}")
        mark = timer or (lambda name: None)
        dom = domain_verts if domain is None else domain
        mark("exchange")
        # halo width: the global maximum interaction radius (2 max rmax)
        halo = 2.0 * mesh.pmax(torch.max(torch.where(
            state.alive, state.rmax, torch.zeros_like(state.rmax))))

        # ---- 1. ghost exchange ----------------------------------------
        right_mask = state.alive & (state.x > x_hi - halo)
        left_mask = state.alive & (state.x < x_lo + halo)
        ghosts, g_of = _exchange(
            mesh, {f: getattr(state, f) for f in GHOST_FIELDS}, right_mask,
            left_mask, n_ghost, AXIS, "x", s == 0, s == n_shards - 1,
            2.0 * lx, periodic)

        # ---- 2.-3. contact, trajectory (periodic in y only: the ring
        # realizes the x wrap) -------------------------------------------
        state, p = _local_physics(
            state, ghosts, right_mask | left_mask, step_idx, forcing, dom,
            modulus, heat_flux, cfg, n_loc, reducers,
            periodic, 1e30 if periodic else lx, ly, mark)

        # ---- 4. migration ---------------------------------------------
        mark("migration")
        go_right, go_left = _direction_masks(
            state, x_lo, x_hi, state.x, 2 * lx, periodic, s == 0,
            s == n_shards - 1)
        state, mig_of = _migrate(state, go_right, go_left, n_ghost, mesh,
                                 AXIS)
        aux, step.overflow = _step_aux(mesh, state, p, g_of | mig_of)
        mark("end")
        return state, aux

    step.overflow = None
    return step


def _migrate(state: FloeState, go_hi, go_lo, cap: int, mesh: Mesh,
             axis: str = AXIS):
    """Transfer floes that left this rank's cell to its ring neighbours
    along ``axis``, into free slots.  The state moves as whole rows of one
    byte buffer (``_pack_rows``)."""
    buf, layout = _pack_rows({f: getattr(state, f) for f in _FIELDS})
    a = layout["alive"][2]
    hi_idx, hi_val, of_hi = _pack(go_hi, cap)
    lo_idx, lo_val, of_lo = _pack(go_lo, cap)
    incoming = torch.cat([
        mesh.shift(_gather_ghost(buf, layout, hi_idx, hi_val), axis, 1),
        mesh.shift(_gather_ghost(buf, layout, lo_idx, lo_val), axis, -1)])

    # pack the incoming floes live first, then pair them with the first
    # free local slots (at most one slab's worth)
    n_loc = state.n
    n_tot = incoming.shape[0]
    n_in = min(n_tot, n_loc)
    in_alive = incoming[:, a] != 0
    in_order = torch.argsort((~in_alive).to(torch.uint8), stable=True)
    if n_tot > n_in:
        dropped = torch.any(in_alive[in_order[n_in:]])
    else:
        dropped = torch.zeros((), dtype=torch.bool, device=state.x.device)
    incoming = incoming[in_order[:n_in]]
    in_alive = in_alive[in_order[:n_in]]

    alive = state.alive & ~(go_hi | go_lo)      # the migrants left
    free = ~alive
    slots = torch.argsort((~free).to(torch.uint8), stable=True)[:n_in]
    can = free[slots]
    write = can & in_alive
    # a live incoming floe without a free slot: capacity overflow
    ins_of = torch.any(in_alive & ~can) | dropped
    new = buf.clone()
    new[:, a] = alive
    new[slots] = torch.where(write[:, None], incoming, new[slots])
    return (state.replace(**_unpack_rows(new, layout)),
            of_hi | of_lo | ins_of)


def shard_state(state: FloeState, mesh: Mesh) -> FloeState:
    """This rank's slab (global slots ``[r*n_loc, (r+1)*n_loc)``, rank ``r``
    in the mesh's row-major order) of the global state, on the mesh's
    device.  Call ``rebalance_slabs`` / ``rebalance_tiles`` first so every
    floe sits in the slab owning its centroid."""
    n = state.n
    if n % mesh.size:
        raise ValueError(f"{n} slots do not divide by {mesh.size} ranks")
    n_loc = n // mesh.size
    lo = mesh.rank * n_loc
    return FloeState(**{
        f: getattr(state, f)[lo:lo + n_loc].to(mesh.device).contiguous()
        for f in _FIELDS})


def gather_state(slab: FloeState, mesh: Mesh) -> FloeState:
    """The global state from every rank's slab (the inverse of
    ``shard_state``), on every rank, on the mesh's device: one all-gather
    of the slab's rows (``_pack_rows``)."""
    buf, layout = _pack_rows({f: getattr(slab, f) for f in _FIELDS})
    return FloeState(**_unpack_rows(mesh.all_gather(buf), layout))


def _rebalance(state: FloeState, owner_of, n_cells: int,
               what: str) -> FloeState:
    """Host-side: reorder floes so each lives in the slot block of the cell
    owning its centroid (``owner_of(arrays) -> cell per slot``); live
    floes go to consecutive slots of their block in slot order."""
    arrs = {f: getattr(state, f).cpu().numpy() for f in _FIELDS}
    n_loc = state.n // n_cells
    alive = arrs["alive"]
    owner = owner_of(arrs)
    live_idx = np.nonzero(alive)[0]
    order = np.argsort(owner[live_idx], kind="stable")
    src = live_idx[order]                       # sources grouped by cell
    own_sorted = owner[src]
    counts = np.bincount(own_sorted, minlength=n_cells)
    if np.any(counts > n_loc):
        c = int(np.argmax(counts > n_loc))
        raise RuntimeError(f"{what} {c} over capacity during rebalance "
                           f"(raise max_floes or the {what} count)")
    within = np.arange(len(src)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    dst = own_sorted * n_loc + within
    new = {k: v.copy() for k, v in arrs.items()}
    new["alive"][:] = False
    for k, v in arrs.items():
        new[k][dst] = v[src]
    new["alive"][dst] = True
    return state.replace(**{
        k: torch.from_numpy(v).to(device=state.device,
                                  dtype=getattr(state, k).dtype)
        for k, v in new.items()})


def rebalance_slabs(state: FloeState, cfg: SimConfig, n_shards: int
                    ) -> FloeState:
    """Host-side: reorder floes so each lives in the slab owning its
    centroid (called after lifecycle surgery)."""
    lx = cfg.domain.lx
    w = 2.0 * lx / n_shards
    if state.n != cfg.capacity.max_floes:
        raise ValueError(f"state has {state.n} slots, cfg.capacity "
                         f"{cfg.capacity.max_floes}")

    def owner(a):
        return np.clip(((a["x"] + lx) // w).astype(int), 0, n_shards - 1)

    return _rebalance(state, owner, n_shards, "slab")
