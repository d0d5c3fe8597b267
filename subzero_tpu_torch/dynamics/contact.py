"""Narrow-phase contact forces — port of ``subzero_tpu/dynamics/contact.py``
(``collisions/floe_interactions.m``).

* Spring constant ``Force_factor = E h1 h2 / (h1 r2 + h2 r1)``, r = sqrt(A)
  (floe_interactions.m:12); boundary contact ``E h1 / r1`` (:14).
* Normal force = force_dir * overlap_area * Force_factor (:167), direction
  from the overlap-boundary chord.
* Contact needs >= 2 boundary crossings (:71), dl >= 0.1 m (:141) and the
  small-region area cull (:79-83).
* Tangential force from the relative contact-point velocity, capped by
  Coulomb mu |Fn| (:169-183).
* Merge flags at overlap fraction > 0.55 (:53-60); boundary absorption at
  > 0.75 of a floe outside the domain (:35-40).

Per-region contacts (``ContactConfig.per_region``, the default): the
reference applies one force per disjoint overlap region
(floe_interactions.m:92-190).  Pairs with >= 4 boundary crossings are
compacted into a fixed pool, decomposed into their regions
(geometry/regions.py) and given forces, torque and stress per region;
every other pair keeps its single aggregate contact, which is exact for a
one-region overlap.  With ``ContactConfig.pair_pool`` only the candidate
pairs whose bounding boxes meet are clipped, compacted into a second fixed
pool.  A pool that overflows is reported in the results and never
truncated (see ``_blend_regions_compact``).

Compactions and scatters write unfilled pool slots to one extra dummy row
that is sliced off, where the JAX code drops out-of-range writes: no step
of either pool reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import SimConfig
from ..geometry.clip_batched import difference_stats_bm, overlap_stats_bm
from ..geometry.regions import region_stats, reverse_polygons
from ..kernels.clip import difference_stats, overlap_stats
from ..kernels.clip_pallas import (
    difference_stats_pallas, overlap_stats_pallas,
)
from ..trace import span
from .broadphase import NeighborTable


def _clip_fns(cfg: SimConfig):
    """(overlap, difference) clip functions per cfg.numerics.contact_impl.

    "integral" (default): the XLA twin of the parity-integral clip
    (geometry/clip_integral.py), in the configuration's dtype; the wrappers
    launch csrc/clip.cu on CUDA tensors and run the plain version on CPU
    tensors.
    "pallas": the Pallas TPU kernel's math (geometry/clip_pallas.py), a
    different float32 function of the same pairs; the wrappers cast to
    float32 and launch csrc/clip_pallas.cu on CUDA tensors, run the plain
    version on CPU tensors, and return float32 stats in any configuration,
    as the JAX kernel does.
    No config value routes a CUDA tensor to a plain version of either.
    "xla": the segment-midpoint clip in its batch-minor layout
    (geometry/clip_batched.py), plain PyTorch on both devices, as it is XLA
    code in the JAX package.
    """
    impl = cfg.numerics.contact_impl
    if impl == "pallas":
        return overlap_stats_pallas, difference_stats_pallas
    if impl == "xla":
        return overlap_stats_bm, difference_stats_bm
    return overlap_stats, difference_stats


def _clip(fn, p: torch.Tensor, q: torch.Tensor):
    """One call of a clip function of :func:`_clip_fns` under the host span
    "clip"."""
    with span("clip"):
        return fn(p, q)


class PairContacts(NamedTuple):
    """Per-(floe, neighbour-slot) contact results, shapes [N, K].

    fx, fy:    contact force on floe i from neighbour k
    px, py:    contact point (world frame; per-region mode: the area-weighted
               centroid of the contributing regions)
    tq:        torque about floe i's centroid (exact per-region sum in
               per-region mode)
    sxx/syy/sxy: virial stress sums Σ_regions (p - r_i) ⊗ F (symmetrized xy)
    overlap:   overlap area of the pair
    merge_i:   floe i should be absorbed into neighbour (overlap frac > 0.55)
    merge_j:   neighbour should be absorbed into floe i
    region_overflow: [] >=4-crossing pairs exceeded the region pool (the
               step kept the aggregate contact for every pair)
    region_need: [] int32 count of >=4-crossing pair slots (pool demand)
    pair_pool_overflow: [] bbox-active pairs exceeded the active-pair pool
               (contacts zeroed this step)
    pair_pool_need: [] int32 count of bbox-active pair slots
    """

    fx: torch.Tensor
    fy: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    tq: torch.Tensor
    sxx: torch.Tensor
    syy: torch.Tensor
    sxy: torch.Tensor
    overlap: torch.Tensor
    merge_i: torch.Tensor
    merge_j: torch.Tensor
    region_overflow: torch.Tensor
    region_need: torch.Tensor
    pair_pool_overflow: torch.Tensor
    pair_pool_need: torch.Tensor


class BoundaryContact(NamedTuple):
    """Per-floe contact with the domain boundary, shapes [N].

    Forces have the rectangular-wall component zeroing
    (floe_interactions_all.m:157-166) applied, per region in per-region
    mode; tq / sxx / syy / sxy are torque and virial sums about the floe
    centroid.

    absorb: floe is >75% outside the domain -> kill (floe_interactions.m:37-39)
    out:    centroid left the domain -> kill (floe_interactions_all.m:152-155)
    region_overflow, region_need: the region pool's counters, as above
    """

    fx: torch.Tensor
    fy: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    tq: torch.Tensor
    sxx: torch.Tensor
    syy: torch.Tensor
    sxy: torch.Tensor
    overlap: torch.Tensor
    absorb: torch.Tensor
    out: torch.Tensor
    region_overflow: torch.Tensor
    region_need: torch.Tensor


def _pair_forces_flat(
    st,                          # OverlapStats, [P]-batched
    ui, vi, ksi_i, xi, yi,       # [P] floe i kinematics
    uj, vj, ksi_j, xj, yj,       # [P] neighbour kinematics
    ff,                          # [P] Force_factor per pair
    area_i, area_j,              # [P]
    shear_g, mu, dt,
    min_chord, merge_frac,
    dtype,
    amin,                        # [P] small-region area cull threshold
    merge_ok,                    # [P] merge gate (floe_interactions.m:54)
    min_cross: int = 2,
    tang_reference: bool = True,
):
    """Contact forces for a flat batch of polygon-pair overlap statistics,
    cast to the configuration's ``dtype`` (the stats may be float32 in a
    float64 configuration: contact_impl="pallas")."""
    ar = torch.clamp(st.area, min=0.0)

    chx, chy = st.chord_p[..., 0], st.chord_p[..., 1]
    dl = torch.sqrt(chx * chx + chy * chy)
    inv_dl = 1.0 / torch.where(dl > 0, dl, torch.ones_like(dl))
    # Overlap-reducing force direction on floe i.
    fdx = -chy * inv_dl
    fdy = chx * inv_dl

    ok = (st.n_cross >= min_cross) & (dl >= min_chord) & (ar > 0) \
        & (ar >= amin)

    fn_norm = ar * ff                                     # normal magnitude

    # Tangential: relative velocity at the contact point, in the radial
    # reference form v = [U V] + ksi*(p - r) (floe_interactions.m:170-171)
    # or the rigid-body cross product.
    px, py = st.centroid[..., 0], st.centroid[..., 1]
    if tang_reference:
        vtx = (ui + ksi_i * (px - xi)) - (uj + ksi_j * (px - xj))
        vty = (vi + ksi_i * (py - yi)) - (vj + ksi_j * (py - yj))
    else:
        vtx = (ui - ksi_i * (py - yi)) - (uj - ksi_j * (py - yj))
        vty = (vi + ksi_i * (px - xi)) - (vj + ksi_j * (px - xj))
    vt = torch.sqrt(vtx * vtx + vty * vty)
    inv_vt = 1.0 / torch.where(vt > 0, vt, torch.ones_like(vt))
    # force_t = -|v_t|^2 dl G dt dir_t (floe_interactions.m:178), Coulomb cap
    # (floe_interactions.m:180-183).
    ft_mag = torch.minimum(vt * vt * dl * shear_g * dt, mu * fn_norm)
    zero = torch.zeros_like(ar)
    fx = torch.where(ok, fdx * fn_norm - ft_mag * vtx * inv_vt, zero)
    fy = torch.where(ok, fdy * fn_norm - ft_mag * vty * inv_vt, zero)

    # Merge flags (floe_interactions.m:53-60): tested even when the contact
    # force itself is invalid, gated by merge_ok (:54).
    touching = (ar > 0) & merge_ok
    merge_i = touching & (ar / area_i > merge_frac)
    merge_j = touching & (ar / area_j > merge_frac) & ~merge_i
    overlap = torch.where(touching & ok, ar, zero)

    # Torque about floe i's centroid and virial stress sums.
    tq = (px - xi) * fy - (py - yi) * fx
    sxx = (px - xi) * fx
    syy = (py - yi) * fy
    sxy = 0.5 * ((px - xi) * fy + (py - yi) * fx)

    return (*(a.to(dtype) for a in (fx, fy, px, py, tq, sxx, syy, sxy,
                                    overlap)), merge_i, merge_j)


def _pair_forces_regions(
    rs,                          # RegionStats, [M, C]
    ui, vi, ksi_i,               # [M] floe i kinematics (pair-local origin)
    uj, vj, ksi_j, xj, yj,       # [M] neighbour kinematics (pair-local)
    ff,                          # [M] Force_factor per pair
    shear_g, mu, dt,
    min_chord,
    amin,                        # [M] small-region area cull threshold
    tang_reference: bool = True,
    wall=None,                   # (lx, ly, tol, xw, yw): per-region wall
                                 # component zeroing; xw/yw [M] = world
                                 # offset of the pair-local origin
    region_dl: str = "chord",    # tangential length scale (ContactConfig)
    flip=None,                   # [M, C] reclip direction flips
):
    """Per-region contact forces (floe_interactions.m:92-190): one force per
    disjoint overlap region, the small-region cull per region (:79-83), all
    in the pair-local frame (floe i's centroid at the origin).

    Returns summed (fx, fy), the area-weighted effective contact point,
    exact torque and stress sums, the kept-region overlap area, and whether
    any region was kept.
    """
    ar = rs.area                                          # [M, C]
    chx, chy = rs.chord[..., 0], rs.chord[..., 1]
    ch_norm = torch.sqrt(chx * chx + chy * chy)
    inv_dl = 1.0 / torch.where(ch_norm > 0, ch_norm, torch.ones_like(ch_norm))
    fdx = -chy * inv_dl
    fdy = chx * inv_dl
    if flip is not None:
        # Reference finite-probe flips (floe_interactions.m:158-163): the
        # normal direction only.
        fdx = torch.where(flip, -fdx, fdx)
        fdy = torch.where(flip, -fdy, fdy)
    if region_dl == "edge_mean":
        # dl = mean length of the region's edges on floe 1's boundary
        # (floe_interactions.m:126-131); the 0.1 m gate (:141-142) applies
        # to this dl.
        dl = rs.p_len / torch.clamp(rs.p_cnt, min=1.0)
    else:
        dl = ch_norm

    # Per region: root slot, measurable contact length (:141-142) and the
    # cull Ar < min(N1,N2)*100/1.75 (:79-83).
    ok = rs.valid & (dl >= min_chord) & (ar >= amin[:, None]) & (ar > 0)

    fn = ar * ff[:, None]
    px, py = rs.centroid[..., 0], rs.centroid[..., 1]
    if tang_reference:
        vtx = (ui[:, None] + ksi_i[:, None] * px) \
            - (uj[:, None] + ksi_j[:, None] * (px - xj[:, None]))
        vty = (vi[:, None] + ksi_i[:, None] * py) \
            - (vj[:, None] + ksi_j[:, None] * (py - yj[:, None]))
    else:
        vtx = (ui[:, None] - ksi_i[:, None] * py) \
            - (uj[:, None] - ksi_j[:, None] * (py - yj[:, None]))
        vty = (vi[:, None] + ksi_i[:, None] * px) \
            - (vj[:, None] + ksi_j[:, None] * (px - xj[:, None]))
    vt = torch.sqrt(vtx * vtx + vty * vty)
    inv_vt = 1.0 / torch.where(vt > 0, vt, torch.ones_like(vt))
    ft = torch.minimum(vt * vt * dl * shear_g * dt, mu * fn)
    zero = torch.zeros_like(ar)
    fx_r = torch.where(ok, fdx * fn - ft * vtx * inv_vt, zero)
    fy_r = torch.where(ok, fdy * fn - ft * vty * inv_vt, zero)

    if wall is not None:
        # Rectangular-wall force-component zeroing per region contact point
        # (floe_interactions_all.m:157-166): points on the y-walls push only
        # in y, on the x-walls only in x.
        wlx, wly, wtol, xw, yw = wall
        on_y = torch.abs(torch.abs(py + yw[:, None]) - wly) <= wtol
        on_x = torch.abs(torch.abs(px + xw[:, None]) - wlx) <= wtol
        fx_r = torch.where(on_y & ~on_x, zero, fx_r)
        fy_r = torch.where(on_x & ~on_y, zero, fy_r)

    fx = torch.sum(fx_r, dim=1)
    fy = torch.sum(fy_r, dim=1)
    tq = torch.sum(px * fy_r - py * fx_r, dim=1)
    sxx = torch.sum(px * fx_r, dim=1)
    syy = torch.sum(py * fy_r, dim=1)
    sxy = torch.sum(0.5 * (px * fy_r + py * fx_r), dim=1)
    ar_ok = torch.where(ok, ar, zero)
    overlap = torch.sum(ar_ok, dim=1)
    any_ok = overlap > 0
    inv_w = 1.0 / torch.where(any_ok, overlap, torch.ones_like(overlap))
    px_eff = torch.sum(ar_ok * px, dim=1) * inv_w
    py_eff = torch.sum(ar_ok * py, dim=1) * inv_w
    return fx, fy, px_eff, py_eff, tq, sxx, syy, sxy, overlap, any_ok


def _reclip_flip(rs, vi_m: torch.Tensor, vj_m: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """Reference displace-and-reclip direction test, [M, C] flip mask
    (floe_interactions.m:139-165; ``ContactConfig.normal_dir = "reclip"``).

    For each region: displace floe 1 by the unit analytic direction (the
    reference's 1 m probe), re-decompose the displaced overlap, and match
    each displaced piece to the region by bbox overlap with a 1.5 m margin.
    Each matching piece whose area grew toggles the flip: net flip = odd
    toggle count.  A degenerate displaced decomposition has no valid
    pieces, so its region keeps the analytic direction.  Costs one extra
    ``region_stats`` on an [M*C] batch.
    """
    m = vi_m.shape[0]
    chx, chy = rs.chord[..., 0], rs.chord[..., 1]
    chn = torch.sqrt(chx * chx + chy * chy)
    inv = 1.0 / torch.where(chn > 0, chn, torch.ones_like(chn))
    d2 = torch.stack([-chy * inv, chx * inv], dim=-1)     # [M, C, 2] unit dir
    vi_s = (vi_m[:, None, :, :] + d2[:, :, None, :]).reshape(
        m * cap, vi_m.shape[1], 2)
    vj_s = vj_m[:, None].expand((m, cap) + tuple(vj_m.shape[1:])).reshape(
        m * cap, vj_m.shape[1], 2)
    rs2 = region_stats(vi_s, vj_s, cap, with_bbox=True)
    a2 = rs2.area.reshape(m, cap, cap)                    # [M, Corig, Cnew]
    v2 = rs2.valid.reshape(m, cap, cap)
    bb2 = rs2.bbox.reshape(m, cap, cap, 4)
    bb1 = rs.bbox[:, :, None, :]                          # [M, Corig, 1, 4]
    match = (v2
             & (bb2[..., 2] >= bb1[..., 0] - 1.5)
             & (bb2[..., 3] >= bb1[..., 1] - 1.5)
             & (bb2[..., 0] <= bb1[..., 2] + 1.5)
             & (bb2[..., 1] <= bb1[..., 3] + 1.5))
    grew = match & (a2 / torch.clamp(rs.area[:, :, None], min=1e-30) - 1.0
                    > 0)
    toggles = torch.sum(grew, dim=-1)
    return rs.valid & (toggles % 2 == 1)


def compact(flags: torch.Tensor, m: int):
    """Order-preserving compaction of the set slots of ``flags [P]`` into
    ``m`` pool slots (cumsum + scatter).

    Returns ``sel [m]`` (pair slot of each pool slot; ``P`` in unfilled
    pool slots, the dummy row of ``_scatter``), ``n [] int64`` (set slots,
    uncapped), ``filled [m]`` and ``sel_g [m]`` (``sel`` clamped into range
    for gathers).
    """
    p = flags.shape[0]
    dev = flags.device
    pos = torch.cumsum(flags.long(), dim=0) - 1
    dst = torch.where(flags & (pos < m), pos, m)
    sel = torch.full((m + 1,), p, dtype=torch.long, device=dev).scatter_(
        0, dst, torch.arange(p, device=dev))[:m]
    n = torch.sum(flags)
    filled = torch.arange(m, device=dev) < torch.clamp(n, max=m)
    return sel, n, filled, torch.clamp(sel, max=p - 1)


def _scatter(dst: torch.Tensor, sel: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``dst`` with ``dst[sel] = vals``, where ``sel == len(dst)`` marks a
    write that is dropped (it lands on a dummy row that is sliced off).
    ``vals`` is cast to ``dst``'s dtype, as JAX's scatter casts: under
    contact_impl="pallas" the wall contact's float32 contact point and
    overlap take float64 region values."""
    ext = torch.cat([dst, dst[:1]])
    return ext.index_put_((sel,), vals.to(dst.dtype))[:-1]


def _shared_decision(overflow, need, axis_names: tuple):
    """A pool's (overflow, demand), summed over the mesh.

    ``axis_names`` holds the spatial decomposition's reducers (callables
    that sum an integer tensor over the ranks of mesh axes; the JAX package
    psums over each mesh axis name in turn).  One collective carries both
    values, and the decision stays on the device.  With no reducers the
    values pass through untouched.
    """
    if not axis_names:
        return overflow, need
    v = torch.stack([overflow.to(torch.int64), need.to(torch.int64)])
    for psum in axis_names:
        v = psum(v)
    return v[0] > 0, v[1]


def _blend_regions_compact(
    results,                     # (fx, fy, px, py, tq, sxx, syy, sxy,
                                 #  overlap) flat [P] aggregate results
    n_cross,                     # [P] aggregate crossing counts
    gather_pair,                 # sel_g [M] -> (vi_m, vj_m, kin 8-tuple,
                                 #  ff_m, amin_m, ov_gate_m|None, wall|None)
    shear_g, mu, dt, cfg: SimConfig,
    pair_ok=None,                # [P] slots that may claim pool slots
    pool_base: int | None = None,  # pair count region_pair_frac refers to
                                 # (defaults to P; the active-pair pool
                                 # passes the full n*K)
    axis_names: tuple = (),      # the mesh's reducers (_shared_decision)
):
    """Blend per-region contact results into the aggregate ones, running the
    region decomposition only on a fixed pool of multi-crossing pairs.

    Pairs with <= 2 crossings have one overlap region, where the aggregate
    chord contact IS the per-region contact, so only pairs with >= 4
    crossings are decomposed.  They are compacted into
    ``min(P, max(128, ceil(pool_base * region_pair_frac)))`` pool slots.  If
    the pool overflows, the WHOLE step keeps the aggregate contact: a
    partial pool would break Newton's third law, because compaction order
    could admit one endpoint of an unordered pair while its mirror keeps
    the aggregate force.  The overflow flag stays on the device.
    ``gather_pair`` rebuilds the selected pairs' local geometry and
    kinematics from the floe arrays.  Under the spatial decomposition the
    overflow and the demand are summed over the mesh (``axis_names``), so
    every shard takes the same all-or-nothing decision.

    Returns (blended 9-tuple, overflow [] bool, pool demand [] int32).
    """
    fx, fy, px, py, tq, sxx, syy, sxy, overlap = results
    p_count = n_cross.shape[0]
    # Floor of 128: small populations routinely have tens of >=4-crossing
    # pairs; at 10k-floe scale the frac term dominates.
    m = min(p_count,
            max(128, math.ceil((pool_base or p_count)
                               * cfg.contact.region_pair_frac)))

    needs = n_cross >= 4                             # [P]
    if pair_ok is not None:
        needs = needs & pair_ok
    sel, n_need, need, sel_g = compact(needs, m)

    vi_m, vj_m, kin, ff_m, amin_m, ov_gate_m, wall = gather_pair(sel_g)
    reclip = cfg.contact.normal_dir == "reclip"
    rs = region_stats(vi_m, vj_m, cfg.contact.region_cap, with_bbox=reclip)
    flip = _reclip_flip(rs, vi_m, vj_m, cfg.contact.region_cap) \
        if reclip else None
    ui, vi_k, ksi_i, uj, vj_k, ksi_j, xj, yj = kin
    (rfx, rfy, rpx, rpy, rtq, rsxx, rsyy, rsxy, rov, r_any) = \
        _pair_forces_regions(
            rs, ui, vi_k, ksi_i, uj, vj_k, ksi_j, xj, yj,
            ff_m, shear_g, mu, dt, cfg.contact.min_chord,
            amin=amin_m,
            tang_reference=cfg.contact.tangential_velocity == "reference",
            wall=wall,
            region_dl=cfg.contact.region_dl,
            flip=flip,
        )
    overflow, n_need = _shared_decision(n_need > m, n_need, axis_names)
    # All-or-nothing: on overflow every pair keeps the aggregate contact
    # (symmetric by construction); the overflow flag reports it.
    use = (need & rs.consistent & (rs.n_cross >= cfg.contact.min_crossings)
           & ~overflow)

    def scat(dst, src, gate=use):
        return _scatter(dst, sel, torch.where(gate, src, dst[sel_g]))

    ov_gate = use if ov_gate_m is None else use & ov_gate_m
    return (
        scat(fx, rfx), scat(fy, rfy),
        scat(px, rpx, use & r_any), scat(py, rpy, use & r_any),
        scat(tq, rtq), scat(sxx, rsxx), scat(syy, rsyy), scat(sxy, rsxy),
        scat(overlap, rov, ov_gate),
    ), overflow, n_need.to(torch.int32)


def contact_forces(
    verts_world: torch.Tensor,    # [N, V, 2]
    x, y, u, v, ksi,              # [N]
    h, area,                      # [N]
    nbr: NeighborTable,
    modulus: float,
    cfg: SimConfig,
    src: tuple | None = None,     # optional candidate-source arrays
    nv: torch.Tensor | None = None,        # [N] vertex counts (region cull)
    nv_s: torch.Tensor | None = None,      # source vertex counts
    domain_verts: torch.Tensor | None = None,  # merge-gate bbox (:54)
    axis_names: tuple = (),       # the mesh's reducers (_shared_decision)
) -> PairContacts:
    """Contact forces for every (floe, candidate) in the neighbour table.

    Each unordered pair appears twice (once per endpoint); antisymmetry of
    the chord gives Newton's third law without a symmetrization pass.

    ``src``: (verts_world_s, x_s, y_s, u_s, v_s, ksi_s, h_s, area_s) when
    the neighbour table indexes another candidate set (the spatial
    decomposition: local + ghost floes); every gather of a neighbour reads
    them.
    """
    overlap_fn, _ = _clip_fns(cfg)
    dtype = x.dtype
    dev = x.device
    n, k = nbr.idx.shape
    phys = cfg.physics
    dt = cfg.numerics.dt
    j = nbr.idx.long()
    if src is None:
        verts_s, x_s, y_s, u_s, v_s, ksi_s, h_s, area_s = (
            verts_world, x, y, u, v, ksi, h, area)
        if nv_s is None:
            nv_s = nv
    else:
        verts_s, x_s, y_s, u_s, v_s, ksi_s, h_s, area_s = src

    r = torch.sqrt(area)
    r_s = r if src is None else torch.sqrt(area_s)
    h_i = h[:, None].expand(n, k)
    h_j = h_s[j]
    r_i = r[:, None].expand(n, k)
    r_j = r_s[j]
    # Force_factor (floe_interactions.m:12); giant-floe special case (:15-18).
    ff = modulus * h_i * h_j / (h_i * r_j + h_j * r_i)
    giant = (r_i > 1e5) | (r_j > 1e5)
    ff = torch.where(giant,
                     modulus * torch.minimum(h_i, h_j)
                     / torch.minimum(r_i, r_j), ff)

    shear_g = modulus / (2.0 * (1.0 + phys.nu_poisson))

    # Small-region cull threshold Amin = min(N1,N2)*100/1.75
    # (floe_interactions.m:78-83); disabled without the true vertex counts.
    if nv is None or nv_s is None:
        amin = torch.zeros((n, k), dtype=dtype, device=dev)
    else:
        amin = (torch.minimum(nv[:, None], nv_s[j]).to(dtype)
                * cfg.contact.small_region_coeff)

    # Merge gate (floe_interactions.m:54): floe i fully inside the domain
    # bbox OR the neighbour smaller than 95% of the domain OR periodic.
    if cfg.processes.periodic or domain_verts is None:
        merge_ok = torch.ones((n, k), dtype=torch.bool, device=dev)
    else:
        bx = domain_verts[:, 0]
        by = domain_verts[:, 1]
        vx = verts_world[..., 0]
        vy = verts_world[..., 1]
        in_bbox = (
            (torch.amax(vx, 1) < torch.amax(bx))
            & (torch.amin(vx, 1) > torch.amin(bx))
            & (torch.amax(vy, 1) < torch.amax(by))
            & (torch.amin(vy, 1) > torch.amin(by))
        )
        dom_area = 0.5 * torch.abs(torch.sum(
            bx * torch.roll(by, -1) - torch.roll(bx, -1) * by))
        merge_ok = in_bbox[:, None] | (area_s[j] < 0.95 * dom_area)

    p = n * k
    vcap = verts_world.shape[1]
    tang_ref = cfg.contact.tangential_velocity == "reference"
    j_flat = j.reshape(p)
    shift_flat = nbr.shift.reshape(p, 2)

    def gather_pair(sel_g):
        """Pair-local geometry and kinematics of the selected pair slots
        ``sel_g [M]``, rebuilt from the floe and source arrays."""
        i_s = torch.div(sel_g, k, rounding_mode="floor")
        j_s = j_flat[sel_g]
        sh = shift_flat[sel_g]
        ci_s = torch.stack([x[i_s], y[i_s]], dim=-1)[:, None, :]
        vi_m = verts_world[i_s] - ci_s
        vj_m = verts_s[j_s] + sh[:, None, :] - ci_s
        kin = (u[i_s], v[i_s], ksi[i_s],
               u_s[j_s], v_s[j_s], ksi_s[j_s],
               x_s[j_s] + sh[:, 0] - x[i_s],
               y_s[j_s] + sh[:, 1] - y[i_s])
        return (vi_m, vj_m, kin, ff.reshape(p)[sel_g],
                amin.reshape(p)[sel_g], merge_ok.reshape(p)[sel_g], None)

    no = torch.zeros((), dtype=torch.bool, device=dev)
    none = torch.zeros((), dtype=torch.int32, device=dev)
    region_overflow, region_need = no, none
    pair_pool_overflow, pair_pool_need = no, none

    if cfg.contact.pair_pool:
        # ---- active-pair pool: clip only the pairs whose world bboxes
        # meet.  Exact: a pair with disjoint bboxes has zero overlap area,
        # zero crossings, zero force and no merge flag.
        bx0 = torch.amin(verts_world[..., 0], dim=1)
        bx1 = torch.amax(verts_world[..., 0], dim=1)
        by0 = torch.amin(verts_world[..., 1], dim=1)
        by1 = torch.amax(verts_world[..., 1], dim=1)
        if verts_s is verts_world:
            sx0, sx1, sy0, sy1 = bx0, bx1, by0, by1
        else:
            sx0 = torch.amin(verts_s[..., 0], dim=1)
            sx1 = torch.amax(verts_s[..., 0], dim=1)
            sy0 = torch.amin(verts_s[..., 1], dim=1)
            sy1 = torch.amax(verts_s[..., 1], dim=1)
        jx0 = sx0[j] + nbr.shift[..., 0]
        jx1 = sx1[j] + nbr.shift[..., 0]
        jy0 = sy0[j] + nbr.shift[..., 1]
        jy1 = sy1[j] + nbr.shift[..., 1]
        eps = 1e-3   # m; guards f32 rounding of the bbox reductions
        active = (nbr.valid
                  & (bx0[:, None] <= jx1 + eps) & (jx0 <= bx1[:, None] + eps)
                  & (by0[:, None] <= jy1 + eps) & (jy0 <= by1[:, None] + eps))
        m2 = min(p, max(256, math.ceil(p * cfg.contact.pair_pool_frac)))
        sel, n_act, slot_ok, sel_g = compact(active.reshape(p), m2)

        vi_m, vj_m, kin_m, ff_m, amin_m, mok_m, _ = gather_pair(sel_g)
        st = _clip(overlap_fn, vi_m, vj_m)
        ui_m, vvi_m, ksii_m, uj_m, vj_k_m, ksij_m, xj_m, yj_m = kin_m
        i_s = torch.div(sel_g, k, rounding_mode="floor")
        j_s = j_flat[sel_g]
        zm = torch.zeros(sel_g.shape, dtype=dtype, device=dev)
        res_m = _pair_forces_flat(
            st, ui_m, vvi_m, ksii_m, zm, zm,
            uj_m, vj_k_m, ksij_m, xj_m, yj_m,
            ff_m, area[i_s], area_s[j_s],
            shear_g, phys.mu_friction, dt,
            cfg.contact.min_chord, cfg.contact.merge_overlap_frac, dtype,
            amin=amin_m, merge_ok=mok_m,
            min_cross=cfg.contact.min_crossings,
            tang_reference=tang_ref,
        )
        pair_pool_overflow, n_act = _shared_decision(n_act > m2, n_act,
                                                     axis_names)
        pair_pool_need = n_act.to(torch.int32)
        # All-or-nothing on overflow (as the region pool): a partial pool
        # could keep one endpoint of an unordered pair and drop its mirror.
        # The zeroed step is flagged in pair_pool_overflow.
        use_m = slot_ok & ~pair_pool_overflow

        res9 = res_m[:9]
        mi_m, mj_m = res_m[9], res_m[10]
        if cfg.contact.per_region:
            res9, region_overflow, region_need = _blend_regions_compact(
                res9, st.n_cross, lambda sel2: gather_pair(sel_g[sel2]),
                shear_g, phys.mu_friction, dt, cfg,
                pair_ok=use_m, pool_base=p, axis_names=axis_names,
            )

        zerof = torch.zeros((p,), dtype=dtype, device=dev)
        falsep = torch.zeros((p,), dtype=torch.bool, device=dev)

        def sc(v_m):
            return _scatter(zerof, sel, torch.where(use_m, v_m, 0.0))

        fx, fy, px, py, tq, sxx, syy, sxy, overlap = (sc(a) for a in res9)
        merge_i = _scatter(falsep, sel, use_m & mi_m)
        merge_j = _scatter(falsep, sel, use_m & mj_m)
    else:
        # Pair-local frame: both polygons translated by floe i's centroid.
        # Area, chord and crossings are translation-invariant, and the f32
        # coordinates drop from domain scale (1e5) to contact scale (1e3);
        # the contact point is shifted back below.  The [N*K, V, 2] pair
        # buffers are the step's largest tensors after the broad phase and
        # die with it.
        ci = torch.stack([x, y], dim=-1)[:, None, None, :]  # [N, 1, 1, 2]
        vj = verts_s[j] + nbr.shift[:, :, None, :] - ci
        vi = (verts_world[:, None] - ci).expand(vj.shape)
        st = _clip(overlap_fn, vi.reshape(p, vcap, 2),
                   vj.reshape(p, vcap, 2))
        del vi, vj

        def fl(a):
            return a.reshape(p)

        zero_p = torch.zeros((p,), dtype=dtype, device=dev)
        fx, fy, px, py, tq, sxx, syy, sxy, overlap, merge_i, merge_j = \
            _pair_forces_flat(
                st,
                fl(u[:, None].expand(n, k)),
                fl(v[:, None].expand(n, k)),
                fl(ksi[:, None].expand(n, k)),
                # kinematics in the pair-local frame: centroid = origin
                zero_p, zero_p,
                fl(u_s[j]), fl(v_s[j]), fl(ksi_s[j]),
                fl(x_s[j] + nbr.shift[..., 0] - x[:, None]),
                fl(y_s[j] + nbr.shift[..., 1] - y[:, None]),
                fl(ff),
                fl(area[:, None].expand(n, k)),
                fl(area_s[j]),
                shear_g, phys.mu_friction, dt,
                cfg.contact.min_chord, cfg.contact.merge_overlap_frac, dtype,
                amin=fl(amin),
                merge_ok=fl(merge_ok),
                min_cross=cfg.contact.min_crossings,
                tang_reference=tang_ref,
            )
        if cfg.contact.per_region:
            # Decompose the multi-crossing pairs' overlaps into their
            # regions; pairs whose decomposition is degenerate keep the
            # aggregate result.
            (fx, fy, px, py, tq, sxx, syy, sxy, overlap), region_overflow, \
                region_need = _blend_regions_compact(
                    (fx, fy, px, py, tq, sxx, syy, sxy, overlap),
                    st.n_cross, gather_pair,
                    shear_g, phys.mu_friction, dt, cfg,
                    pair_ok=nbr.valid.reshape(p), axis_names=axis_names,
                )

    fx, fy, px, py, tq, sxx, syy, sxy, overlap, merge_i, merge_j = (
        a.reshape(n, k)
        for a in (fx, fy, px, py, tq, sxx, syy, sxy, overlap,
                  merge_i, merge_j)
    )
    # contact points back to world coordinates
    px = px + x[:, None]
    py = py + y[:, None]

    valid = nbr.valid
    zero = torch.zeros((), dtype=dtype, device=dev)
    return PairContacts(
        fx=torch.where(valid, fx, zero),
        fy=torch.where(valid, fy, zero),
        px=px,
        py=py,
        tq=torch.where(valid, tq, zero),
        sxx=torch.where(valid, sxx, zero),
        syy=torch.where(valid, syy, zero),
        sxy=torch.where(valid, sxy, zero),
        overlap=torch.where(valid, overlap, zero),
        merge_i=valid & merge_i,
        merge_j=valid & merge_j,
        region_overflow=region_overflow,
        region_need=region_need,
        pair_pool_overflow=pair_pool_overflow,
        pair_pool_need=pair_pool_need,
    )


def boundary_contact(
    verts_world: torch.Tensor,     # [N, V, 2]
    x, y, u, v, ksi,               # [N]
    h, area, alive,                # [N]
    domain_verts: torch.Tensor,    # [Vb, 2] CCW domain polygon
    modulus: float,
    cfg: SimConfig,
    nv: torch.Tensor | None = None,  # [N] vertex counts (region cull)
    axis_names: tuple = (),        # the mesh's reducers (_shared_decision)
) -> BoundaryContact:
    """Floe-vs-domain-boundary contact (the reference's ``floebound`` path).

    The overlap region is the part of the floe OUTSIDE the domain polygon,
    ``polyclip(c1, c2, 'dif')`` (floe_interactions.m:34), clipped in a
    floe-local frame (centroid at the origin) for f32 conditioning.  In
    per-region mode the difference regions of the floes with >= 4 crossings
    get one force each, like floe-floe regions.
    """
    _, difference_fn = _clip_fns(cfg)
    dtype = x.dtype
    dev = x.device
    phys = cfg.physics
    dt = cfg.numerics.dt
    r1 = torch.sqrt(area)
    ff = modulus * h / r1                          # floe_interactions.m:14
    shear_g = modulus / (2.0 * (1.0 + phys.nu_poisson))

    n = verts_world.shape[0]
    ci = torch.stack([x, y], dim=-1)[:, None, :]            # [N, 1, 2]
    cdt = torch.promote_types(verts_world.dtype, domain_verts.dtype)
    dom = domain_verts.to(cdt)[None].expand(
        (n,) + tuple(domain_verts.shape)) - ci
    st = _clip(difference_fn, (verts_world - ci).to(cdt), dom.to(cdt))
    del dom

    ar = torch.clamp(st.area, min=0.0)
    chx, chy = st.chord_p[..., 0], st.chord_p[..., 1]
    dl = torch.sqrt(chx * chx + chy * chy)
    inv_dl = 1.0 / torch.where(dl > 0, dl, torch.ones_like(dl))
    # Small-region cull with N2 = 4 (the rectangular wall polygon);
    # disabled without the true vertex counts.
    if nv is None:
        amin = torch.zeros((n,), dtype=dtype, device=dev)
    else:
        amin = torch.clamp(nv.to(dtype), max=4.0) \
            * cfg.contact.small_region_coeff
    ok = (st.n_cross >= cfg.contact.min_crossings) \
        & (dl >= cfg.contact.min_chord) & (ar > 0) & (ar >= amin)
    fn_norm = ar * ff

    # Wall half-widths for the component-zeroing rule
    # (floe_interactions_all.m:157-166).
    wlx = torch.amax(torch.abs(domain_verts[:, 0]))
    wly = torch.amax(torch.abs(domain_verts[:, 1]))
    wtol = cfg.contact.wall_zero_tol

    # floe-local contact point: (px, py) = contact point - centroid.  The
    # boundary is static: v2 = 0.
    px, py = st.centroid[..., 0], st.centroid[..., 1]
    if cfg.contact.tangential_velocity == "reference":
        vtx = u + ksi * px
        vty = v + ksi * py
    else:
        vtx = u - ksi * py
        vty = v + ksi * px
    vt = torch.sqrt(vtx * vtx + vty * vty)
    inv_vt = 1.0 / torch.where(vt > 0, vt, torch.ones_like(vt))
    ft = torch.minimum(vt * vt * dl * shear_g * dt,
                       phys.mu_friction * fn_norm)
    zero = torch.zeros_like(ar)
    fx = torch.where(ok, -chy * inv_dl * fn_norm - ft * vtx * inv_vt, zero)
    fy = torch.where(ok, chx * inv_dl * fn_norm - ft * vty * inv_vt, zero)
    # wall component zeroing at the aggregate contact point
    on_y = torch.abs(torch.abs(py + y) - wly) <= wtol
    on_x = torch.abs(torch.abs(px + x) - wlx) <= wtol
    fx = torch.where(on_y & ~on_x, zero, fx)
    fy = torch.where(on_x & ~on_y, zero, fy)
    tq = px * fy - py * fx
    sxx = px * fx
    syy = py * fy
    sxy = 0.5 * (px * fy + py * fx)
    overlap = torch.where(ok, ar, zero)

    b_region_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    b_region_need = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.contact.per_region:
        # ∂(P \ Q) traverses Q backward: the domain 4-gon, padded by
        # repeating vertex 0, reversed.
        dom_single = reverse_polygons(
            domain_verts[None].to(dtype),
            torch.full((1,), 4, dtype=torch.int32, device=dev))[0]

        def gather_floe(sel_g):
            ci_s = torch.stack([x[sel_g], y[sel_g]], dim=-1)[:, None, :]
            vi_m = verts_world[sel_g] - ci_s
            vj_m = dom_single[None] - ci_s
            zm = torch.zeros(sel_g.shape, dtype=dtype, device=dev)
            kin = (u[sel_g], v[sel_g], ksi[sel_g], zm, zm, zm, zm, zm)
            return (vi_m, vj_m, kin, ff[sel_g], amin[sel_g], None,
                    (wlx, wly, wtol, x[sel_g], y[sel_g]))

        (fx, fy, px, py, tq, sxx, syy, sxy, overlap), b_region_overflow, \
            b_region_need = _blend_regions_compact(
                (fx, fy, px, py, tq, sxx, syy, sxy, overlap),
                st.n_cross, gather_floe,
                shear_g, phys.mu_friction, dt, cfg,
                pair_ok=alive, axis_names=axis_names,
            )

    absorb = ar / area > cfg.contact.boundary_overlap_frac

    # Centroid-outside-domain kill (floe_interactions_all.m:152-155).
    from ..geometry.polygon import points_in_polygon

    pts = torch.stack([x, y], dim=-1)
    inside = points_in_polygon(pts[None], domain_verts)[0]
    out = alive & ~inside

    return BoundaryContact(
        fx=fx, fy=fy, px=px + x, py=py + y, tq=tq,
        sxx=sxx, syy=syy, sxy=sxy, overlap=overlap.to(dtype),
        absorb=alive & absorb, out=out,
        region_overflow=b_region_overflow,
        region_need=b_region_need,
    )
