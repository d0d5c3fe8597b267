"""Narrow-phase contact forces — port of ``subzero_tpu/dynamics/contact.py``
(``collisions/floe_interactions.m``), aggregate-contact mode.

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

Every pair gets ONE aggregate contact (``ContactConfig(per_region=False)``):
exact for convex and single-region contacts.  Per-region contacts and the
active-pair pool are not ported yet (ROADMAP A7) and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..kernels.clip import difference_stats, overlap_stats
from .broadphase import NeighborTable


def check_supported(cfg: SimConfig):
    """Raise NotImplementedError for the options this port lacks so far."""
    if cfg.contact.per_region:
        raise NotImplementedError(
            "per-region contacts (ContactConfig.per_region=True) are not "
            "ported yet (ROADMAP A7); use ContactConfig(per_region=False)")
    if cfg.contact.pair_pool:
        raise NotImplementedError(
            "the active-pair pool (ContactConfig.pair_pool=True) is not "
            "ported yet (ROADMAP A7)")
    if cfg.numerics.contact_impl == "xla":
        raise NotImplementedError(
            "contact_impl='xla' (segment-midpoint clip) is not ported yet "
            "(ROADMAP A11); 'integral' and 'pallas' both select the "
            "parity-integral clip")
    if cfg.numerics.broadphase == "cells":
        raise NotImplementedError(
            "the cell-list broad phase (broadphase='cells') is not ported "
            "yet (ROADMAP A3c); use broadphase='n2'")


def _clip_fns(cfg: SimConfig):
    """(overlap, difference) clip functions.  "integral" and "pallas" name
    one math: the wrappers launch the CUDA kernel on CUDA tensors and run
    the plain PyTorch version on CPU tensors.  No config value routes a
    CUDA tensor to the plain version."""
    check_supported(cfg)
    return overlap_stats, difference_stats


class PairContacts(NamedTuple):
    """Per-(floe, neighbour-slot) contact results, shapes [N, K].

    fx, fy:    contact force on floe i from neighbour k
    px, py:    contact point (world frame)
    tq:        torque about floe i's centroid, cross(p - r_i, F)
    sxx/syy/sxy: virial stress sums (p - r_i) ⊗ F (symmetrized xy)
    overlap:   overlap area of the pair
    merge_i:   floe i should be absorbed into neighbour (overlap frac > 0.55)
    merge_j:   neighbour should be absorbed into floe i
    region_overflow, region_need, pair_pool_overflow, pair_pool_need:
               [] pool counters of the modes not ported yet (always 0 here)
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

    absorb: floe is >75% outside the domain -> kill (floe_interactions.m:37-39)
    out:    centroid left the domain -> kill (floe_interactions_all.m:152-155)
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
    amin,                        # [P] small-region area cull threshold
    merge_ok,                    # [P] merge gate (floe_interactions.m:54)
    min_cross: int = 2,
    tang_reference: bool = True,
):
    """Contact forces for a flat batch of polygon-pair overlap statistics."""
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

    return fx, fy, px, py, tq, sxx, syy, sxy, overlap, merge_i, merge_j


def contact_forces(
    verts_world: torch.Tensor,    # [N, V, 2]
    x, y, u, v, ksi,              # [N]
    h, area,                      # [N]
    nbr: NeighborTable,
    modulus: float,
    cfg: SimConfig,
    nv: torch.Tensor | None = None,        # [N] vertex counts (region cull)
    domain_verts: torch.Tensor | None = None,  # merge-gate bbox (:54)
) -> PairContacts:
    """Contact forces for every (floe, candidate) in the neighbour table.

    Each unordered pair appears twice (once per endpoint); antisymmetry of
    the chord gives Newton's third law without a symmetrization pass.
    """
    overlap_fn, _ = _clip_fns(cfg)
    dtype = x.dtype
    dev = x.device
    n, k = nbr.idx.shape
    phys = cfg.physics
    dt = cfg.numerics.dt
    j = nbr.idx.long()

    r = torch.sqrt(area)
    h_i = h[:, None].expand(n, k)
    h_j = h[j]
    r_i = r[:, None].expand(n, k)
    r_j = r[j]
    # Force_factor (floe_interactions.m:12); giant-floe special case (:15-18).
    ff = modulus * h_i * h_j / (h_i * r_j + h_j * r_i)
    giant = (r_i > 1e5) | (r_j > 1e5)
    ff = torch.where(giant,
                     modulus * torch.minimum(h_i, h_j)
                     / torch.minimum(r_i, r_j), ff)

    shear_g = modulus / (2.0 * (1.0 + phys.nu_poisson))

    # Small-region cull threshold Amin = min(N1,N2)*100/1.75
    # (floe_interactions.m:78-83); disabled without the true vertex counts.
    if nv is None:
        amin = torch.zeros((n, k), dtype=dtype, device=dev)
    else:
        amin = (torch.minimum(nv[:, None], nv[j]).to(dtype)
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
        merge_ok = in_bbox[:, None] | (area[j] < 0.95 * dom_area)

    # Pair-local frame: both polygons translated by floe i's centroid.
    # Area, chord and crossings are translation-invariant, and the f32
    # coordinates drop from domain scale (1e5) to contact scale (1e3); the
    # contact point is shifted back below.  The [N*K, V, 2] pair buffers are
    # the step's largest tensors after the broad phase and die with it.
    p = n * k
    vcap = verts_world.shape[1]
    ci = torch.stack([x, y], dim=-1)[:, None, None, :]      # [N, 1, 1, 2]
    vj = verts_world[j] + nbr.shift[:, :, None, :] - ci
    vi = (verts_world[:, None] - ci).expand(vj.shape)
    st = overlap_fn(vi.reshape(p, vcap, 2), vj.reshape(p, vcap, 2))
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
            fl(u[j]), fl(v[j]), fl(ksi[j]),
            fl(x[j] + nbr.shift[..., 0] - x[:, None]),
            fl(y[j] + nbr.shift[..., 1] - y[:, None]),
            fl(ff),
            fl(area[:, None].expand(n, k)),
            fl(area[j]),
            shear_g, phys.mu_friction, dt,
            cfg.contact.min_chord, cfg.contact.merge_overlap_frac,
            amin=fl(amin),
            merge_ok=fl(merge_ok),
            min_cross=cfg.contact.min_crossings,
            tang_reference=cfg.contact.tangential_velocity == "reference",
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
    no = torch.zeros((), dtype=torch.bool, device=dev)
    none = torch.zeros((), dtype=torch.int32, device=dev)
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
        region_overflow=no,
        region_need=none,
        pair_pool_overflow=no,
        pair_pool_need=none,
    )


def boundary_contact(
    verts_world: torch.Tensor,     # [N, V, 2]
    x, y, u, v, ksi,               # [N]
    h, area, alive,                # [N]
    domain_verts: torch.Tensor,    # [Vb, 2] CCW domain polygon
    modulus: float,
    cfg: SimConfig,
    nv: torch.Tensor | None = None,  # [N] vertex counts (region cull)
) -> BoundaryContact:
    """Floe-vs-domain-boundary contact (the reference's ``floebound`` path).

    The overlap region is the part of the floe OUTSIDE the domain polygon,
    ``polyclip(c1, c2, 'dif')`` (floe_interactions.m:34), clipped in a
    floe-local frame (centroid at the origin) for f32 conditioning.
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
    st = difference_fn((verts_world - ci).to(cdt), dom.to(cdt))
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

    absorb = ar / area > cfg.contact.boundary_overlap_frac

    # Centroid-outside-domain kill (floe_interactions_all.m:152-155).
    from ..geometry.polygon import points_in_polygon

    pts = torch.stack([x, y], dim=-1)
    inside = points_in_polygon(pts[None], domain_verts)[0]
    out = alive & ~inside

    return BoundaryContact(
        fx=fx, fy=fy, px=px + x, py=py + y, tq=tq,
        sxx=sxx, syy=syy, sxy=sxy, overlap=overlap,
        absorb=alive & absorb, out=out,
        region_overflow=torch.zeros((), dtype=torch.bool, device=dev),
        region_need=torch.zeros((), dtype=torch.int32, device=dev),
    )
