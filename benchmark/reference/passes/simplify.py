"""Boundary simplification — equivalent of
``polygon_operations/FloeSimplify.m``.

Every ``n_simplify`` steps, floes with more than ``simplify_max_verts``
vertices (Subzero.m:185) are simplified: Douglas-Peucker vertex reduction
(the reference's ``reducepoly``, FloeSimplify.m:40), subtraction of
topography/boundary floes (:42-46), rescaling about the centroid to conserve
area (:56), region splitting (>1e4 m^2 survive, :64-67), and fusion with any
neighbor now covered >40% by the simplified shape (:72-101).
"""

from __future__ import annotations

import numpy as np

from ..polyboolean import poly_boolean, poly_area
from . import hostgeom as hg
from .host import HostView, NewFloe, StateEdit
from .fuse import fuse_floes

def douglas_peucker(poly: np.ndarray, tol: float) -> np.ndarray:
    """Closed-contour Douglas-Peucker (reducepoly's algorithm; default
    tolerance 0.001 x max bounding dimension)."""

    def dp(pts):
        if len(pts) < 3:
            return pts
        a, b = pts[0], pts[-1]
        ab = b - a
        lab = np.linalg.norm(ab)
        if lab < 1e-30:
            d = np.linalg.norm(pts[1:-1] - a, axis=1)
        else:
            rel = pts[1:-1] - a
            d = np.abs(ab[0] * rel[:, 1] - ab[1] * rel[:, 0]) / lab
        imax = int(np.argmax(d))
        if d[imax] <= tol:
            return np.array([a, b])
        left = dp(pts[: imax + 2])
        right = dp(pts[imax + 1:])
        return np.concatenate([left[:-1], right])

    # split the ring at its two most-distant vertices for stability
    d0 = np.argmax(np.sum((poly - poly.mean(0)) ** 2, axis=1))
    ring = np.roll(poly, -d0, axis=0)
    ring = np.concatenate([ring, ring[:1]])
    out = dp(ring)[:-1]
    return out if len(out) >= 3 else poly

def simplify_floe(view: HostView, i: int, cfg,
                  boundary_polys: list[np.ndarray],
                  edit: StateEdit) -> None:
    poly = view.poly(i)
    span = max(np.ptp(poly[:, 0]), np.ptp(poly[:, 1]))
    simplified = douglas_peucker(poly, 0.001 * span)

    pieces = [simplified]
    for bp in boundary_polys:
        nxt = []
        for p in pieces:
            nxt.extend(poly_boolean(p, bp, "dif"))
        pieces = [c for c in nxt if poly_area(c) > 0]
    a_tot = sum(poly_area(c) for c in pieces)
    if a_tot <= 0:
        return

    # rescale about the shape centroid to conserve area (FloeSimplify.m:56)
    s = np.sqrt(view.area[i] / a_tot)
    cen = sum(poly_area(c) * hg.centroid(c) for c in pieces) / a_tot
    pieces = [cen + s * (c - cen) for c in pieces]
    regions = [c for c in pieces
               if poly_area(c) > cfg.processes.min_region_area]
    if not regions:
        edit.dissolve_kills.add(i)
        return

    regions.sort(key=poly_area, reverse=True)
    a_tot = sum(poly_area(c) for c in regions)
    edit.reshapes[i] = (regions[0], poly_area(regions[0]) / a_tot * view.mass[i])
    for c in regions[1:]:
        edit.new_floes.append(NewFloe(
            poly=c, h=0.0, mass=poly_area(c) / a_tot * view.mass[i],
            u=view.u[i], v=view.v[i],
            ksi=poly_area(c) / view.area[i] * view.ksi[i],
            dx_p=view.dx_p[i], dy_p=view.dy_p[i],
            du_p=view.du_p[i], dv_p=view.dv_p[i],
            dksi_p=view.dksi_p[i],
            stress_blend=[(i, 1.0)],
            strain=view.strain[i].copy(),
        ))

    # fusion with neighbors now covered >40% (FloeSimplify.m:72-101)
    main = regions[0]
    for j in range(cfg.n_boundary, view.n):
        if j == i or not view.alive[j] or view.polys[j] is None:
            continue
        if j in edit.kills or j in edit.dissolve_kills or j in edit.reshapes:
            continue
        d2 = (view.x[i] - view.x[j]) ** 2 + (view.y[i] - view.y[j]) ** 2
        if d2 > (view.rmax[i] + view.rmax[j]) ** 2:
            continue
        inter = poly_boolean(main, view.poly(j), "int")
        a_ov = sum(max(poly_area(c), 0.0) for c in inter)
        if a_ov / max(view.area[j], 1e-12) > 0.4:
            # absorb j's mass into the reshaped slot
            old_poly, old_mass = edit.reshapes[i]
            merged = poly_boolean(old_poly, view.poly(j), "uni")
            merged = [c for c in merged if poly_area(c) > 0]
            if merged:
                big = max(merged, key=poly_area)
                edit.reshapes[i] = (big, old_mass + view.mass[j])
                edit.kills.add(j)

def simplify_pass(view: HostView, cfg,
                  boundary_polys: list[np.ndarray]) -> StateEdit:
    """Simplify every live floe above the vertex cap (Subzero.m:169-217)."""
    edit = StateEdit()
    for i in range(cfg.n_boundary, view.n):
        if not view.alive[i] or view.polys[i] is None:
            continue
        if view.nv[i] <= cfg.processes.simplify_max_verts:
            continue
        simplify_floe(view, i, cfg, boundary_polys, edit)
    return edit
