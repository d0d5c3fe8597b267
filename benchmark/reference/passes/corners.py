"""Corner grinding — equivalent of ``Physical_Processes/corners.m`` +
``frac_corner.m``.

Floes in contact have sharp corners broken off probabilistically: a vertex
breaks when ``rand > angle/Anorm`` (Anorm = 180 - 360/nv, corners.m:70-71)
AND the vertex is in contact — nearest vertex to a contact point, or inside
a neighbor's polygon, or outside the domain when touching the wall
(corners.m:73-91).  The cut removes a triangle whose legs extend
min(120 m, d*alpha_min/Anorm/5) along the two incident edges
(frac_corner.m:34-49); the parent keeps the remainder (largest region), the
triangles become new floes with stress scaled by area share and spin scaled
by area ratio (frac_corner.m:89-180).  Pieces below 1e4 m^2 are born dead
(frac_corner.m:113-115) — i.e. dissolved.

The driver-level selection (random ~30% of floes each pass, skipping
heavily-overlapped ones) lives in the lifecycle orchestrator
(Subzero.m:339-352).
"""

from __future__ import annotations

import numpy as np

from . import hostgeom as hg
from ..polyboolean import poly_boolean, poly_area
from .host import HostView, NewFloe, StateEdit

def _corner_cut_points(poly: np.ndarray, k: int, alph: float, anorm: float):
    """The two cut points flanking vertex k (frac_corner.m:25-49)."""
    n = len(poly)
    p_prev = poly[(k - 1) % n]
    p = poly[k]
    p_next = poly[(k + 1) % n]
    d1 = float(np.linalg.norm(p_prev - p))
    d2 = float(np.linalg.norm(p_next - p))
    d = min(d1, d2)
    cut = d * alph / anorm / 5.0

    def along(target, dist, dlen):
        if dlen <= 0:
            return target
        return p + min(dist, dlen) / dlen * (target - p)

    if abs(p_prev[0] - p[0]) < 120 and abs(p_prev[1] - p[1]) < 120:
        c1 = p_prev
    elif abs(cut) < 120:
        c1 = along(p_prev, 120.0, d1)
    else:
        c1 = p + d / d1 * alph / anorm / 5.0 * (p_prev - p)
    if abs(p_next[0] - p[0]) < 120 and abs(p_next[1] - p[1]) < 120:
        c2 = p_next
    elif abs(cut) < 120:
        c2 = along(p_next, 120.0, d2)
    else:
        c2 = p + d / d2 * alph / anorm / 5.0 * (p_next - p)
    return c1, c2

def grind_floe(view: HostView, i: int, grind_mask: np.ndarray,
               cfg, edit: StateEdit) -> None:
    """Break the flagged corners off floe ``i`` (frac_corner.m)."""
    poly = view.poly(i)
    n = len(poly)
    angles = hg.angles_deg(poly)
    anorm = 180.0 - 360.0 / n
    alph = float(np.min(angles))
    area_parent = hg.area(poly)
    if area_parent <= 0:
        return

    triangles = []
    for k in range(n):
        if not grind_mask[k]:
            continue
        c1, c2 = _corner_cut_points(poly, k, alph, anorm)
        tri = np.array([c1, c2, poly[k]])
        if hg.area(tri) < 0:
            tri = tri[::-1]
        if abs(hg.area(tri)) > 10.0:
            triangles.append(tri)
    if not triangles:
        return

    # remainder = parent minus all triangles (frac_corner.m:136-143)
    remainder = [poly]
    for tri in triangles:
        new_rem = []
        for r in remainder:
            new_rem.extend(poly_boolean(r, tri, "dif"))
        remainder = [c for c in new_rem if poly_area(c) > 0]
    if not remainder:
        return
    remainder.sort(key=poly_area, reverse=True)

    # All remainder regions survive as pieces (frac_corner.m:89: R1 collects
    # every region of poly1 and poly2 above 10 m^2), not just the largest.
    a_rem = sum(poly_area(r) for r in remainder)
    a_tris = sum(hg.area(t) for t in triangles)
    a_tot = a_rem + a_tris

    edit.kills.add(i)
    pieces = remainder + triangles
    for piece in pieces:
        a_p = abs(hg.area(piece))
        share = a_p / a_tot
        if a_p < 1e4:
            # born dead -> dissolved (frac_corner.m:113-115): bin the mass
            # share so the ledger stays closed (calc_dissolved_mass.m)
            c = hg.centroid(piece)
            edit.dissolve_mass.append(
                (float(c[0]), float(c[1]), float(view.mass[i] * share)))
            continue
        edit.new_floes.append(NewFloe(
            poly=piece, h=0.0,
            mass=view.mass[i] * share,
            u=view.u[i], v=view.v[i],
            ksi=view.ksi[i] * a_p / view.area[i],   # frac_corner.m:119
            dx_p=view.dx_p[i], dy_p=view.dy_p[i],
            du_p=view.du_p[i], dv_p=view.dv_p[i],
            dksi_p=view.dksi_p[i],
            stress_blend=[(i, share)],              # frac_corner.m:103-104
            strain=view.strain[i].copy(),
        ))

def corners_pass(
    view: HostView,
    cfg,
    rng: np.random.Generator,
    contact_points: dict[int, np.ndarray],
    contact_nbrs: dict[int, list[int]],
    touching_boundary: np.ndarray,
    domain_poly: np.ndarray,
) -> StateEdit:
    """One corner-grinding pass.

    contact_points: {slot: [K, 2] contact points}; contact_nbrs:
    {slot: neighbor slot list}; touching_boundary: [N] bool.
    Driver gates (random 30%, overlap cap) are applied by the caller.
    """
    edit = StateEdit()
    n_b = cfg.n_boundary

    for i in range(n_b, view.n):
        if not view.alive[i] or view.polys[i] is None:
            continue
        if i not in contact_points and not touching_boundary[i]:
            continue
        poly = view.poly(i)
        n = len(poly)
        if n < 4:
            continue
        angles = hg.angles_deg(poly)
        anorm = 180.0 - 360.0 / n
        break1 = rng.random(n) > angles / anorm

        # vertex-in-contact mask (corners.m:73-91)
        da = np.zeros(n, bool)
        pts = contact_points.get(i)
        if pts is not None and len(pts):
            d2 = np.sum(
                (poly[:, None, :] - pts[None, :, :]) ** 2, axis=-1
            )
            da[np.argmin(d2, axis=0)] = True
        for j in contact_nbrs.get(i, []):
            if 0 <= j < view.n and view.alive[j] and view.polys[j] is not None:
                # minimum-image shift of the neighbor when PERIODIC (the
                # reference's ghost construction, corners.m:13-49)
                from .host import min_image_shift

                qp = view.poly(j) + min_image_shift(view, i, j, cfg)
                for k in range(n):
                    if _pip(poly[k], qp):
                        da[k] = True
        if touching_boundary[i]:
            for k in range(n):
                if not _pip(poly[k], domain_poly):
                    da[k] = True

        grind = break1 & da
        if grind.sum() > 1:
            grind_floe(view, i, grind, cfg, edit)
    return edit

def _pip(p: np.ndarray, poly: np.ndarray) -> bool:
    x, y = p
    inside = False
    n = len(poly)
    for i in range(n):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % n]
        if (y0 > y) != (y1 > y):
            if x < x0 + (y - y0) / (y1 - y0) * (x1 - x0):
                inside = not inside
    return inside
