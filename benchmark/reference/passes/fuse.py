"""Floe fusion — batched equivalent of ``Physical_Processes/Fuse_Floes.m``.

Union of two (or more) floes conserving mass, linear momentum, angular
momentum (inertia-weighted about the union centroid), AB2 tendency history,
and mass-weighted stress (Fuse_Floes.m:33-68).  Regions of the union below
the minimum region area are dropped (their mass share redistributed by area,
:15-26).  NOTE: the reference's debug ``save('FuseFloesArctoc.mat', ...)``
side effect (:6) is intentionally not replicated (SURVEY.md section 2).
"""

from __future__ import annotations

import numpy as np

from ..polyboolean import poly_boolean, poly_area
from . import hostgeom as hg
from .host import HostView, NewFloe, StateEdit

def _outer_regions(contours: list[np.ndarray], min_area: float):
    """CCW outer contours above the area threshold (rmholes + area cull)."""
    outers = [c for c in contours if poly_area(c) > 0]
    return [c for c in outers if poly_area(c) > min_area]

def fuse_floes(view: HostView, i: int, js: list[int],
               cfg,
               poly_override: dict[int, np.ndarray] | None = None
               ) -> StateEdit:
    """Fuse floe ``i`` with floes ``js`` into new floes (Fuse_Floes.m).

    ``poly_override``: replacement world polygons per slot — used by the
    periodic weld pass to fuse against minimum-image shifted copies of
    floes that sit across the torus seam.
    """
    edit = StateEdit()
    members = [i] + list(js)
    ovr = poly_override or {}
    polys = [ovr.get(k, view.poly(k)) for k in members]
    uni = polys[0]
    uni = [uni]
    for p in polys[1:]:
        uni = poly_boolean(uni, p, "uni")
    regions = _outer_regions(uni, cfg.processes.min_region_area)
    if not regions:
        return edit

    m = view.mass[members]
    mtot = float(m.sum())
    a_tot = sum(poly_area(r) for r in regions)

    # mass/momentum/angular-momentum conservation (Fuse_Floes.m:34-45)
    u_new = float(np.sum(view.u[members] * m) / mtot)
    v_new = float(np.sum(view.v[members] * m) / mtot)
    du_p = float(np.sum(view.du_p[members] * m) / mtot)
    dv_p = float(np.sum(view.dv_p[members] * m) / mtot)
    dx_p = float(np.sum(view.dx_p[members] * m) / mtot)
    dy_p = float(np.sum(view.dy_p[members] * m) / mtot)

    # Combined inertia of the NEW regions about the union centroid
    # (parallel-axis, Fuse_Floes.m:36-39); angular momentum of the parents
    # (ksi-weighted by parent inertia) is conserved against it (:42,:45).
    cen = sum(hg.area(r) * hg.centroid(r) for r in regions) / max(a_tot, 1e-12)
    i_new = 0.0
    for r in regions:
        a_r = hg.area(r)
        mass_r = a_r / a_tot * mtot
        h_r = mass_r / (cfg.physics.rho_ice * a_r)
        d2 = float(np.sum((hg.centroid(r) - cen) ** 2))
        i_new += hg.inertia_z(r, h_r, cfg.physics.rho_ice) + mass_r * d2

    i_par = view.inertia[members]
    ksi_new = float(np.sum(view.ksi[members] * i_par) / i_new)
    dksi_p = float(np.sum(view.dksi_p[members] * i_par) / i_new)

    blend = [(k, float(mk / mtot)) for k, mk in zip(members, m)]
    for r in regions:
        mass_r = poly_area(r) / a_tot * mtot
        edit.new_floes.append(NewFloe(
            poly=r, h=0.0, mass=mass_r,
            u=u_new, v=v_new, ksi=ksi_new,
            dx_p=dx_p, dy_p=dy_p, du_p=du_p, dv_p=dv_p, dksi_p=dksi_p,
            stress_blend=blend,
            strain=view.strain[i].copy(),
        ))
    edit.kills |= set(members)
    return edit
