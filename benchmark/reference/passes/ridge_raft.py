"""Ridging and rafting — equivalents of ``Physical_Processes/ridge.m``,
``ridge_values_update.m``, ``raft.m`` plus their invocation logic in
``floe_interactions_all.m:288-465``.

Both processes transfer the overlap volume from a loser floe to a winner:
the winner thickens (h += V/area, capped at 30 m, inertia scaled h_new/h_old
— ridge_values_update.m:13-18), the loser's shape loses the winner's
footprint (regions above the minimum region area survive, mass
redistributed; ridge_values_update.m:21-68).  They differ only in their
gates:

* ridge:  5% random keep-out, both h < 5 m (ridge_max_h), winner chosen by
  thickness rule with critical thickness hc = 0.2 m (ridge.m:54-65)
* raft:   keep-out prob 0.5*overlapArea/area, both h < 0.25 m (raft_max_h)

plus the shared overlap-fraction gates [1e-6, 0.95] x min(area)
(floe_interactions_all.m:317) and an absolute overlap > 500 m^2 (ridge.m:47).
Mostly-contained floes (overlap > 75% of either) dissolve (ridge.m:33-43).
Boundary ridging (floe crossing the domain wall, h < 1.25 m): the
out-of-domain sliver is cut off and its mass lost (ridge.m:70-138).
"""

from __future__ import annotations

import numpy as np

from ..polyboolean import poly_boolean, poly_area
from . import hostgeom as hg
from .host import HostView, NewFloe, StateEdit, candidate_pairs

HC = 0.2  # critical thickness (ridge.m:27)

def _loser_update(view: HostView, loser: int, winner_poly: np.ndarray,
                  v_lost: float, cfg, edit: StateEdit) -> None:
    """Cut the winner's footprint out of the loser and redistribute its
    remaining mass (ridge_values_update.m:21-68)."""
    rho = cfg.physics.rho_ice
    res = poly_boolean(view.poly(loser), winner_poly, "dif")
    regions = [c for c in res if poly_area(c) > cfg.processes.min_region_area]
    m_left = view.mass[loser] - v_lost * rho
    if not regions or m_left <= 0:
        # The winner already absorbed v_lost*rho of the loser's mass: kill
        # the slot and bin only the REMAINDER to dissolved (a dissolve_kill
        # would bin the full mass and double-count the transferred volume).
        edit.kills.add(loser)
        if m_left > 0:
            edit.dissolve_mass.append(
                (float(view.x[loser]), float(view.y[loser]), float(m_left)))
        return
    regions.sort(key=poly_area, reverse=True)
    a_tot = sum(poly_area(c) for c in regions)
    # largest region keeps the slot (identity/kinematics/stress preserved)
    edit.reshapes[loser] = (regions[0], poly_area(regions[0]) / a_tot * m_left)
    for c in regions[1:]:
        edit.new_floes.append(NewFloe(
            poly=c, h=0.0, mass=poly_area(c) / a_tot * m_left,
            u=view.u[loser], v=view.v[loser], ksi=view.ksi[loser],
            dx_p=view.dx_p[loser], dy_p=view.dy_p[loser],
            du_p=view.du_p[loser], dv_p=view.dv_p[loser],
            dksi_p=view.dksi_p[loser],
            stress_blend=[(loser, 1.0)],
            strain=view.strain[loser].copy(),
        ))

def _winner_update(view: HostView, winner: int, v_gain: float,
                   cfg, edit: StateEdit) -> None:
    """Winner thickens (ridge_values_update.m:11-18)."""
    rho = cfg.physics.rho_ice
    h_old = edit.updates.get(winner, {}).get("h", view.h[winner])
    m_old = edit.updates.get(winner, {}).get("mass", view.mass[winner])
    i_old = edit.updates.get(winner, {}).get("inertia", view.inertia[winner])
    h_new = min(h_old + v_gain / view.area[winner],
                cfg.processes.max_ridge_h)
    edit.updates.setdefault(winner, {}).update(
        h=h_new, mass=m_old + v_gain * rho,
        inertia=h_new / h_old * i_old,
    )

def ridge_raft_pass(
    view: HostView,
    cfg,
    rng: np.random.Generator,
    mode: str,                      # "ridge" | "raft"
    domain_poly: np.ndarray,
) -> StateEdit:
    edit = StateEdit()
    proc = cfg.processes
    n_b = cfg.n_boundary
    h = view.h

    if mode == "ridge":
        h_max = proc.ridge_max_h
        keep_out = rng.random(view.n) < proc.ridge_keep_prob
    else:
        h_max = proc.raft_max_h
        ov_frac = view.overlap_area / np.maximum(view.area, 1e-12)
        keep_out = rng.random(view.n) > 0.5 * ov_frac

    processed = np.zeros(view.n, bool)  # Ridged/Rafted flags
    # Spatial-hash broad phase; shift = minimum-image translation of floe j
    # (periodic ghosts, floe_interactions_all.m:288-327 operate on the
    # ghost-extended list in the reference).  ``pairs`` may be supplied by
    # the caller from the device step's aux neighbor table.
    pairs = candidate_pairs(view, cfg)

    for i, j, shift in pairs:
        if i < n_b and j < n_b:
            continue
        if keep_out[i] or processed[i] or processed[j]:
            continue
        if h[i] >= h_max or h[j] >= h_max:
            continue
        if i in edit.dissolve_kills or j in edit.dissolve_kills:
            continue
        if i in edit.reshapes or j in edit.reshapes:
            continue
        poly_j = view.poly(j) + np.asarray(shift)
        inter = poly_boolean(view.poly(i), poly_j, "int")
        a_ov = sum(max(poly_area(c), 0.0) for c in inter)
        if a_ov <= 0:
            continue
        frac = a_ov / min(view.area[i], view.area[j])
        if not (proc.overlap_frac_min < frac < proc.overlap_frac_max):
            continue
        # containment dissolution (ridge.m:33-43)
        if a_ov / view.area[i] > 0.75 or view.area[i] < cfg.min_floe_size:
            edit.dissolve_kills.add(i)
            continue
        if a_ov / view.area[j] > 0.75 or view.area[j] < cfg.min_floe_size:
            edit.dissolve_kills.add(j)
            continue
        if a_ov <= 500.0:
            continue

        # winner selection (ridge.m:54-65); rafting favors neither by
        # thickness (both below hc) -> the same random rule applies
        hi, hj = h[i], h[j]
        if hi >= HC and hj >= HC:
            p = 1.0 / (1.0 + hi / hj)
            i_wins = rng.random() >= p
        elif hi >= HC:
            i_wins = True
        elif hj >= HC:
            i_wins = False
        else:
            # both thin (always the case for rafting): random by thickness
            p = 1.0 / (1.0 + hi / hj)
            i_wins = rng.random() >= p
        winner, loser = (i, j) if i_wins else (j, i)
        if loser < n_b:
            winner, loser = loser, winner  # never reshape boundary floes
        if winner < n_b:
            continue
        v = a_ov * h[loser]
        _winner_update(view, winner, v, cfg, edit)
        # winner footprint expressed in the LOSER's frame (undo the
        # minimum-image shift when the loser is the shifted floe j)
        if winner == i:
            w_poly = view.poly(i) - np.asarray(shift)
        else:
            w_poly = poly_j
        _loser_update(view, loser, w_poly, v, cfg, edit)
        processed[i] = processed[j] = True

    # ---- boundary ridging (ridge.m:70-138) -------------------------------
    for i in range(n_b, view.n):
        if not view.alive[i] or view.polys[i] is None or processed[i]:
            continue
        if i in edit.dissolve_kills or i in edit.reshapes:
            continue
        h_gate = proc.ridge_boundary_max_h if mode == "ridge" else proc.raft_max_h
        if h[i] >= h_gate:
            continue
        if view.area[i] <= cfg.min_floe_size:
            continue
        outside = poly_boolean(view.poly(i), domain_poly, "dif")
        a_out = sum(max(poly_area(c), 0.0) for c in outside)
        if a_out <= 0:
            continue
        kept = poly_boolean(view.poly(i), domain_poly, "int")
        regions = [c for c in kept
                   if poly_area(c) > cfg.processes.min_region_area]
        if not regions:
            edit.dissolve_kills.add(i)
            continue
        regions.sort(key=poly_area, reverse=True)
        a_tot = sum(poly_area(c) for c in regions)
        # the FULL floe mass redistributes over the kept in-domain regions
        # (ridge.m:110: mass = area/Atot*Floe1.mass): the floe thickens —
        # ridging against the wall conserves mass
        edit.reshapes[i] = (
            regions[0], poly_area(regions[0]) / a_tot * view.mass[i]
        )
        for c in regions[1:]:
            edit.new_floes.append(NewFloe(
                poly=c, h=0.0, mass=poly_area(c) / a_tot * view.mass[i],
                u=view.u[i], v=view.v[i], ksi=view.ksi[i],
                dx_p=view.dx_p[i], dy_p=view.dy_p[i],
                du_p=view.du_p[i], dv_p=view.dv_p[i],
                dksi_p=view.dksi_p[i],
                stress_blend=[(i, 1.0)],
                strain=view.strain[i].copy(),
            ))
    return edit
