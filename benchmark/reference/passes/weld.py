"""Welding — equivalent of ``Physical_Processes/weld.m``.

In freezing conditions, overlapping floes weld (fuse) with probability
``Fweld * A_overlap / area > rand`` (weld.m:104-116), evaluated within
spatial bins at pyramid scales (3x3 every 25 steps with max-area Amax/3,
2x2 every 500 with Amax/2, 1x1 every 5000 — Subzero.m:317-330).  The welded
union also absorbs any neighbor covered >40% by it (weld.m:134-152).  Unions
must stay below 1/5 of the total ice area and above 2e4 m^2 (weld.m:118).
"""

from __future__ import annotations

import numpy as np

from ..polyboolean import poly_boolean, poly_area
from .host import HostView, StateEdit
from .fuse import fuse_floes

def weld_pass(
    view: HostView,
    cfg,
    rng: np.random.Generator,
    nx: int,
    ny: int,
    max_weld_area: float,
) -> StateEdit:
    edit = StateEdit()
    n_b = cfg.n_boundary
    lx, ly = cfg.domain.lx, cfg.domain.ly
    a_total = float(np.sum(view.area[view.alive]))

    live = [i for i in range(n_b, view.n)
            if view.alive[i] and view.polys[i] is not None]
    if not live:
        return edit

    # spatial bins (weld.m:30-48).  Entries are (slot, shift): when PERIODIC
    # a floe crossing +-lx/+-ly also gets minimum-image ghost entries (the
    # reference builds ghost floes before binning, weld.m via
    # floe_interactions_all-style ghosts) so seam-straddling pairs weld.
    entries: list[tuple[int, tuple[float, float]]] = [
        (i, (0.0, 0.0)) for i in live]
    if cfg.processes.periodic:
        for i in live:
            p = view.poly(i)
            shifts = []
            if np.max(np.abs(p[:, 0])) > lx:
                shifts.append((-2 * lx * np.sign(view.x[i]), 0.0))
            if np.max(np.abs(p[:, 1])) > ly:
                shifts.append((0.0, -2 * ly * np.sign(view.y[i])))
            if len(shifts) == 2:
                shifts.append((shifts[0][0], shifts[1][1]))
            entries.extend((i, s) for s in shifts)

    ex = np.array([view.x[i] + s[0] for i, s in entries])
    ey = np.array([view.y[i] + s[1] for i, s in entries])
    bx = np.clip(((ex + lx) / (2 * lx / nx)).astype(int), 0, nx - 1)
    by = np.clip(((ey + ly) / (2 * ly / ny)).astype(int), 0, ny - 1)
    bins: dict[tuple[int, int], list[int]] = {}
    for k in range(len(entries)):
        bins.setdefault((int(bx[k]), int(by[k])), []).append(k)

    def spoly(k):
        i, s = entries[k]
        return view.poly(i) + np.asarray(s)

    fused: set[int] = set()
    for members in bins.values():
        for ai, ka in enumerate(members):
            i, s_i = entries[ka]
            if i in fused or not view.alive[i]:
                continue
            if view.area[i] >= max_weld_area:
                continue
            # candidates: later members within bounding circles (weld.m:96-99)
            cands = []
            for kb in members[ai + 1:]:
                j, s_j = entries[kb]
                if j == i or j in fused or not view.alive[j]:
                    continue
                if s_i != (0.0, 0.0) and s_j != (0.0, 0.0):
                    continue        # ghost-ghost pairs: handled via parents
                if view.area[j] >= max_weld_area:
                    continue
                d = np.hypot(ex[ka] - ex[kb], ey[ka] - ey[kb])
                if 1.0 < d < view.rmax[i] + view.rmax[j]:
                    cands.append(kb)
            if not cands:
                continue
            # overlap areas + weld probability (weld.m:102-116)
            best = None
            best_p = None
            for kb in cands:
                inter = poly_boolean(spoly(ka), spoly(kb), "int")
                a_ov = sum(max(poly_area(c), 0.0) for c in inter)
                if a_ov <= 0:
                    continue
                weldp = cfg.processes.weld_coeff * a_ov / view.area[i]
                if weldp > rng.random():
                    if best_p is None or weldp > best_p:
                        best_p = weldp
                        best = kb
            if best is None:
                continue
            j, s_j = entries[best]
            uni = poly_boolean(spoly(ka), spoly(best), "uni")
            a_uni = sum(max(poly_area(c), 0.0) for c in uni)
            if not (cfg.processes.fuse_min_area < a_uni < a_total / 5):
                continue

            # chain absorption: neighbors covered >40% by the union
            # (weld.m:134-152)
            absorb = []
            overrides = {}
            for kc in members:
                k2, s_k = entries[kc]
                if k2 in (i, j) or k2 in fused or not view.alive[k2]:
                    continue
                d = np.hypot(ex[ka] - ex[kc], ey[ka] - ey[kc])
                if d > view.rmax[i] + view.rmax[j] + view.rmax[k2]:
                    continue
                inter = poly_boolean(uni, spoly(kc), "int")
                a_ov = sum(max(poly_area(c), 0.0) for c in inter)
                if a_ov / view.area[k2] > 0.4 and k2 not in absorb:
                    absorb.append(k2)
                    overrides[k2] = spoly(kc)
            # fuse in floe i's (entry ka's) frame
            overrides[i] = spoly(ka)
            overrides[j] = spoly(best)
            sub = fuse_floes(view, i, [j] + absorb, cfg,
                             poly_override=overrides)
            edit.merge(sub)
            fused |= {i, j, *absorb}
    return edit

def weld_schedule(step_idx: int, cfg, amax: float):
    """Which weld scale fires at this step (Subzero.m:318-330)?

    Returns (nx, ny, max_weld_area) or None.  amax = running max floe area
    (the driver keeps raising it, Subzero.m:321-323).  Scale map per the
    reference: 5000 steps -> 1x1 bins with Amax/2; 500 -> 2x2 with Amax/3;
    25 -> 3x3 with Amax/3.
    """
    p = cfg.processes
    if p.dhdt <= 0:          # freezing gate (Subzero.m:318)
        return None
    if step_idx % p.n_weld_coarse == 0:
        return 1, 1, amax / 2
    if step_idx % p.n_weld_mid == 0:
        return 2, 2, amax / 3
    if step_idx % p.n_weld == 0:
        return 3, 3, amax / 3
    return None
