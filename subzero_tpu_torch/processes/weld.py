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

from ..config import SimConfig
from ..native import poly_boolean, poly_area
from ..trace import count
from .host import HostView, StateEdit
from .fuse import fuse_floes


def weld_pass(
    view: HostView,
    cfg: SimConfig,
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

    # Per-entry columns for the row tests.  Every entry's slot is alive
    # (``live``) and the view does not change during the pass.  The area
    # test is the scalar expression, once an entry: numpy may promote a
    # Python float against an array otherwise than against a scalar.  The
    # distance tests are the pair loop's arithmetic on the same arrays,
    # element by element.
    area, rmax = view.area, view.rmax
    slot = np.array([i for i, _ in entries], dtype=np.int64)
    ghost = np.array([s != (0.0, 0.0) for _, s in entries])
    small_e = np.array([not area[i] >= max_weld_area for i, _ in entries],
                       dtype=bool)
    rmax_e = rmax[slot]

    def spoly(k):
        i, s = entries[k]
        return view.poly(i) + np.asarray(s)

    n_pairs = 0
    n_clips = 0
    fused: set[int] = set()
    for members in bins.values():
        mem = np.asarray(members)
        m_slot, m_ghost = slot[mem], ghost[mem]
        m_ex, m_ey, m_rmax = ex[mem], ey[mem], rmax_e[mem]
        m_ok = small_e[mem]
        for ai, ka in enumerate(members):
            i = entries[ka][0]
            if i in fused or area[i] >= max_weld_area:
                continue
            # candidates: later members within bounding circles
            # (weld.m:96-99).  At 1x1 bins a floe's own ghost shares its
            # bin, 2 lx or 2 ly away: "!= i" keeps it out, as the pair loop
            # did, even for a floe whose rmax passes lx.
            rest = slice(ai + 1, None)
            n_pairs += len(members) - ai - 1
            d = np.hypot(ex[ka] - m_ex[rest], ey[ka] - m_ey[rest])
            mask = m_ok[rest] & (m_slot[rest] != i) & (1.0 < d) \
                & (d < rmax[i] + m_rmax[rest])
            if m_ghost[ai]:
                mask &= ~m_ghost[rest]  # ghost-ghost pairs: via parents
            cands = [members[t] for t in np.flatnonzero(mask) + ai + 1
                     if m_slot[t] not in fused]
            if not cands:
                continue
            # overlap areas + weld probability (weld.m:102-116)
            best = None
            best_p = None
            for kb in cands:
                inter = poly_boolean(spoly(ka), spoly(kb), "int")
                n_clips += 1
                a_ov = sum(max(poly_area(c), 0.0) for c in inter)
                if a_ov <= 0:
                    continue
                weldp = cfg.processes.weld_coeff * a_ov / area[i]
                if weldp > rng.random():
                    if best_p is None or weldp > best_p:
                        best_p = weldp
                        best = kb
            if best is None:
                continue
            j, s_j = entries[best]
            uni = poly_boolean(spoly(ka), spoly(best), "uni")
            n_clips += 1
            a_uni = sum(max(poly_area(c), 0.0) for c in uni)
            if not (cfg.processes.fuse_min_area < a_uni < a_total / 5):
                continue

            # chain absorption: neighbors covered >40% by the union
            # (weld.m:134-152); "not >" keeps a NaN distance a candidate
            n_pairs += len(members)
            d = np.hypot(ex[ka] - m_ex, ey[ka] - m_ey)
            near = ~(d > rmax[i] + rmax[j] + m_rmax)
            absorb = []
            overrides = {}
            for t in np.flatnonzero(near):
                kc = members[t]
                k2 = entries[kc][0]
                if k2 in (i, j) or k2 in fused:
                    continue
                inter = poly_boolean(uni, spoly(kc), "int")
                n_clips += 1
                a_ov = sum(max(poly_area(c), 0.0) for c in inter)
                if a_ov / area[k2] > 0.4 and k2 not in absorb:
                    absorb.append(k2)
                    overrides[k2] = spoly(kc)
            # fuse in floe i's (entry ka's) frame
            overrides[i] = spoly(ka)
            overrides[j] = spoly(best)
            sub = fuse_floes(view, i, [j] + absorb, cfg,
                             poly_override=overrides)
            edit.merge(sub)
            fused |= {i, j, *absorb}
    # the pairs the row tests covered, and the clips they led to
    count("weld.pairs", n_pairs)
    count("weld.clips", n_clips)
    return edit


def weld_schedule(step_idx: int, cfg: SimConfig, amax: float):
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
