"""New-ice packing — equivalent of ``Physical_Processes/create_new_ice.m``.

Every ``n_pack`` steps in freezing conditions, open water is filled with new
thin floes: per coarse cell, if the ice concentration is below
0.999 x target (create_new_ice.m:125-128), the cell is Voronoi-partitioned
with 3-5 random generators (:132-143); each piece minus the existing floes,
clipped to the cell, becomes new floes of the thermodynamic pack thickness
h0 (initialize_ocean.m:44) when above the minimum floe size (:146-154).

Hole handling (create_new_ice.m:158-251): new ice cannot have holes, so a
piece that encloses existing floes is filled (``rmholes``) with its thickness
reduced to conserve mass (:160-165); enclosed *simulation* floes are fused
into the new floe, conserving mass and momentum (:219-233); enclosed
*boundary/topography* floes instead split the new floe along a horizontal
line through the topography centroid (``cutpolygon``) and the topography
footprint is subtracted (:192-212).

Periodicity: when PERIODIC the reference packs using ghost floes
(create_new_ice.m:21-66); here existing-floe coverage is computed with
minimum-image shifted copies of floes that straddle the torus seam.
"""

from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..geometry.measures import cut_polygon
from ..init import bounded_voronoi
from ..native import poly_boolean, poly_area, union_all
from .host import HostView, NewFloe, StateEdit


def _signed_area(c: np.ndarray) -> float:
    x, y = c[:, 0], c[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _centroid(c: np.ndarray) -> np.ndarray:
    x, y = c[:, 0], c[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    w = x * yn - xn * y
    a = 0.5 * np.sum(w)
    if a == 0:
        return c.mean(axis=0)
    return np.array([np.sum(w * (x + xn)), np.sum(w * (y + yn))]) / (6.0 * a)


def _point_in(px: float, py: float, c: np.ndarray) -> bool:
    x0, y0 = c[:, 0], c[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    cond = (y0 > py) != (y1 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(y1 == y0, 0.0,
                     (py - y0) / np.where(y1 == y0, 1.0, y1 - y0))
    xint = x0 + t * (x1 - x0)
    return bool(np.sum(cond & (px < xint)) % 2)


def _mirror_copies(view: HostView, i: int, lx: float, ly: float):
    """Minimum-image ghost polygons of floe i across the torus seam
    (create_new_ice.m:21-66 ghost construction)."""
    p = view.poly(i)
    out = [p]
    shifts = []
    if np.max(np.abs(p[:, 0])) > lx:
        shifts.append((-2 * lx * np.sign(view.x[i]), 0.0))
    if np.max(np.abs(p[:, 1])) > ly:
        shifts.append((0.0, -2 * ly * np.sign(view.y[i])))
    if len(shifts) == 2:  # corner floe: diagonal ghost too
        shifts.append((shifts[0][0], shifts[1][1]))
    for s in shifts:
        out.append(p + np.asarray(s))
    return out


def pack_pass(
    view: HostView,
    cfg: SimConfig,
    rng: np.random.Generator,
    h0: float,
    target: float = 1.0,
    nx: int = 10,
    ny: int = 10,
    conc: np.ndarray | None = None,
) -> StateEdit:
    """``conc``: optional precomputed coverage fraction [ny, nx] with row 0
    = NORTH (diagnostics.coverage_fraction, device scatter kernel).  When
    given, the per-(cell, floe) native concentration loop is skipped —
    the host only runs the (sparse) under-target cells."""
    edit = StateEdit()
    lx, ly = cfg.domain.lx, cfg.domain.ly
    periodic = cfg.processes.periodic
    xe = np.linspace(-lx, lx, nx + 1)
    ye = np.linspace(-ly, ly, ny + 1)
    cell_area = (2 * lx / nx) * (2 * ly / ny)
    r_cell = 0.5 * np.hypot(2 * lx / nx, 2 * ly / ny)
    nb = cfg.n_boundary

    live = [i for i in range(view.n)
            if view.alive[i] and view.polys[i] is not None]
    # world + minimum-image ghost contours per floe (periodic only)
    contours = {
        i: (_mirror_copies(view, i, lx, ly) if periodic else [view.poly(i)])
        for i in live
    }
    fused_already: set[int] = set()

    # vectorized per-cell broad phase (a Python loop over cells x floes is
    # minutes by itself at 10k floes x 32x32 cells)
    live_a = np.asarray(live, dtype=np.int64)
    lx_a = np.asarray([view.x[i] for i in live])
    ly_a = np.asarray([view.y[i] for i in live])
    lr_a = np.asarray([view.rmax[i] for i in live])
    ghosted = np.asarray([periodic and len(contours[i]) > 1 for i in live])

    for ci in range(nx):
        for cj in range(ny):
            x0, x1 = xe[ci], xe[ci + 1]
            y0, y1 = ye[cj], ye[cj + 1]
            box = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            cx, cy = (x0 + x1) / 2, (y0 + y1) / 2

            # concentration in the cell (create_new_ice.m:109-125): from
            # the device kernel when provided, else exact host booleans
            if conc is not None and conc[ny - 1 - cj, ci] >= 0.999 * target:
                continue
            near_m = ((lx_a - cx) ** 2 + (ly_a - cy) ** 2
                      < (lr_a + r_cell) ** 2) | ghosted
            near = [int(i) for i in live_a[near_m]]
            if conc is not None:
                in_box = near
            else:
                a_cov = 0.0
                in_box = []
                for i in near:
                    a_i = 0.0
                    for c in contours[i]:
                        inter = poly_boolean(c, box, "int")
                        a_i += sum(max(poly_area(r), 0.0) for r in inter)
                    if a_i > 0:
                        in_box.append(i)
                    a_cov += a_i
                if a_cov / cell_area >= 0.999 * target:
                    continue

            # Voronoi partition of the cell (create_new_ice.m:132-143)
            n_gen = int(np.ceil(target * cell_area / (50 * cfg.min_floe_size)))
            n_gen = min(max(n_gen, 3), 5)
            seeds = np.stack([
                cx + r_cell * (2 * rng.random(n_gen) - 1),
                cy + r_cell * (2 * rng.random(n_gen) - 1),
            ], axis=1)
            bbox = np.array([[-1.0, -1], [1, -1], [1, 1], [-1, 1]]) * r_cell \
                + np.array([cx, cy])
            cells = bounded_voronoi(seeds, bbox)

            # Per Voronoi sub-cell, subtract the floes that can touch it
            # (create_new_ice.m:144-154).  bbox prefilters skip floes that
            # cannot touch a piece; pieces already below min_floe_size can
            # only shrink and are culled early (their finals are skipped at
            # the threshold test anyway — holes are kept so the hole path
            # still fires for fully-enclosed floes).
            for cell in cells:
                if len(cell) < 3:
                    continue
                pieces = [np.asarray(cell)]
                for i in in_box:
                    nxt = []
                    for p in pieces:
                        acc = [p]
                        for cc in contours[i]:
                            cc = np.asarray(cc)
                            cmin, cmax = cc.min(0), cc.max(0)
                            sub = []
                            for q in acc:
                                q = np.asarray(q)
                                if (np.any(cmin > q.max(0))
                                        or np.any(cmax < q.min(0))):
                                    sub.append(q)
                                    continue
                                sub.extend(poly_boolean(q, cc, "dif"))
                            acc = sub
                            if not acc:
                                break
                        for q in acc:
                            q = np.asarray(q)
                            a = _signed_area(q)
                            if (a > cfg.min_floe_size
                                    or (a < 0 and abs(a) > 1.0)):
                                nxt.append(q)
                    pieces = nxt
                    if not pieces:
                        break
                finals = []
                for p in pieces:
                    finals.extend(poly_boolean(p, box, "int"))

                outers = [np.asarray(p) for p in finals
                          if _signed_area(np.asarray(p)) > 0]
                holes = [np.asarray(p) for p in finals
                         if _signed_area(np.asarray(p)) < 0]

                for outer in outers:
                    my_holes = [h for h in holes
                                if _point_in(*_centroid(h), outer)]
                    a_full = _signed_area(outer)
                    a_net = a_full + sum(_signed_area(h) for h in my_holes)
                    if a_net <= cfg.min_floe_size:
                        continue
                    if not my_holes:
                        edit.new_floes.append(
                            NewFloe(poly=outer, h=h0, stress_blend=[]))
                        continue

                    # ---- hole path (create_new_ice.m:158-251) -----------
                    # filled floe, thinner so mass matches the net area
                    h_new = a_net * h0 / a_full              # (:163)
                    # enclosed existing floes: >99% of their area inside
                    enclosed = []
                    for i in in_box:
                        if i in fused_already:
                            continue
                        a_i = sum(
                            max(poly_area(r), 0.0)
                            for cc in contours[i]
                            for r in poly_boolean(cc, outer, "int"))
                        if a_i / max(view.area[i], 1e-12) > 0.99:
                            enclosed.append(i)
                    topo = [i for i in enclosed if i < nb]
                    sim = [i for i in enclosed if i >= nb]

                    pieces2 = [outer]
                    if topo:
                        # split through each topography centroid along a
                        # horizontal line, keep both sides, subtract the
                        # topography (create_new_ice.m:192-212)
                        for b in topo:
                            yb = view.y[b]
                            nxt = []
                            for p in pieces2:
                                top = cut_polygon(p, (0.0, yb), (1.0, yb), 1)
                                bot = cut_polygon(p, (0.0, yb), (1.0, yb), 2)
                                for half in (top, bot):
                                    if half is not None and len(half) >= 3 \
                                            and abs(_signed_area(half)) > 0:
                                        nxt.append(half)
                            pieces2 = nxt
                        topo_union = union_all([view.poly(b) for b in topo])
                        nxt = []
                        for p in pieces2:
                            acc = [p]
                            for tu in topo_union:
                                sub = []
                                for q in acc:
                                    sub.extend(poly_boolean(q, tu, "dif"))
                                acc = sub
                            nxt.extend(a for a in acc
                                       if _signed_area(np.asarray(a)) > 0)
                        pieces2 = [np.asarray(p) for p in nxt]

                    new_here = [
                        NewFloe(poly=p, h=h_new, stress_blend=[])
                        for p in pieces2
                        if _signed_area(p) > cfg.processes.min_region_area
                    ]
                    if not new_here:
                        continue

                    # fuse each enclosed simulation floe into the new piece
                    # it overlaps most, conserving mass and momentum
                    # (create_new_ice.m:219-233 via Fuse_Floes)
                    for i in sim:
                        ovl = []
                        for nf in new_here:
                            a_i = sum(max(poly_area(r), 0.0) for r in
                                      poly_boolean(view.poly(i), nf.poly,
                                                   "int"))
                            ovl.append(a_i)
                        k = int(np.argmax(ovl))
                        nf = new_here[k]
                        a_nf = _signed_area(nf.poly)
                        m_nf = (nf.mass if nf.mass is not None
                                else a_nf * nf.h * cfg.physics.rho_ice)
                        m_i = float(view.mass[i])
                        m_tot = m_nf + m_i
                        nf.u = (nf.u * m_nf + view.u[i] * m_i) / m_tot
                        nf.v = (nf.v * m_nf + view.v[i] * m_i) / m_tot
                        nf.du_p = (nf.du_p * m_nf
                                   + view.du_p[i] * m_i) / m_tot
                        nf.dv_p = (nf.dv_p * m_nf
                                   + view.dv_p[i] * m_i) / m_tot
                        nf.mass = m_tot
                        nf.stress_blend.append((i, m_i / m_tot))
                        edit.kills.add(i)       # mass-conserving kill
                        fused_already.add(i)

                    edit.new_floes.extend(new_here)
    return edit
