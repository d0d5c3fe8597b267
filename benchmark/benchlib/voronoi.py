"""The benchmark's floe-field generator: a frozen copy of
``subzero_tpu_torch/init.py`` (``_clip_halfplane``, ``bounded_voronoi``,
``_simplify_to_cap``, ``voronoi_floe_field``) at commit 61c7962, so the
inputs a seed makes do not move when the program's generator changes.
The one change: ``voronoi_floe_field`` takes the domain half-widths and
the vertex cap instead of a ``SimConfig``.

Replaces ``Initialize_Model/initial_concentration.m`` +
``polygon_operations/polybnd_voronoi.m``: per coarse cell, scatter random
seeds, build the bounded Voronoi tessellation of the cell, and keep adding
cells as floes until the target concentration is met.
"""

from __future__ import annotations

import numpy as np


def _clip_halfplane(poly: np.ndarray, a: np.ndarray, b: float) -> np.ndarray:
    """Clip polygon to the half-plane a.x <= b (Sutherland-Hodgman step)."""
    if len(poly) == 0:
        return poly
    d = poly @ a - b
    out = []
    n = len(poly)
    for i in range(n):
        j = (i + 1) % n
        if d[i] <= 0:
            out.append(poly[i])
            if d[j] > 0:
                t = d[i] / (d[i] - d[j])
                out.append(poly[i] + t * (poly[j] - poly[i]))
        elif d[j] <= 0:
            t = d[i] / (d[i] - d[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, 2))


def bounded_voronoi(seeds: np.ndarray, boundary: np.ndarray) -> list[np.ndarray]:
    """Voronoi cells of ``seeds`` clipped to the convex CCW ``boundary``.

    Returns one (possibly empty) polygon per seed (polybnd_voronoi.m analog).
    """
    cells = []
    for i, s in enumerate(seeds):
        cell = boundary.copy()
        for j, t in enumerate(seeds):
            if i == j or len(cell) == 0:
                continue
            # half-plane closer to s than t: (x - m)·(t - s) <= 0
            d = t - s
            m = 0.5 * (s + t)
            cell = _clip_halfplane(cell, d, float(d @ m))
        cells.append(cell)
    return cells


def _simplify_to_cap(poly: np.ndarray, v_max: int) -> np.ndarray:
    """Drop shortest-edge vertices until the polygon fits the vertex cap."""
    poly = np.asarray(poly, dtype=np.float64)
    while len(poly) > v_max:
        e = poly - np.roll(poly, 1, axis=0)
        k = int(np.argmin(np.sum(e * e, axis=1)))
        poly = np.delete(poly, k, axis=0)
    return poly


def voronoi_floe_field(
    lx: float,
    ly: float,
    v_cap: int,
    target_concentration: np.ndarray | float = 1.0,
    n_floes: int = 10,
    height_mean: float = 0.25,
    height_delta: float = 0.0,
    min_floe_size: float | None = None,
    seed: int = 0,
) -> tuple[list[np.ndarray], np.ndarray]:
    """Generate initial floe polygons + thicknesses.

    Mirrors initial_concentration.m: per cell of the target-concentration
    matrix, N = ceil(NumFloes * cellarea/domainarea / c) seeds jittered into
    the middle 97.5% of the cell, bounded-Voronoi tessellated, cells added
    until the concentration target is met; floes below min_floe_size culled.
    Thickness h = mean + delta*(2U-1) (initialize_floe_values.m:10).
    """
    rng = np.random.default_rng(seed)
    tc = np.atleast_2d(np.asarray(target_concentration, dtype=np.float64))
    ny, nx = tc.shape
    tc = np.flipud(tc)  # row 0 = south inside this function, like flipud(c)
    xe = np.linspace(-lx, lx, nx + 1)
    ye = np.linspace(-ly, ly, ny + 1)
    if min_floe_size is None:
        min_floe_size = 4 * lx * ly / 10000.0  # Subzero.m:55

    domain_area = 4 * lx * ly
    polys: list[np.ndarray] = []
    for jj in range(ny):
        for ii in range(nx):
            c = tc[jj, ii]
            if c <= 0:
                continue
            x0, x1 = xe[ii], xe[ii + 1]
            y0, y1 = ye[jj], ye[jj + 1]
            cell = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            cell_area = (x1 - x0) * (y1 - y0)
            n = int(np.ceil(n_floes * cell_area / domain_area / c))
            sx = 0.975 * (x1 - x0) / 2 * (2 * rng.random(n) - 1) + (x0 + x1) / 2
            sy = 0.975 * (y1 - y0) / 2 * (2 * rng.random(n) - 1) + (y0 + y1) / 2
            seeds = np.stack([sx, sy], axis=1)
            cells = bounded_voronoi(seeds, cell)
            a_tot = 0.0
            for poly in cells:
                if a_tot / cell_area > c:
                    break
                if len(poly) < 3:
                    continue
                x, y = poly[:, 0], poly[:, 1]
                a = 0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
                if a <= 0:
                    continue
                # cap at the arrays' live vertex rung (verts_now == the
                # fidelity cap unless the caller pinned active_verts lower;
                # make_floe_arrays builds [N, verts_now, 2] and would raise
                # on a wider polygon)
                polys.append(_simplify_to_cap(poly, v_cap))
                a_tot += a

    # min-size cull (initial_concentration.m:48-49)
    kept = []
    for p in polys:
        x, y = p[:, 0], p[:, 1]
        a = 0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
        if a >= min_floe_size:
            kept.append(p)
    heights = height_mean + height_delta * (2 * rng.random(len(kept)) - 1)
    return kept, heights
