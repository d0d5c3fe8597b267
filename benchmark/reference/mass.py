"""Floe geometry and mass from polygons, in float64: the reference's side
of the mass ledger and of the start check."""

from __future__ import annotations

import numpy as np


def padded_areas(verts: np.ndarray, nv: np.ndarray) -> np.ndarray:
    """Shoelace area of each padded polygon ``verts [N, V, 2]`` over its
    first ``nv`` vertices."""
    v = np.asarray(verts, np.float64)
    n, vmax = v.shape[:2]
    k = np.arange(vmax)[None, :]
    live = k < np.asarray(nv)[:, None]
    nxt = np.where(k + 1 < np.asarray(nv)[:, None], k + 1, 0)
    x0, y0 = v[..., 0], v[..., 1]
    x1 = np.take_along_axis(x0, nxt, axis=1)
    y1 = np.take_along_axis(y0, nxt, axis=1)
    return 0.5 * np.abs(np.sum(np.where(live, x0 * y1 - x1 * y0, 0.0),
                               axis=1))


def floe_masses(verts, nv, h, rho_ice: float) -> np.ndarray:
    """rho h A of each floe, A from its polygon."""
    return rho_ice * np.asarray(h, np.float64) * padded_areas(verts, nv)


def polygon_props(polys) -> tuple[np.ndarray, np.ndarray]:
    """(area [n], centroid [n, 2]) of world-frame polygons."""
    area = np.empty(len(polys))
    cen = np.empty((len(polys), 2))
    for i, p in enumerate(polys):
        x, y = np.asarray(p, np.float64).T
        xn, yn = np.roll(x, -1), np.roll(y, -1)
        w = x * yn - xn * y
        a = 0.5 * np.sum(w)
        area[i] = abs(a)
        cen[i] = (np.sum(w * (x + xn)) / (6 * a), np.sum(w * (y + yn)) / (6 * a))
    return area, cen


def ledger_total(verts, nv, h, alive, rho_ice: float, dissolved: float,
                 exported: float) -> float:
    """Floe mass (from polygons) + dissolved + exported, kg."""
    al = np.asarray(alive, bool)
    m = floe_masses(np.asarray(verts)[al], np.asarray(nv)[al],
                    np.asarray(h)[al], rho_ice)
    return float(np.sum(m)) + float(dissolved) + float(exported)
