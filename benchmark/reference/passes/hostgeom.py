"""Host-side (numpy) polygon property helpers shared by the lifecycle
processes.  Same Green's-theorem math as geometry/polygon.py, on plain
``[n, 2]`` contours."""

from __future__ import annotations

import numpy as np


def area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def centroid(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    w = x * yn - xn * y
    a = 0.5 * np.sum(w)
    if abs(a) < 1e-12:
        return poly.mean(axis=0)
    return np.array([np.sum(w * (x + xn)), np.sum(w * (y + yn))]) / (6.0 * a)


def inertia_z(poly: np.ndarray, h: float, rho: float = 920.0) -> float:
    """Polar second moment about the polygon's centroid x thickness x rho
    (PolygonMoments.m:29-32 convention)."""
    c = centroid(poly)
    p = poly - c
    x, y = p[:, 0], p[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    w = x * yn - xn * y
    ixx = np.sum(w * ((y + yn) ** 2 - y * yn)) / 12.0
    iyy = np.sum(w * ((x + xn) ** 2 - x * xn)) / 12.0
    return float(abs(ixx + iyy) * h * rho)


def rmax_of(poly: np.ndarray) -> float:
    c = centroid(poly)
    return float(np.sqrt(np.max(np.sum((poly - c) ** 2, axis=1))))


def angles_deg(poly: np.ndarray) -> np.ndarray:
    """Interior angles in degrees for a CCW contour (polyangles.m)."""
    prev = np.roll(poly, 1, axis=0)
    nxt = np.roll(poly, -1, axis=0)
    e1 = nxt - poly
    e2 = prev - poly
    ang = np.arctan2(
        e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
        np.sum(e1 * e2, axis=1),
    )
    ang = np.where(ang < 0, ang + 2 * np.pi, ang)
    return np.degrees(ang)
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
