"""Polygon measures completing the reference's polygon library — port of
``subzero_tpu/geometry/measures.py``:

* ``segment_intersections`` — curve-curve intersection points, the
  ``collisions/InterX.m`` equivalent (the contact path uses crossing counts;
  this returns the points).
* ``point_poly_dist``       — signed minimum distance from points to a
  polygon boundary, the ``polygon_operations/p_poly_dist.m`` equivalent
  (negative inside).
* ``cut_polygon``           — split a polygon by a line and keep one side,
  the ``polygon_operations/cutpolygon.m`` equivalent (host-side numpy; the
  new-ice packing's topography splits use it).
"""

from __future__ import annotations

import numpy as np
import torch

from .polygon import points_in_polygon, poly_edges

__all__ = ["segment_intersections", "point_poly_dist", "cut_polygon"]


def segment_intersections(p: torch.Tensor, q: torch.Tensor, max_points: int):
    """Intersection points of two padded closed polylines (InterX.m).

    p: [Vp, 2], q: [Vq, 2] padded CCW polygons.  Returns (points
    [max_points, 2], valid [max_points], count) with the first ``count``
    slots holding real crossings in edge order (half-open edge rule, each
    crossing once).
    """
    p0, p1 = poly_edges(p)
    q0, q1 = poly_edges(q)
    dp = p1 - p0
    dq = q1 - q0
    rel = q0[None, :, :] - p0[:, None, :]
    denom = dp[:, None, 0] * dq[None, :, 1] - dp[:, None, 1] * dq[None, :, 0]
    live = torch.abs(denom) > 0
    safe = torch.where(live, denom, torch.ones_like(denom))
    t = (rel[..., 0] * dq[None, :, 1] - rel[..., 1] * dq[None, :, 0]) / safe
    s = (rel[..., 0] * dp[:, None, 1] - rel[..., 1] * dp[:, None, 0]) / safe
    valid = live & (t >= 0) & (t < 1) & (s >= 0) & (s < 1)
    pts = p0[:, None, :] + t[..., None] * dp[:, None, :]

    flat_valid = valid.reshape(-1)
    flat_pts = pts.reshape(-1, 2)
    # a stable sort of the invalid flags keeps the valid slots in order
    order = torch.argsort((~flat_valid).to(torch.int8), stable=True)
    idx = order[:max_points]
    out_valid = flat_valid[idx]
    out_pts = torch.where(out_valid[:, None], flat_pts[idx],
                          torch.zeros_like(flat_pts[idx]))
    return out_pts, out_valid, torch.sum(valid.to(torch.int32),
                                         dtype=torch.int32)


def point_poly_dist(points: torch.Tensor, verts: torch.Tensor,
                    nv: torch.Tensor | None = None) -> torch.Tensor:
    """Signed min distance from ``points [P, 2]`` to the boundary of the
    padded polygon ``verts [V, 2]`` — negative inside (p_poly_dist.m
    convention).  Padded (zero-length) edges reduce to vertex distances,
    so ``nv`` is not needed (kept for the JAX signature)."""
    p0, p1 = poly_edges(verts)
    d = p1 - p0                                   # [V, 2]
    len2 = torch.sum(d * d, dim=-1)               # [V]
    rel = points[:, None, :] - p0[None, :, :]     # [P, V, 2]
    t = torch.sum(rel * d[None], dim=-1) / torch.where(
        len2 > 0, len2, torch.ones_like(len2))
    t = torch.clamp(t, 0.0, 1.0)
    t = torch.where(len2[None] > 0, t, torch.zeros_like(t))
    closest = p0[None] + t[..., None] * d[None]
    dist = torch.sqrt(torch.sum((points[:, None, :] - closest) ** 2, dim=-1))
    dmin = torch.amin(dist, dim=-1)
    inside = points_in_polygon(points, verts)
    return torch.where(inside, -dmin, dmin)


def cut_polygon(poly: np.ndarray, line_p0, line_p1, side: int) -> np.ndarray:
    """Host-side: clip ``poly [n, 2]`` by the line through p0-p1, keeping
    side 1 (left of p0->p1) or side 2 (right) — cutpolygon.m semantics."""
    p0 = np.asarray(line_p0, dtype=np.float64)
    p1 = np.asarray(line_p1, dtype=np.float64)
    d = p1 - p0
    # left of the line: cross(d, x - p0) >= 0
    sign = 1.0 if side == 1 else -1.0
    out = []
    n = len(poly)
    sd = sign * (d[0] * (poly[:, 1] - p0[1]) - d[1] * (poly[:, 0] - p0[0]))
    for i in range(n):
        j = (i + 1) % n
        if sd[i] >= 0:
            out.append(poly[i])
            if sd[j] < 0:
                t = sd[i] / (sd[i] - sd[j])
                out.append(poly[i] + t * (poly[j] - poly[i]))
        elif sd[j] >= 0:
            t = sd[i] / (sd[i] - sd[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, 2))
