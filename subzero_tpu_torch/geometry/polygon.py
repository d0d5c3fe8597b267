"""Batched padded-polygon primitives on torch tensors.

Port of ``subzero_tpu/geometry/polygon.py``.  Same convention: a polygon is
``verts[..., V, 2]`` of CCW vertices with a valid count ``nv``; slots
``nv:`` repeat vertex 0, so the edge list ``(verts[k], verts[(k+1) % V])``
closes the polygon and degenerates to zero-length edges on the padding,
which contribute nothing to any boundary integral.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pad_polygon",
    "pad_polygons",
    "poly_edges",
    "poly_area",
    "poly_centroid",
    "poly_moments",
    "points_in_polygon",
]


# ---------------------------------------------------------------------------
# Host-side construction helpers (numpy, identical to the JAX package's)
# ---------------------------------------------------------------------------

def pad_polygon(verts: np.ndarray, v_max: int) -> tuple[np.ndarray, int]:
    """Pad one ``[n, 2]`` CCW vertex array to ``[v_max, 2]`` (pad = vertex 0).

    Drops a duplicated closing vertex if present and enforces CCW order.
    """
    verts = np.asarray(verts, dtype=np.float64)
    if verts.ndim != 2 or verts.shape[1] != 2:
        raise ValueError(f"expected [n,2] vertex array, got {verts.shape}")
    # Drop duplicate closing vertex.
    if len(verts) > 1 and np.allclose(verts[0], verts[-1]):
        verts = verts[:-1]
    # Enforce CCW.
    x, y = verts[:, 0], verts[:, 1]
    signed = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    if signed < 0:
        verts = verts[::-1]
    n = len(verts)
    if n > v_max:
        raise ValueError(f"polygon has {n} vertices > capacity {v_max}")
    out = np.empty((v_max, 2), dtype=np.float64)
    out[:n] = verts
    out[n:] = verts[0]
    return out, n


def pad_polygons(polys: list[np.ndarray], v_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of polygons to ``[N, v_max, 2]`` + counts ``[N]``."""
    out = np.zeros((len(polys), v_max, 2), dtype=np.float64)
    nv = np.zeros((len(polys),), dtype=np.int32)
    for i, p in enumerate(polys):
        out[i], nv[i] = pad_polygon(p, v_max)
    return out, nv


# ---------------------------------------------------------------------------
# Boundary-integral properties (Green's theorem)
# ---------------------------------------------------------------------------

def poly_edges(verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge endpoints ``(p0, p1)`` with wraparound; padded edges are 0-length."""
    return verts, torch.roll(verts, -1, dims=-2)


def _cross_z(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def poly_area(verts: torch.Tensor) -> torch.Tensor:
    """Signed area (positive for CCW).  Shoelace over padded edges."""
    p0, p1 = poly_edges(verts)
    return 0.5 * torch.sum(_cross_z(p0, p1), dim=-1)


def poly_centroid(verts: torch.Tensor) -> torch.Tensor:
    """Area centroid ``[..., 2]``.  Falls back to vertex 0 for ~zero area."""
    p0, p1 = poly_edges(verts)
    w = _cross_z(p0, p1)
    a = 0.5 * torch.sum(w, dim=-1)
    cx = torch.sum(w * (p0[..., 0] + p1[..., 0]), dim=-1) / 6.0
    cy = torch.sum(w * (p0[..., 1] + p1[..., 1]), dim=-1) / 6.0
    big = torch.abs(a) > 1e-12
    safe = torch.where(big, a, torch.ones_like(a))
    c = torch.stack([cx, cy], dim=-1) / safe[..., None]
    return torch.where(big[..., None], c, verts[..., 0, :])


def poly_moments(verts: torch.Tensor) -> dict[str, torch.Tensor]:
    """Area moments about the coordinate origin (PolygonMoments.m math).

    Returns dict with ``area, max (M_Ax), may (M_Ay), ixx, iyy, ixy``.
    """
    p0, p1 = poly_edges(verts)
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    w = x0 * y1 - x1 * y0
    area = 0.5 * torch.sum(w, dim=-1)
    max_ = torch.sum(w * (y0 + y1), dim=-1) / 6.0
    may_ = torch.sum(w * (x0 + x1), dim=-1) / 6.0
    ixx = torch.sum(w * ((y0 + y1) ** 2 - y0 * y1), dim=-1) / 12.0
    iyy = torch.sum(w * ((x0 + x1) ** 2 - x0 * x1), dim=-1) / 12.0
    ixy = torch.sum(w * ((x0 + x1) * (y0 + y1) + x0 * y0 + x1 * y1), dim=-1) / 24.0
    return {"area": area, "max": max_, "may": may_, "ixx": ixx, "iyy": iyy, "ixy": ixy}


# ---------------------------------------------------------------------------
# Point-in-polygon
# ---------------------------------------------------------------------------

def points_in_polygon(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Even-odd (crossing-number) point-in-polygon test.

    ``points[..., P, 2]`` vs ``verts[..., V, 2]`` -> bool ``[..., P]``, with
    the half-open upward/downward crossing rule; zero-length (padded) edges
    never cross.
    """
    p0, p1 = poly_edges(verts)
    px = points[..., :, None, 0]
    py = points[..., :, None, 1]
    x0, y0 = p0[..., None, :, 0], p0[..., None, :, 1]
    x1, y1 = p1[..., None, :, 0], p1[..., None, :, 1]
    # Edge straddles the horizontal ray through py (half-open rule).
    cond = (y0 > py) != (y1 > py)
    # x coordinate of edge at height py.
    dy = y1 - y0
    t = (py - y0) / torch.where(y1 == y0, torch.ones_like(dy), dy)
    xint = x0 + t * (x1 - x0)
    crossings = torch.sum((cond & (px < xint)).to(torch.int32), dim=-1)
    return (crossings % 2) == 1
