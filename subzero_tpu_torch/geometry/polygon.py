"""Batched padded-polygon primitives on torch tensors.

Port of ``subzero_tpu/geometry/polygon.py``.  Same convention: a polygon is
``verts[..., V, 2]`` of CCW vertices with a valid count ``nv``; slots
``nv:`` repeat vertex 0, so the edge list ``(verts[k], verts[(k+1) % V])``
closes the polygon and degenerates to zero-length edges on the padding,
which contribute nothing to any boundary integral.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "pad_polygon",
    "pad_polygons",
    "apply_padding",
    "poly_edges",
    "poly_area",
    "poly_centroid",
    "poly_moments",
    "poly_inertia_z",
    "poly_rmax",
    "poly_angles",
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


def apply_padding(verts: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """Re-apply the pad-with-first-vertex convention on the device.

    ``verts[..., V, 2]``, ``nv[...]`` -> padded verts (slots ``nv:`` set to
    vertex 0).
    """
    idx = torch.arange(verts.shape[-2], device=verts.device)
    mask = idx < nv[..., None]
    return torch.where(mask[..., None], verts, verts[..., 0:1, :])


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


def poly_inertia_z(verts: torch.Tensor, h: torch.Tensor,
                   rho_ice: float = 920.0) -> torch.Tensor:
    """Polar moment of inertia ``Izz = |Ixx+Iyy| * h * rho_ice``
    (PolygonMoments.m:29-32); ``verts`` in the body frame (relative to the
    centroid)."""
    m = poly_moments(verts)
    return torch.abs(m["ixx"] + m["iyy"]) * h * rho_ice


def poly_rmax(verts: torch.Tensor,
              center: torch.Tensor | None = None) -> torch.Tensor:
    """Max distance from ``center`` (default origin) to any vertex."""
    if center is not None:
        verts = verts - center[..., None, :]
    return torch.sqrt(torch.amax(torch.sum(verts ** 2, dim=-1), dim=-1))


def poly_angles(verts: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """Interior vertex angles in degrees, concavity-corrected ``[..., V]``.

    For a CCW polygon the interior angle at v is the angle from (next-v) to
    (prev-v) measured CCW, in (0, 360) (polyangles.m:40-54).  Padded slots
    return 0.
    """
    idx = torch.arange(verts.shape[-2], device=verts.device)
    last = nv[..., None].long() - 1
    prev_i = torch.where(idx == 0, last, idx - 1)
    next_i = torch.where(idx == last, torch.zeros_like(idx), idx + 1)
    prev = torch.take_along_dim(verts, prev_i[..., None], dim=-2)
    nxt = torch.take_along_dim(verts, next_i[..., None], dim=-2)
    e1 = nxt - verts   # edge to next vertex
    e2 = prev - verts  # edge to previous vertex
    ang = torch.atan2(_cross_z(e1, e2), torch.sum(e1 * e2, dim=-1))
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang) * (180.0 / math.pi)
    return torch.where(idx < nv[..., None], ang, torch.zeros_like(ang))


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
