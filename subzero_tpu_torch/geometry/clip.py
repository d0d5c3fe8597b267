"""Segment-midpoint polygon-overlap statistics — port of
``subzero_tpu/geometry/clip.py``.

Every quantity the contact model needs is a boundary integral over the clip
result (Green's theorem):

    d(P ∩ Q) = [subsegments of dP inside Q] ∪ [subsegments of dQ inside P]
    d(P \\ Q) = [subsegments of dP outside Q] ∪ [reversed dQ inside P]

Each edge is split at its crossings with the other boundary and at the
projections of the other polygon's vertices; each subsegment is classified
by the mean of two point-in-polygon tests at its midpoint nudged ±eps along
the edge's outward normal, so a subsegment lying on a collinear edge of the
other polygon gets weight 1/2 from each parent.  Area, centroid moments,
the dP-side chord and the proper crossing count follow (see the JAX
module's docstring for the derivation and the reference cites).

The JAX package writes one pair (``_overlap_one``) and batches it with
``jax.vmap``.  Here the same functions broadcast over any leading batch
axes, so ``overlap_stats`` is ``_overlap_one`` called on ``[B, V, 2]``
inputs; batches are processed in chunks of pairs so the
``[B, 2, V, 2 Vq + 1, Vq]`` point-in-polygon intermediate stays bounded
(each pair's result is independent of the chunking).

This clip is plain PyTorch on both devices: it is XLA code in the JAX
package, not a Pallas kernel.  The contact hot path uses the
parity-integral clip (``clip_integral.py``, ``kernels/clip.py``);
``clip_batched.py`` holds this math in the batch-minor layout that
``contact_impl="xla"`` selects.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .polygon import points_in_polygon, poly_edges

__all__ = [
    "OverlapStats",
    "overlap_stats",
    "difference_stats",
    "intersection_area",
]

# Elements of the largest per-chunk intermediate (the point-in-polygon
# crossing table), by device type.  On the CPU a chunk that stays in cache
# runs faster than one that streams through memory; on the card large
# chunks keep the launch count down (2^26 elements is 512 MiB in float64).
CHUNK_ELEMS = {"cpu": 1 << 20, "cuda": 1 << 26}


class OverlapStats(NamedTuple):
    """Statistics of a polygon boolean result for a batch of polygon pairs.

    Attributes (all ``[...]`` batched like the inputs):
      area:     area of the clip result (>= 0 for simple CCW inputs)
      centroid: ``[..., 2]`` area centroid of the result (0 where area ~ 0)
      chord_p:  ``[..., 2]`` Σ directed subsegments of dP in the result.  The
                overlap-reducing force direction on P is
                ``(-chord_y, chord_x)`` (CCW convention); its norm is the
                contact length `dl`.
      n_cross:  int32 number of proper dP×dQ edge crossings (InterX count
                analog, floe_interactions.m:70-71)
    """

    area: torch.Tensor
    centroid: torch.Tensor
    chord_p: torch.Tensor
    n_cross: torch.Tensor


def chunked(fn, p: torch.Tensor, q: torch.Tensor,
            per_pair: int) -> OverlapStats:
    """``fn(p, q)`` over chunks of the ``[B, ...]`` pairs, each chunk holding
    at most ``CHUNK_ELEMS[device] // per_pair`` pairs, the results joined
    again."""
    b = p.shape[0]
    step = max(1, CHUNK_ELEMS[p.device.type] // per_pair)
    if b <= step:
        return fn(p, q)
    parts = [fn(p[i:i + step], q[i:i + step]) for i in range(0, b, step)]
    return OverlapStats(*(torch.cat(f) for f in zip(*parts)))


def _cross_z(ax, ay, bx, by):
    return ax * by - ay * bx


def _side_contrib(p: torch.Tensor, other: torch.Tensor,
                  t_params: torch.Tensor, t_valid: torch.Tensor,
                  want_inside: bool, eps: torch.Tensor):
    """Contributions of dP subsegments classified against ``other``.

    p: ``[..., V, 2]`` CCW padded polygon; other: ``[..., Vq, 2]``;
    t_params/t_valid: ``[..., V, Vq]`` intersection parameters on P's edges
    (vs each edge of ``other``) and their validity mask; eps ``[...]``.
    want_inside: keep subsegments whose midpoint is inside ``other``
    (True) or outside (False).

    Degeneracy rule: a subsegment is weighted by the mean of two tests at
    midpoint ± eps·n̂ (n̂ = P's outward edge normal): 1 / 0 strictly
    inside / outside, 1/2 on a collinear edge of ``other``.

    Returns (area_sum, mx_sum, my_sum, chord ``[..., 2]``).
    """
    v, vq = t_params.shape[-2:]
    batch = t_params.shape[:-2]
    p0, p1 = poly_edges(p)
    d = p1 - p0                                          # [..., V, 2]

    # Additional splits at the projections of ``other``'s vertices onto
    # each P edge: collinear overlapping edges produce no proper crossing,
    # so without these the subsegment boundaries at shared-edge junctions
    # are lost.
    d2 = torch.sum(d * d, dim=-1)                        # [..., V]
    rel_v = other[..., None, :, :] - p0[..., :, None, :]  # [..., V, Vq, 2]
    t_proj = torch.sum(rel_v * d[..., :, None, :], dim=-1) / torch.where(
        d2 > 0, d2, torch.ones_like(d2))[..., None]
    t_proj = torch.clamp(t_proj, 0.0, 1.0)

    # Sorted split points per edge: invalid -> +inf -> clipped to 1
    # (zero-length subsegments).
    t = torch.where(t_valid, t_params, torch.full_like(t_params, math.inf))
    t = torch.cat([t, t_proj], dim=-1)                   # [..., V, 2 Vq]
    t = torch.sort(t, dim=-1).values
    t = torch.clamp(t, 0.0, 1.0)
    nseg = 2 * vq + 1
    zeros = torch.zeros_like(t[..., :1])
    t_lo = torch.cat([zeros, t], dim=-1)                 # [..., V, nseg]
    t_hi = torch.cat([t, zeros + 1.0], dim=-1)

    mid = p0[..., :, None, :] + d[..., :, None, :] * (
        0.5 * (t_lo + t_hi))[..., None]
    # Outward normal of each P edge (CCW: right of travel), zero-safe.
    elen = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    nrm = torch.stack([d[..., 1], -d[..., 0]], dim=-1) / torch.where(
        elen > 0, elen, torch.ones_like(elen))
    off = eps[..., None, None, None] * nrm[..., :, None, :]
    probe = torch.stack([mid + off, mid - off], dim=-4)  # [..., 2, V, nseg, 2]
    inside = points_in_polygon(probe.reshape(*batch, 2 * v * nseg, 2), other)
    inside = inside.reshape(*batch, 2, v, nseg).to(t.dtype)
    wgt = 0.5 * (inside[..., 0, :, :] + inside[..., 1, :, :])
    if not want_inside:
        wgt = 1.0 - wgt
    wgt = torch.where(t_hi > t_lo, wgt, torch.zeros_like(wgt))

    q0 = p0[..., :, None, :] + d[..., :, None, :] * t_lo[..., None]
    q1 = p0[..., :, None, :] + d[..., :, None, :] * t_hi[..., None]
    w = _cross_z(q0[..., 0], q0[..., 1], q1[..., 0], q1[..., 1]) * wgt
    area = 0.5 * torch.sum(w, dim=(-2, -1))
    mx = torch.sum(w * (q0[..., 0] + q1[..., 0]), dim=(-2, -1)) / 6.0
    my = torch.sum(w * (q0[..., 1] + q1[..., 1]), dim=(-2, -1)) / 6.0
    chord = torch.sum((q1 - q0) * wgt[..., None], dim=(-3, -2))
    return area, mx, my, chord


def _edge_intersections(p: torch.Tensor, q: torch.Tensor):
    """Pairwise edge-intersection parameters of two padded CCW polygons.

    Returns (t ``[..., Vp, Vq]`` params on P's edges, s ``[..., Vp, Vq]``
    params on Q's edges, valid mask, n_cross ``[...]`` int32).
    """
    p0, p1 = poly_edges(p)
    q0, q1 = poly_edges(q)
    dp = (p1 - p0)[..., :, None, :]                      # [..., Vp, 1, 2]
    dq = (q1 - q0)[..., None, :, :]                      # [..., 1, Vq, 2]

    rel = q0[..., None, :, :] - p0[..., :, None, :]      # [..., Vp, Vq, 2]
    denom = _cross_z(dp[..., 0], dp[..., 1], dq[..., 0], dq[..., 1])
    live = torch.abs(denom) > 0
    safe = torch.where(live, denom, torch.ones_like(denom))
    t = _cross_z(rel[..., 0], rel[..., 1], dq[..., 0], dq[..., 1]) / safe
    s = _cross_z(rel[..., 0], rel[..., 1], dp[..., 0], dp[..., 1]) / safe
    # Half-open [0,1) on both parameters: a crossing landing exactly on a
    # shared vertex is counted once (on the succeeding edge), never twice.
    valid = live & (t >= 0) & (t < 1) & (s >= 0) & (s < 1)
    n_cross = torch.sum(valid.to(torch.int32), dim=(-2, -1),
                        dtype=torch.int32)
    return t, s, valid, n_cross


def _finalize(area, mx, my, chord_p, n_cross) -> OverlapStats:
    ok = torch.abs(area) > 1e-9
    safe_area = torch.where(ok, area, torch.ones_like(area))
    moments = torch.stack([mx, my], dim=-1)
    centroid = torch.where(ok[..., None], moments / safe_area[..., None],
                           torch.zeros_like(moments))
    return OverlapStats(area=area, centroid=centroid, chord_p=chord_p,
                        n_cross=n_cross)


def _pair_eps(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Classification nudge ``[...]``: sqrt(machine eps) x coordinate scale.

    Large enough to dominate PIP roundoff at the pair's coordinate
    magnitude, small enough to be physically negligible."""
    scale = torch.maximum(torch.amax(torch.abs(p), dim=(-2, -1)),
                          torch.amax(torch.abs(q), dim=(-2, -1)))
    scale = torch.clamp(scale, min=1.0)
    root = torch.sqrt(torch.tensor(torch.finfo(p.dtype).eps, dtype=p.dtype))
    return scale * root.to(p.device)


def _clip(p: torch.Tensor, q: torch.Tensor, difference: bool) -> OverlapStats:
    eps = _pair_eps(p, q)
    t, s, valid, n_cross = _edge_intersections(p, q)
    a_p, mx_p, my_p, chord_p = _side_contrib(p, q, t, valid, not difference,
                                             eps)
    a_q, mx_q, my_q, _ = _side_contrib(q, p, s.transpose(-2, -1),
                                       valid.transpose(-2, -1), True, eps)
    if difference:
        # Boundary of P \\ Q = (dP outside Q) + (dQ inside P, reversed).
        return _finalize(a_p - a_q, mx_p - mx_q, my_p - my_q, chord_p,
                         n_cross)
    return _finalize(a_p + a_q, mx_p + mx_q, my_p + my_q, chord_p, n_cross)


def _overlap_one(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Statistics of P ∩ Q for ``p: [..., Vp, 2], q: [..., Vq, 2]`` (one
    pair, or any leading batch axes)."""
    return _clip(p, q, False)


def _difference_one(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Statistics of P \\ Q (same conventions as ``_overlap_one``).  Used for
    floe-vs-domain contact: the reference clips ``polyclip(c1, c2, 'dif')``
    against the domain polygon (``floe_interactions.m:34``)."""
    return _clip(p, q, True)


def _per_pair(p: torch.Tensor, q: torch.Tensor) -> int:
    """Elements of the largest intermediate per pair: the crossing table of
    the Q side's probes against P, or of P's against Q."""
    vp, vq = p.shape[-2], q.shape[-2]
    return 2 * max(vp * (2 * vq + 1) * vq, vq * (2 * vp + 1) * vp)


def overlap_stats(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Batched P ∩ Q statistics: verts_p[B, Vp, 2], verts_q[B, Vq, 2] ->
    OverlapStats with leading batch axis.  Polygons must be CCW, padded
    with their first vertex, and expressed in a common (pair-local) frame."""
    return chunked(_overlap_one, p, q, _per_pair(p, q))


def difference_stats(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Batched P \\ Q statistics (same conventions as overlap_stats)."""
    return chunked(_difference_one, p, q, _per_pair(p, q))


def intersection_area(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Area of P ∩ Q for padded polygons, one pair ``[V, 2]`` or a batch."""
    if p.ndim == 2:
        return _overlap_one(p, q).area
    return overlap_stats(p, q).area
