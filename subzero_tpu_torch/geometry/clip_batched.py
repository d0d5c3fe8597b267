"""Batch-minor segment-midpoint overlap statistics — port of
``subzero_tpu/geometry/clip_batched.py``, the ``contact_impl="xla"`` clip.

The same math as ``clip.py``'s ``_overlap_one`` / ``_difference_one`` (same
splits, same half-weight nudged classification), written with the pair
batch as the minor axis: every intermediate is ``[V, V', B]``.  In the JAX
package XLA fuses the ``[Vp, 2 Vq + 1, Vq, B]`` point-in-polygon crossing
table away; eager PyTorch materialises it, so the batch is processed in
chunks of pairs that bound it (``clip.CHUNK_ELEMS``); each pair's result is
independent of the chunking.  Plain PyTorch on both devices.
"""

from __future__ import annotations

import math

import torch

from .clip import OverlapStats, chunked

__all__ = ["overlap_stats_bm", "difference_stats_bm"]


def _pip_batch(px, py, qx0, qy0, qx1, qy1):
    """Point-in-polygon, batch-minor.

    px, py: ``[..., B]`` probe points; q*: ``[Vq, B]`` polygon edges (padded
    edges are zero length and never straddle).  Returns bool ``[..., B]``.
    """
    pxe = px[..., None, :]                       # [..., 1, B] vs [Vq, B]
    pye = py[..., None, :]
    cond = (qy0 > pye) != (qy1 > pye)
    denom = torch.where(qy1 == qy0, torch.ones_like(qy0), qy1 - qy0)
    xint = qx0 + (pye - qy0) / denom * (qx1 - qx0)
    cross = cond & (pxe < xint)
    return torch.sum(cross.to(torch.int32), dim=-2) % 2 == 1


def _pair_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``[V, nseg, B]`` over its first two axes, one contiguous row
    per pair: a reduction over the leading axes of the batch-minor layout
    would group its terms by the batch's width, and the chunking would
    then move the last bits of a pair's sums."""
    return x.reshape(-1, x.shape[-1]).T.contiguous().sum(dim=1)


def _side_contrib_bm(px0, py0, px1, py1,      # [Vp, B] P's edges
                     qx0, qy0, qx1, qy1,      # [Vq, B] Q's edges
                     t_params, t_valid,       # [Vp, Vq, B]
                     want_inside: bool, eps):  # eps: [B]
    dx = px1 - px0                            # [Vp, B]
    dy = py1 - py0

    # splits at projections of Q's vertices onto P's edges
    d2 = dx * dx + dy * dy
    safe_d2 = torch.where(d2 > 0, d2, torch.ones_like(d2))
    relx = qx0[None, :, :] - px0[:, None, :]  # [Vp, Vq, B]
    rely = qy0[None, :, :] - py0[:, None, :]
    t_proj = (relx * dx[:, None] + rely * dy[:, None]) / safe_d2[:, None]
    t_proj = torch.clamp(t_proj, 0.0, 1.0)

    t = torch.where(t_valid, t_params, torch.full_like(t_params, math.inf))
    t = torch.cat([t, t_proj], dim=1)         # [Vp, 2Vq, B]
    t = torch.sort(t, dim=1).values
    t = torch.clamp(t, 0.0, 1.0)
    zeros = torch.zeros_like(t[:, :1])
    t_lo = torch.cat([zeros, t], dim=1)       # [Vp, nseg, B]
    t_hi = torch.cat([t, zeros + 1.0], dim=1)

    tm = 0.5 * (t_lo + t_hi)
    midx = px0[:, None] + dx[:, None] * tm    # [Vp, nseg, B]
    midy = py0[:, None] + dy[:, None] * tm
    elen = torch.sqrt(d2)
    pos = elen > 0
    one = torch.ones_like(elen)
    inv_elen = torch.where(pos, one / torch.where(pos, elen, one),
                           torch.zeros_like(elen))
    nx = dy * inv_elen                        # outward normal for CCW
    ny = -dx * inv_elen
    ex = (eps * nx)[:, None]
    ey = (eps * ny)[:, None]

    in_p = _pip_batch(midx + ex, midy + ey, qx0, qy0, qx1, qy1)
    in_m = _pip_batch(midx - ex, midy - ey, qx0, qy0, qx1, qy1)
    wgt = 0.5 * (in_p.to(t.dtype) + in_m.to(t.dtype))
    if not want_inside:
        wgt = 1.0 - wgt
    wgt = torch.where(t_hi > t_lo, wgt, torch.zeros_like(wgt))

    qx0s = px0[:, None] + dx[:, None] * t_lo  # [Vp, nseg, B]
    qy0s = py0[:, None] + dy[:, None] * t_lo
    qx1s = px0[:, None] + dx[:, None] * t_hi
    qy1s = py0[:, None] + dy[:, None] * t_hi
    w = (qx0s * qy1s - qx1s * qy0s) * wgt
    area = 0.5 * _pair_sum(w)
    mx = _pair_sum(w * (qx0s + qx1s)) / 6.0
    my = _pair_sum(w * (qy0s + qy1s)) / 6.0
    chx = _pair_sum((qx1s - qx0s) * wgt)
    chy = _pair_sum((qy1s - qy0s) * wgt)
    return area, mx, my, chx, chy


def _edges_bm(p: torch.Tensor):
    """[B, V, 2] -> batch-minor edge end points x0, y0, x1, y1, [V, B]."""
    p1 = torch.roll(p, -1, dims=1)
    return p[:, :, 0].T, p[:, :, 1].T, p1[:, :, 0].T, p1[:, :, 1].T


def _clip_bm(p: torch.Tensor, q: torch.Tensor, difference: bool) -> OverlapStats:
    """p, q: [B, V, 2] padded CCW polygon pairs -> OverlapStats [B]."""
    root = torch.sqrt(torch.tensor(torch.finfo(p.dtype).eps, dtype=p.dtype))
    eps = torch.clamp(torch.maximum(torch.amax(torch.abs(p), dim=(1, 2)),
                                    torch.amax(torch.abs(q), dim=(1, 2))),
                      min=1.0) * root.to(p.device)                 # [B]

    px0, py0, px1, py1 = _edges_bm(p)
    qx0, qy0, qx1, qy1 = _edges_bm(q)
    dpx = px1 - px0
    dpy = py1 - py0
    dqx = qx1 - qx0
    dqy = qy1 - qy0

    # edge-pair intersection params [Vp, Vq, B]
    relx = qx0[None, :, :] - px0[:, None, :]
    rely = qy0[None, :, :] - py0[:, None, :]
    denom = dpx[:, None] * dqy[None] - dpy[:, None] * dqx[None]
    live = torch.abs(denom) > 0
    safe = torch.where(live, denom, torch.ones_like(denom))
    t = (relx * dqy[None] - rely * dqx[None]) / safe
    s = (relx * dpy[:, None] - rely * dpx[:, None]) / safe
    valid = live & (t >= 0) & (t < 1) & (s >= 0) & (s < 1)
    n_cross = torch.sum(valid.to(torch.int32), dim=(0, 1), dtype=torch.int32)

    a_p, mx_p, my_p, chx, chy = _side_contrib_bm(
        px0, py0, px1, py1, qx0, qy0, qx1, qy1, t, valid,
        not difference, eps)
    a_q, mx_q, my_q, _, _ = _side_contrib_bm(
        qx0, qy0, qx1, qy1, px0, py0, px1, py1,
        s.transpose(0, 1), valid.transpose(0, 1), True, eps)

    if difference:
        area = a_p - a_q
        mx = mx_p - mx_q
        my = my_p - my_q
    else:
        area = a_p + a_q
        mx = mx_p + mx_q
        my = my_p + my_q

    ok = torch.abs(area) > 1e-9
    safe_area = torch.where(ok, area, torch.ones_like(area))
    zero = torch.zeros_like(area)
    centroid = torch.stack(
        [torch.where(ok, mx / safe_area, zero),
         torch.where(ok, my / safe_area, zero)], dim=-1)
    chord = torch.stack([chx, chy], dim=-1)
    return OverlapStats(area=area, centroid=centroid, chord_p=chord,
                        n_cross=n_cross)


def _per_pair(p: torch.Tensor, q: torch.Tensor) -> int:
    """Elements per pair of the largest crossing table, ``[Vp, 2Vq+1, Vq]``
    or the Q side's ``[Vq, 2Vp+1, Vp]``."""
    vp, vq = p.shape[1], q.shape[1]
    return max(vp * (2 * vq + 1) * vq, vq * (2 * vp + 1) * vp)


def overlap_stats_bm(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Batch-minor P ∩ Q statistics for [B, V, 2] polygon pairs."""
    return chunked(lambda a, b: _clip_bm(a, b, False), p, q, _per_pair(p, q))


def difference_stats_bm(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Batch-minor P \\ Q statistics for [B, V, 2] polygon pairs."""
    return chunked(lambda a, b: _clip_bm(a, b, True), p, q, _per_pair(p, q))
