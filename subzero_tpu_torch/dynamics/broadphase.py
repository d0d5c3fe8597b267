"""Broad-phase contact detection: bounding-circle candidate pairs.

Port of the dense ("n2") path of ``subzero_tpu/dynamics/broadphase.py``: the
reference's O(N^2) test ``dist(centroids) < rmax_i + rmax_j``
(``floe_interactions_all.m:101-119``) as one masked [N, N] tensor op, then a
top-K extraction into a fixed-degree [N, K] neighbour table.  Periodicity by
the minimum-image convention: each candidate carries the image shift that
brings floe j closest to floe i.  The cell-list broad phase is not ported
yet (ROADMAP A3c).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _top_k_argmax(key: torch.Tensor, k_max: int):
    """Top-K extraction by K masked max passes, in descending-key order.

    ``torch.max`` along a dim returns the FIRST index of the maximum on CPU
    and CUDA, as ``jnp.argmax`` does, so ties resolve identically; an
    all-``-inf`` row gives index 0 with ``valid`` False.  ``key`` is
    consumed: the extracted entries are overwritten in place (it is the
    caller's scratch [N, N] tensor, and an out-of-place mask would allocate
    K more of them).

    Returns (idx [N, K] int32, valid [N, K] key > -inf).
    """
    neg = float("-inf")
    idxs, vals = [], []
    for _ in range(k_max):
        m, j = torch.max(key, dim=1)
        vals.append(m > neg)
        idxs.append(j)
        key.scatter_(1, j[:, None], neg)
    return (torch.stack(idxs, dim=1).to(torch.int32),
            torch.stack(vals, dim=1))


class NeighborTable(NamedTuple):
    """Fixed-degree candidate table.

    idx      [N, K] int32 neighbour slot index (self-index where invalid)
    valid    [N, K] candidate mask
    shift    [N, K, 2] periodic image shift to apply to neighbour j's position
    overflow []     true if any floe had more than K candidates
    demand   []     int32 max candidates of any row BEFORE the top-K clamp
    """

    idx: torch.Tensor
    valid: torch.Tensor
    shift: torch.Tensor
    overflow: torch.Tensor
    demand: torch.Tensor


def neighbor_candidates(
    x: torch.Tensor,
    y: torch.Tensor,
    rmax: torch.Tensor,
    alive: torch.Tensor,
    k_max: int,
    periodic: bool,
    lx: float,
    ly: float,
    n_skip_rows: int = 0,
) -> NeighborTable:
    """Bounding-circle broad phase -> top-K neighbour table.

    Rows [0, n_skip_rows) (immovable boundary/topography floes) get no
    candidates; floe-vs-boundary pairs still appear in the moving floe's
    row.  Candidates are symmetric, so the narrow phase computes each pair
    once per endpoint.
    """
    n = x.shape[0]
    dev = x.device
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    if periodic:
        # Minimum image on the [-lx,lx] x [-ly,ly] torus (period 2L).
        dx = dx - 2.0 * lx * torch.round(dx / (2.0 * lx))
        dy = dy - 2.0 * ly * torch.round(dy / (2.0 * ly))

    r2 = dx * dx + dy * dy
    del dx, dy
    rsum = rmax[:, None] + rmax[None, :]
    ok = (r2 < rsum * rsum) & alive[:, None] & alive[None, :]
    del rsum
    ok.fill_diagonal_(False)                       # no self pairs
    if n_skip_rows:
        ok[:n_skip_rows] = False

    # Top-K by a key that puts valid candidates first (closest first).
    key = torch.where(ok, -r2, torch.full((), float("-inf"), dtype=r2.dtype,
                                          device=dev))
    del r2
    idx, valid = _top_k_argmax(key, k_max)               # [N, K]
    del key
    demand = torch.max(torch.sum(ok, dim=1)).to(torch.int32)
    del ok
    overflow = demand > k_max
    self_idx = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    # invalid slots point at self (a degenerate identical-polygon pair has
    # collinear edges only: zero crossings, zero force)
    idx = torch.where(valid, idx, self_idx)

    # Periodic image shift of each selected neighbour, recomputed on the
    # gathered [N, K] pairs: the nearest image of j sits at x_j + shift.
    if periodic:
        il = idx.long()
        shx = 2.0 * lx * torch.round((x[:, None] - x[il]) / (2.0 * lx))
        shy = 2.0 * ly * torch.round((y[:, None] - y[il]) / (2.0 * ly))
    else:
        shx = torch.zeros(idx.shape, dtype=x.dtype, device=dev)
        shy = torch.zeros(idx.shape, dtype=x.dtype, device=dev)
    shift = torch.stack([shx, shy], dim=-1)
    return NeighborTable(idx=idx, valid=valid, shift=shift,
                         overflow=overflow, demand=demand)
