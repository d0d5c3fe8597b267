"""Broad-phase contact detection: bounding-circle candidate pairs.

Port of ``subzero_tpu/dynamics/broadphase.py``: the reference's O(N^2) test
``dist(centroids) < rmax_i + rmax_j`` (``floe_interactions_all.m:101-119``)
and a top-K extraction into a fixed-degree [N, K] neighbour table.
Periodicity by the minimum-image convention: each candidate carries the
image shift that brings floe j closest to floe i.  ``neighbor_candidates``
launches the Hopper kernel of ``csrc/broadphase.cu`` for CUDA tensors and
runs ``neighbor_candidates_plain`` (one masked [N, N] tensor op and K
masked max passes) for CPU tensors; the two give the same table, bit for
bit.  ``neighbor_candidates_cells`` is the cell-list broad phase: the same
table from the floes of each floe's 3x3 cell neighbourhood,
O(N * 9 * cell_cap) instead of O(N^2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.broadphase import neighbor_table_cuda


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
    src: tuple | None = None,
    n_skip_rows: int = 0,
) -> NeighborTable:
    """Bounding-circle broad phase -> top-K neighbour table: the kernel on
    CUDA tensors (``kernels/broadphase.py:neighbor_table_cuda``), the plain
    version on CPU tensors (``neighbor_candidates_plain``, which documents
    the arguments)."""
    args = (x, y, rmax, alive, k_max, periodic, lx, ly, src, n_skip_rows)
    if x.device.type == "cuda":
        return NeighborTable(*neighbor_table_cuda(*args))
    if x.device.type == "cpu":
        return neighbor_candidates_plain(*args)
    raise ValueError(f"no broad phase for device {x.device}")


def neighbor_candidates_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    rmax: torch.Tensor,
    alive: torch.Tensor,
    k_max: int,
    periodic: bool,
    lx: float,
    ly: float,
    src: tuple | None = None,
    n_skip_rows: int = 0,
) -> NeighborTable:
    """Bounding-circle broad phase -> top-K neighbour table, in plain
    PyTorch.

    Rows [0, n_skip_rows) (immovable boundary/topography floes) get no
    candidates; floe-vs-boundary pairs still appear in the moving floe's
    row.  Candidates are symmetric, so the narrow phase computes each pair
    once per endpoint.

    ``src``: optional ``(x_s, y_s, r_s, alive_s, n_self)`` candidate-source
    arrays for the spatial decomposition, where the queries occupy the
    first ``n_self`` source slots (self-pairs are excluded only there).
    The returned indices then point into the source arrays.
    """
    n = x.shape[0]
    dev = x.device
    if src is None:
        x_s, y_s, r_s, alive_s, n_self = x, y, rmax, alive, n
    else:
        x_s, y_s, r_s, alive_s, n_self = src
    m = x_s.shape[0]
    dx = x[:, None] - x_s[None, :]
    dy = y[:, None] - y_s[None, :]
    if periodic:
        # Minimum image on the [-lx,lx] x [-ly,ly] torus (period 2L).
        dx = dx - 2.0 * lx * torch.round(dx / (2.0 * lx))
        dy = dy - 2.0 * ly * torch.round(dy / (2.0 * ly))

    r2 = dx * dx + dy * dy
    del dx, dy
    rsum = rmax[:, None] + r_s[None, :]
    ok = (r2 < rsum * rsum) & alive[:, None] & alive_s[None, :]
    del rsum
    ok[:, :n_self].fill_diagonal_(False)           # no self pairs
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
    # collinear edges only: zero crossings, zero force); the shift gather
    # below clamps them into the source range
    gather_idx = torch.where(valid, idx, torch.clamp(self_idx, max=m - 1))
    idx = torch.where(valid, idx, self_idx)

    # Periodic image shift of each selected neighbour, recomputed on the
    # gathered [N, K] pairs: the nearest image of j sits at x_j + shift.
    if periodic:
        il = gather_idx.long()
        shx = 2.0 * lx * torch.round((x[:, None] - x_s[il]) / (2.0 * lx))
        shy = 2.0 * ly * torch.round((y[:, None] - y_s[il]) / (2.0 * ly))
    else:
        shx = torch.zeros(idx.shape, dtype=x.dtype, device=dev)
        shy = torch.zeros(idx.shape, dtype=x.dtype, device=dev)
    shift = torch.stack([shx, shy], dim=-1)
    return NeighborTable(idx=idx, valid=valid, shift=shift,
                         overflow=overflow, demand=demand)


def neighbor_candidates_cells(
    x: torch.Tensor,
    y: torch.Tensor,
    rmax: torch.Tensor,
    alive: torch.Tensor,
    k_max: int,
    periodic: bool,
    lx: float,
    ly: float,
    cell_size: float,
    cell_cap: int,
    n_skip_rows: int = 0,
) -> NeighborTable:
    """Cell-list broad phase: the table of ``neighbor_candidates`` from the
    floes of each floe's 3x3 cell neighbourhood.

    ``cell_size`` must be >= 2 * max(rmax) so that every bounding-circle
    candidate lies in that neighbourhood; ``cell_cap`` bounds the floes read
    per cell (a fuller cell sets ``overflow``).  The candidate order (cells
    row by row, floes by slot within a cell, from a stable sort) is the JAX
    function's, so distance ties resolve identically.
    """
    n = x.shape[0]
    dev = x.device
    # integer cell grid covering [-lx, lx] x [-ly, ly]
    ncx = max(int(2 * lx / cell_size), 1)
    ncy = max(int(2 * ly / cell_size), 1)
    csx = 2 * lx / ncx
    csy = 2 * ly / ncy
    ix = torch.clamp(((x + lx) / csx).to(torch.int32), 0, ncx - 1).long()
    iy = torch.clamp(((y + ly) / csy).to(torch.int32), 0, ncy - 1).long()
    # dead floes go to a sentinel cell
    cid = torch.where(alive, iy * ncx + ix, ncx * ncy)

    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]

    # per-cell occupancy overflow check (index_add_ rather than bincount,
    # which reads its input's maximum back to the host on CUDA)
    counts = torch.zeros((ncx * ncy + 1,), dtype=torch.long,
                         device=dev).index_add_(0, cid, torch.ones_like(cid))
    overflow_cells = torch.any(counts[:-1] > cell_cap)

    # 3x3 neighbourhood, dy outer and dx inner (wrapped when periodic,
    # clamped otherwise)
    off = torch.arange(9, device=dev)
    nx_ = ix[:, None] + (off % 3 - 1)[None]                 # [N, 9]
    ny_ = iy[:, None] + (off // 3 - 1)[None]
    if periodic:
        nx_ = torch.remainder(nx_, ncx)
        ny_ = torch.remainder(ny_, ncy)
        cell_ok = torch.ones(nx_.shape, dtype=torch.bool, device=dev)
    else:
        cell_ok = (nx_ >= 0) & (nx_ < ncx) & (ny_ >= 0) & (ny_ < ncy)
        nx_ = torch.clamp(nx_, 0, ncx - 1)
        ny_ = torch.clamp(ny_, 0, ncy - 1)
    ncell = (ny_ * ncx + nx_).reshape(-1)                   # [N*9]

    start = torch.searchsorted(cid_sorted, ncell, side="left")
    slots = torch.clamp(start[:, None] + torch.arange(cell_cap, device=dev),
                        0, n - 1)                           # [N*9, cap]
    cand = order[slots].reshape(n, 9 * cell_cap)
    cand_ok = ((cid_sorted[slots] == ncell[:, None])
               & cell_ok.reshape(-1)[:, None]).reshape(n, 9 * cell_cap)

    # circle test on the gathered candidates
    dx = x[:, None] - x[cand]
    dy = y[:, None] - y[cand]
    if periodic:
        sx = -2.0 * lx * torch.round(dx / (2.0 * lx))
        sy = -2.0 * ly * torch.round(dy / (2.0 * ly))
        dx = dx + sx
        dy = dy + sy
    else:
        sx = torch.zeros_like(dx)
        sy = torch.zeros_like(dy)
    r2 = dx * dx + dy * dy
    rsum = rmax[:, None] + rmax[cand]
    self_idx = torch.arange(n, device=dev)[:, None]
    ok = (cand_ok & (r2 < rsum * rsum) & alive[:, None] & alive[cand]
          & (cand != self_idx))
    if n_skip_rows:
        ok[:n_skip_rows] = False

    key = torch.where(ok, -r2, torch.full((), float("-inf"), dtype=r2.dtype,
                                          device=dev))
    kidx, valid = _top_k_argmax(key, k_max)                 # [N, K]
    kidx = kidx.long()
    demand = torch.max(torch.sum(ok, dim=1)).to(torch.int32)
    overflow = overflow_cells | (demand > k_max)
    idx = torch.where(valid, torch.gather(cand, 1, kidx), self_idx)
    shift = torch.stack([-torch.gather(sx, 1, kidx),
                         -torch.gather(sy, 1, kidx)], dim=-1)
    return NeighborTable(idx=idx.to(torch.int32), valid=valid, shift=shift,
                         overflow=overflow, demand=demand)
