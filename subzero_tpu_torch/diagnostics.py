"""Eulerian coarse-graining and scalar diagnostics.

Port of ``subzero_tpu/diagnostics.py`` (``calc_eulerian_data.m``):
mass-weighted averages of floe fields over an Ny x Nx cell grid using
polygon-cell intersection areas, plus the total-mass series
(``Subzero.m:294-295``) and the dissolved-mass binning
(``calc_dissolved_mass.m``).

* Each floe is clipped against the wx x wy window of cells its bounding
  circle can touch (the JAX package's host-windowed scatter path); the JAX
  package's second, traced path (dense floe x cell blocks) computes the same
  sums, so the port keeps this one.  The window is sized on the host from
  the largest live ``rmax``; the driver's per-step accumulation passes the
  window it sized once per chunk (a floe's ``rmax`` changes only at
  lifecycle boundaries).
* The floe∩cell areas go through the segment-midpoint clip,
  ``geometry.clip.overlap_stats`` (plain PyTorch on both devices, chunked
  over pairs), the counterpart of the JAX package's ``_overlap_one``, so
  the fields reproduce JAX's ``eulerian_data`` on both of its paths.  That
  clip loses area next to collinear edges (floe edges lying on cell edges,
  ROADMAP §C): the fault is the reference's and is kept for parity.  The
  cells are CCW rectangles of 4 vertices (no padding slot needed), in each
  floe's own frame or, as JAX's traced path has them, in the world frame.
  Only the pairs whose bounding circles meet are clipped; the others'
  areas are 0 in both packages.
* The floe->cell sums are ``index_add_`` (float atomics on CUDA: equal to
  the serial sum within rounding, not bit for bit).
* Boundary floes are excluded from the averages, and the cell area is
  reduced by the exact area of the boundary floes' union in the cell
  (host-side, native engine).  Inside the JAX driver's traced chunk that
  host call is impossible and the JAX function subtracts the per-floe sum
  instead, and its dense path clips in the world frame;
  ``exact_boundary=False`` reproduces both, and the port's driver passes it
  where the JAX driver traces.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig
from .geometry.clip import overlap_stats
from .state import FloeState

__all__ = ["EulerianData", "cell_grid", "cell_window", "eulerian_data",
           "coverage_fraction", "total_mass", "dissolved_mass_grid"]


class EulerianData(NamedTuple):
    """Coarse fields, all [Ny, Nx] (calc_eulerian_data.m:83-100)."""

    u: torch.Tensor
    v: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor          # concentration (area fraction)
    mtot: torch.Tensor
    area: torch.Tensor
    over: torch.Tensor       # mean per-floe overlap area
    stress: torch.Tensor     # [Ny, Nx, 3] (xx, yy, xy)
    strain: torch.Tensor     # [Ny, Nx, 3]
    stress_max_eig: torch.Tensor


def cell_grid(cfg: SimConfig, nx: int, ny: int):
    """Cell rectangles [ny*nx, 4, 2] (CCW) + centers + cell area, numpy.

    Row 0 is the NORTH row (the reference flips y, calc_eulerian_data.m:74).
    """
    lx, ly = cfg.domain.lx, cfg.domain.ly
    xe = np.linspace(-lx, lx, nx + 1)
    ye = np.linspace(ly, -ly, ny + 1)  # flipped: row 0 = north
    cells = np.zeros((ny * nx, 4, 2))
    centers = np.zeros((ny * nx, 2))
    for j in range(ny):
        for i in range(nx):
            x0, x1 = xe[i], xe[i + 1]
            y1, y0 = ye[j], ye[j + 1]   # y0 < y1
            cells[j * nx + i] = [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]
            centers[j * nx + i] = [(x0 + x1) / 2, (y0 + y1) / 2]
    cell_area = (2 * lx / nx) * (2 * ly / ny)
    return cells, centers, cell_area


def cell_window(state: FloeState, cfg: SimConfig, nx: int,
                ny: int) -> tuple[int, int]:
    """(wx, wy): the cell window around a floe's home cell that its
    bounding circle can touch, from the largest live ``rmax`` (one
    device->host copy)."""
    alive_np = state.alive.cpu().numpy()
    rmax_np = state.rmax.cpu().numpy()[alive_np]
    r_big = float(rmax_np.max()) if rmax_np.size else 0.0
    hx = int(np.ceil(r_big / (2 * cfg.domain.lx / nx))) + 1
    hy = int(np.ceil(r_big / (2 * cfg.domain.ly / ny))) + 1
    wx = min(2 * hx + 1, nx if cfg.processes.periodic else 2 * nx)
    wy = min(2 * hy + 1, ny if cfg.processes.periodic else 2 * ny)
    return wx, wy


def _eulerian_sums(state: FloeState, cfg: SimConfig, nx: int, ny: int,
                   wx: int, wy: int, fields, m_over_a, is_b,
                   world_frame: bool = False):
    """Per-cell sums via floe->cell scatter: each floe clips only against
    the wx x wy window of cells around its home cell — O(N w^2) clips.

    The clip's nudge scales with the pair's coordinates, so its collinear
    edge loss depends on the frame.  By default each pair is clipped in the
    floe's frame (JAX's concrete call); ``world_frame`` clips the floe at
    its minimum image about the cell's centre against the cell, both in
    the world frame, as JAX's traced path (``_cell_block_areas``) does.

    Returns [C, F+4]: weighted field sums, atot, a_bound, n_contrib,
    overlap_sum.
    """
    lx, ly = cfg.domain.lx, cfg.domain.ly
    dxc = 2 * lx / nx
    dyc = 2 * ly / ny
    n = state.n
    dtype = state.x.dtype
    dev = state.x.device
    verts = state.verts_rot()                       # [N, V, 2] local
    i32 = torch.int32

    # home cell (row 0 = north)
    ic = torch.floor((state.x + lx) / dxc).to(i32)
    jc = torch.floor((ly - state.y) / dyc).to(i32)
    di = torch.arange(wx, dtype=i32, device=dev) - wx // 2
    dj = torch.arange(wy, dtype=i32, device=dev) - wy // 2
    ix = (ic[:, None, None] + di[None, None, :]).expand(n, wy, wx)
    iy = (jc[:, None, None] + dj[None, :, None]).expand(n, wy, wx)
    ix = ix.reshape(n, wy * wx)
    iy = iy.reshape(n, wy * wx)

    if cfg.processes.periodic:
        valid = state.alive[:, None].expand(ix.shape)
    else:
        valid = (state.alive[:, None] & (ix >= 0) & (ix < nx)
                 & (iy >= 0) & (iy < ny))

    k = wy * wx
    flat = ((iy % ny) * nx + (ix % nx)).long()       # [N, K]
    rmax = state.rmax[:, None]
    if world_frame:
        cells, centers, _ = cell_grid(cfg, nx, ny)
        cells = torch.as_tensor(cells, dtype=dtype, device=dev)
        centers = torch.as_tensor(centers, dtype=dtype, device=dev)
        pos = torch.stack([state.x, state.y], dim=-1)
        ctr = centers[flat]                          # [N, K, 2]
        dxy = ctr - pos[:, None, :]
        if cfg.processes.periodic:
            ll = torch.tensor([lx, ly], dtype=dtype, device=dev)
            eff_pos = pos[:, None, :] + 2.0 * ll * torch.round(
                dxy / (2.0 * ll))
        else:
            eff_pos = pos[:, None, :].expand(n, k, 2)
        rect = cells[flat]                           # [N, K, 4, 2]
        # JAX's bounding-circle mask, which zeroes the other pairs' areas
        r_cell = torch.sqrt(torch.sum((cells[:, 2] - cells[:, 0]) ** 2,
                                      dim=-1)) / 2
        d2 = torch.sum((eff_pos - ctr) ** 2, dim=-1)
        near = d2 < (rmax + r_cell[flat]) ** 2
    else:
        # cell rectangle at the UNWRAPPED index, in the floe-local frame
        # (this makes the periodic minimum image automatic: the floe sees
        # the tiling)
        x0 = -lx + ix.to(dtype) * dxc - state.x[:, None]
        y1 = ly - iy.to(dtype) * dyc - state.y[:, None]
        y0 = y1 - dyc
        x1 = x0 + dxc
        rect = torch.stack([
            torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
            torch.stack([x1, y1], -1), torch.stack([x0, y1], -1),
        ], dim=-2)                                   # [N, K, 4, 2]
        # A pair whose bounding circles stay apart by more than twice the
        # clip's nudge (sqrt(eps) x the pair's coordinate scale) has no
        # probe inside the other polygon: its area is exactly 0.
        d = torch.sqrt((x0 + 0.5 * dxc) ** 2 + (y0 + 0.5 * dyc) ** 2)
        reach = rmax + 0.5 * math.hypot(dxc, dyc)
        nudge = math.sqrt(torch.finfo(dtype).eps) * (d + reach + 1.0)
        near = d < reach + 4.0 * nudge + 1.0
    # clip only the valid pairs that can overlap (the others' areas are 0),
    # in chunks of the segment-midpoint clip; one device->host sync on CUDA
    pick = torch.nonzero((valid & near).reshape(-1)).squeeze(1)
    p = verts[torch.div(pick, k, rounding_mode="floor")]
    if world_frame:
        p = p + eff_pos.reshape(n * k, 2)[pick][:, None, :]
    stats = overlap_stats(p, rect.reshape(n * k, 4, 2)[pick])
    areas = torch.zeros(n * k, dtype=dtype, device=dev).index_copy_(
        0, pick, torch.clamp(stats.area, min=0.0)).reshape(n, k)

    zero = torch.zeros_like(areas)
    a_floe = torch.where(is_b[:, None], zero, areas)
    a_bound = torch.where(is_b[:, None], areas, zero)
    w = a_floe * m_over_a[:, None]
    contrib = (a_floe > 0).to(dtype)
    over = contrib * state.overlap_area[:, None]

    flat = flat.reshape(-1)                          # [N*K]
    n_f = fields.shape[1]
    # [N, K, F+4] contributions -> scatter-add into [C, F+4]
    contribs = torch.cat([
        w[:, :, None] * fields[:, None, :],
        a_floe[:, :, None], a_bound[:, :, None],
        contrib[:, :, None], over[:, :, None],
    ], dim=2).reshape(-1, n_f + 4)
    out = torch.zeros((ny * nx, n_f + 4), dtype=dtype, device=dev)
    return out.index_add_(0, flat, contribs)


def coverage_fraction(state: FloeState, cfg: SimConfig, nx: int, ny: int
                      ) -> np.ndarray:
    """Ice coverage (ALL floes incl. topography) / cell area, [ny, nx] with
    row 0 = north — the packing concentration of create_new_ice.m:109-125,
    from the floe->cell clip instead of per-(cell, floe) native boolean
    calls."""
    n = state.n
    dtype = state.x.dtype
    dev = state.x.device
    fields = torch.ones((n, 1), dtype=dtype, device=dev)
    m_over_a = torch.zeros((n,), dtype=dtype, device=dev)
    is_b = torch.zeros((n,), dtype=torch.bool, device=dev)  # topography too
    wx, wy = cell_window(state, cfg, nx, ny)
    out = _eulerian_sums(state, cfg, nx, ny, wx, wy, fields, m_over_a, is_b)
    cell_area = (2 * cfg.domain.lx / nx) * (2 * cfg.domain.ly / ny)
    atot = out[:, 1].cpu().numpy().reshape(ny, nx)
    return atot / cell_area


def _boundary_union_cell_areas(state: FloeState, cfg: SimConfig, cells,
                               n_b: int) -> torch.Tensor:
    """Exact area of (union of boundary floes) ∩ cell, [C], host-side
    (calc_eulerian_data.m:144-149)."""
    from .native import poly_area, poly_boolean, union_all

    nv = state.nv[:n_b].cpu().numpy()
    verts = state.verts_world()[:n_b].cpu().numpy()
    alive = state.alive[:n_b].cpu().numpy()
    polys = [verts[i, : nv[i]].astype(np.float64)
             for i in range(n_b) if alive[i] and nv[i] >= 3]
    cells_np = np.asarray(cells)
    out = np.zeros(cells_np.shape[0])
    if polys:
        uni = union_all(polys)
        for c in range(cells_np.shape[0]):
            for contour in uni:
                inter = poly_boolean(contour, cells_np[c], "int")
                out[c] += sum(poly_area(r) for r in inter)
    return torch.as_tensor(out, dtype=state.x.dtype, device=state.x.device)


def eulerian_data(state: FloeState, cfg: SimConfig, nx: int = 10,
                  ny: int = 10, window: "tuple[int, int] | None" = None,
                  exact_boundary: bool = True) -> EulerianData:
    """Mass-weighted coarse averages (calc_eulerian_data.m:136-187).

    ``window``: the (wx, wy) cell window of ``cell_window``; None sizes it
    from this state (one device->host copy).  ``exact_boundary``: subtract
    the exact boundary-floe union from the cell area (host-side), as the
    JAX function's concrete call does; False reproduces its traced path,
    which subtracts the per-floe sum and clips in the world frame.
    """
    cells, _, cell_area = cell_grid(cfg, nx, ny)
    n = state.n
    n_b = cfg.n_boundary
    dtype = state.x.dtype
    dev = state.x.device
    is_b = torch.arange(n, device=dev) < n_b

    # per-floe field matrix [N, F]: 1 (-> mtot), u, v, du, dv, h,
    # stress(3), strain(3)
    fields = torch.stack([
        torch.ones((n,), dtype=dtype, device=dev), state.u, state.v,
        state.du_p, state.dv_p, state.h,
        state.stress[:, 0], state.stress[:, 1], state.stress[:, 2],
        state.strain[:, 0], state.strain[:, 1], state.strain[:, 2],
    ], dim=1)
    n_f = fields.shape[1]
    m_over_a = torch.where(is_b, torch.zeros_like(state.mass),
                           state.mass / torch.clamp(state.area, min=1e-30))

    wx, wy = window if window is not None else cell_window(state, cfg, nx,
                                                           ny)
    out = _eulerian_sums(state, cfg, nx, ny, wx, wy, fields, m_over_a, is_b,
                         world_frame=not exact_boundary)
    sums = out[:, :n_f]
    atot = out[:, n_f]
    a_bound_tot = out[:, n_f + 1]
    n_contrib = torch.clamp(out[:, n_f + 2], min=1.0)
    over = out[:, n_f + 3] / n_contrib

    mtot = sums[:, 0]
    denom = torch.where(mtot > 0, mtot, torch.ones_like(mtot))

    # Cell area minus the boundary-floe UNION (calc_eulerian_data.m:144-149
    # subtracts the union polygon).  Boundary floes are static, so the exact
    # union∩cell areas are computed host-side with the native engine.
    if n_b > 0:
        if exact_boundary:
            b_union = _boundary_union_cell_areas(state, cfg, cells, n_b)
            eff_cell_area = torch.clamp(cell_area - b_union, min=1e-12)
        else:
            eff_cell_area = torch.clamp(cell_area - a_bound_tot, min=1e-12)
    else:
        eff_cell_area = cell_area

    def avg(k):
        return sums[:, k] / denom

    sxx, syy, sxy = avg(6), avg(7), avg(8)
    # max eigenvalue of the symmetric 2x2 (calc_eulerian_data.m:180-183)
    tr2 = 0.5 * (sxx + syy)
    disc = torch.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy,
                                  min=0.0))
    smax = tr2 + disc
    smax = torch.where(torch.abs(smax) > 1e8, torch.zeros_like(smax), smax)

    def grid(x):
        return x.reshape(ny, nx)

    return EulerianData(
        u=grid(avg(1)),
        v=grid(avg(2)),
        du=grid(avg(3)),
        dv=grid(avg(4)),
        h=grid(avg(5)),
        c=grid(atot / eff_cell_area),
        mtot=grid(mtot),
        area=grid(atot),
        over=grid(over),
        stress=torch.stack([grid(sxx), grid(syy), grid(sxy)], dim=-1),
        strain=torch.stack([grid(avg(9)), grid(avg(10)), grid(avg(11))],
                           dim=-1),
        stress_max_eig=grid(smax),
    )


def total_mass(state: FloeState) -> torch.Tensor:
    """Total live floe mass (the Mtot series, Subzero.m:294-295)."""
    return torch.sum(torch.where(state.alive, state.mass,
                                 torch.zeros_like(state.mass)))


def dissolved_mass_grid(state: FloeState, killed: torch.Tensor,
                        cfg: SimConfig, nx: int = 10, ny: int = 10):
    """Bin the mass of killed floes into the coarse grid
    (calc_dissolved_mass.m:10-24: entire floe mass assigned to the cell
    containing its centroid)."""
    lx, ly = cfg.domain.lx, cfg.domain.ly
    i32 = torch.int32
    ix = torch.clamp(((state.x + lx) / (2 * lx / nx)).to(i32), 0, nx - 1)
    # row 0 = north (flipped y)
    iy = torch.clamp(((ly - state.y) / (2 * ly / ny)).to(i32), 0, ny - 1)
    flat = (iy * nx + ix).long()
    contrib = torch.where(killed, state.mass, torch.zeros_like(state.mass))
    grid = torch.zeros((ny * nx,), dtype=state.mass.dtype,
                       device=state.mass.device).index_add_(0, flat, contrib)
    return grid.reshape(ny, nx)
