"""Dissolved-ice advection-diffusion on the coarse grid — port of
``subzero_tpu/dissolved.py`` (``Physical_Processes/Advect_Dissolved_Ice.m``).

The reference driver has this disabled in favor of pure accumulation
(Subzero.m:359-363), and so does ``Simulation`` by default
(``ProcessConfig.advect_dissolved``).  Semantics
(Advect_Dissolved_Ice.m:33-94): Adams-Bashforth advection of the
dissolved-mass field by the coarse ocean velocity with diffusion
(kappa = 1e4 m^2/s), zero-flux boundaries.
"""

from __future__ import annotations

import torch

from .config import SimConfig
from .forcing import Forcing, interp_bilinear


def _pad_edge(f: torch.Tensor) -> torch.Tensor:
    """Pad a [Ny, Nx] field by one cell on every side, repeating the edge
    (``jnp.pad(f, 1, mode="edge")``)."""
    f = torch.cat([f[:1], f, f[-1:]], dim=0)
    return torch.cat([f[:, :1], f, f[:, -1:]], dim=1)


def _lap(f: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """5-point Laplacian with zero-gradient edges."""
    fp = _pad_edge(f)
    return ((fp[1:-1, 2:] - 2 * f + fp[1:-1, :-2]) / dx**2
            + (fp[2:, 1:-1] - 2 * f + fp[:-2, 1:-1]) / dy**2)


def advect_dissolved(vd: torch.Tensor, vd_prev_tend: torch.Tensor,
                     forcing: Forcing, cfg: SimConfig, dt: float,
                     nx: int, ny: int, kappa: float = 1e4):
    """One AB2 advection-diffusion step of the dissolved field.

    vd: [Ny, Nx] dissolved mass; vd_prev_tend: previous tendency (AB2).
    Returns (vd_new, tendency).
    """
    lx, ly = cfg.domain.lx, cfg.domain.ly
    dx = 2 * lx / nx
    dy = 2 * ly / ny
    kw = dict(dtype=vd.dtype, device=vd.device)
    # cell centers (row 0 = north, matching diagnostics.cell_grid)
    xs = torch.linspace(-lx + dx / 2, lx - dx / 2, nx, **kw)
    ys = torch.linspace(ly - dy / 2, -ly + dy / 2, ny, **kw)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    args = (forcing.x0, forcing.y0, forcing.dx)
    u = interp_bilinear(forcing.uo, xg, yg, *args)
    v = interp_bilinear(forcing.vo, xg, yg, *args)

    # upwind advective flux divergence
    fp = _pad_edge(vd)
    ddx = torch.where(u > 0,
                      (vd - fp[1:-1, :-2]) / dx,
                      (fp[1:-1, 2:] - vd) / dx)
    # note: row 0 = north -> +y is decreasing row index
    ddy = torch.where(v > 0,
                      (vd - fp[2:, 1:-1]) / dy,
                      (fp[:-2, 1:-1] - vd) / dy)
    tend = -(u * ddx + v * ddy) + kappa * _lap(vd, dx, dy)
    vd_new = vd + dt * (1.5 * tend - 0.5 * vd_prev_tend)
    vd_new = torch.clamp(vd_new, min=0.0)  # Vd(Vd<0)=0 (create_new_ice.m:287)
    return vd_new, tend
