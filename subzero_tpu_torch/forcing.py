"""Ocean and atmosphere forcing fields on torch tensors.

Port of ``subzero_tpu/forcing.py``.  The forcing lives on a regular grid and
is sampled with bilinear interpolation (the reference uses ``interp2`` at
``calc_trajectory.m:134-137``) by the plain gather of ``interp_bilinear``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .state import torch_dtype

__all__ = ["Forcing", "interp_bilinear", "interp_bilinear_mxu",
           "sample_forcing", "gyre_ocean", "uniform_forcing", "thermo_params"]


@dataclasses.dataclass(frozen=True)
class Forcing:
    """Regular-grid ocean + wind forcing.

    x0, y0, dx: 0-d tensors, grid origin and spacing (shared by all fields)
    uo, vo:     [Ny, Nx] ocean surface currents
    ua, va:     [Ny, Nx] 10-m winds
    """

    x0: torch.Tensor
    y0: torch.Tensor
    dx: torch.Tensor
    uo: torch.Tensor
    vo: torch.Tensor
    ua: torch.Tensor
    va: torch.Tensor

    @property
    def nx(self) -> int:
        return self.uo.shape[1]

    @property
    def ny(self) -> int:
        return self.uo.shape[0]

    def extent(self):
        """(xmin, xmax, ymin, ymax) of the grid, 0-d tensors."""
        return (
            self.x0,
            self.x0 + (self.nx - 1) * self.dx,
            self.y0,
            self.y0 + (self.ny - 1) * self.dx,
        )

    def to(self, device=None, dtype=None) -> "Forcing":
        return Forcing(**{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)})


def interp_bilinear(field: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                    x0, y0, dx) -> torch.Tensor:
    """Bilinear sample of ``field[Ny, Nx]`` at world points (clamped to the
    grid; out-of-grid floes are killed by an explicit bounds check upstream,
    mirroring calc_trajectory.m:116-117 rather than interp2's NaN fill)."""
    gx = (fx - x0) / dx
    gy = (fy - y0) / dx
    ny, nx = field.shape
    gx = torch.clamp(gx, 0.0, nx - 1.000001)
    gy = torch.clamp(gy, 0.0, ny - 1.000001)
    fgx = torch.floor(gx)
    fgy = torch.floor(gy)
    ix = fgx.long()
    iy = fgy.long()
    tx = gx - fgx
    ty = gy - fgy
    f00 = field[iy, ix]
    f01 = field[iy, ix + 1]
    f10 = field[iy + 1, ix]
    f11 = field[iy + 1, ix + 1]
    return (
        f00 * (1 - ty) * (1 - tx)
        + f01 * (1 - ty) * tx
        + f10 * ty * (1 - tx)
        + f11 * ty * tx
    )


def interp_bilinear_mxu(fields: torch.Tensor, fx: torch.Tensor,
                        fy: torch.Tensor, x0, y0, dx,
                        chunk: int = 65536) -> torch.Tensor:
    """Bilinear sample of ``fields[C, Ny, Nx]`` at flat points [P] -> [C, P],
    with the JAX package's signature and values.

    The JAX version contracts two one-hot weight matrices with the fields
    as matrix products over point chunks of ``chunk``, because a gather is
    slow on a TPU and its matrix unit is not: a TPU layout trick.  A GPU
    gathers at memory speed, and the one-hot matmuls would read Ny + Nx
    weights per point where the gather reads four values; so here it is
    the plain gather of ``interp_bilinear`` per field, and ``chunk`` has no
    effect.
    """
    px, py = fx.reshape(-1), fy.reshape(-1)
    return torch.stack([interp_bilinear(f, px, py, x0, y0, dx)
                        for f in fields])


def sample_forcing(forcing: Forcing, px: torch.Tensor, py: torch.Tensor):
    """Sample (uo, vo, ua, va) at world points of any shape."""
    args = (px, py, forcing.x0, forcing.y0, forcing.dx)
    return (
        interp_bilinear(forcing.uo, *args),
        interp_bilinear(forcing.vo, *args),
        interp_bilinear(forcing.ua, *args),
        interp_bilinear(forcing.va, *args),
    )


def _forcing(x0, dx, uo, vo, ua, va, dtype, device) -> Forcing:
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device=dev,
                                                              dtype=dt)

    return Forcing(x0=t(x0), y0=t(x0), dx=t(dx), uo=t(uo), vo=t(vo),
                   ua=t(ua), va=t(va))


def gyre_ocean(
    lx: float = 4e5,
    dx: float = 1e4,
    transport: float = 0.5e4,
    n_gyres: int = 4,
    wind_u: float = 0.0,
    wind_v: float = 0.0,
    dtype=torch.float32,
    device=None,
) -> Forcing:
    """The reference's default 4-gyre sinusoidal ocean
    (initialize_ocean.m:11-24): psi = T sin(4 kx X) sin(4 ky Y) on a
    [-lx, lx]^2 grid, velocities by one-sided finite difference of psi
    (u = -dpsi/dy, v = +dpsi/dx), plus uniform winds (Subzero.m:46-49)."""
    k = np.pi / lx
    xs = np.arange(-lx, lx + dx / 2, dx)
    xg, yg = np.meshgrid(xs, xs)
    psi = transport * np.sin(n_gyres * k * xg) * np.sin(n_gyres * k * yg)
    uo = np.zeros_like(psi)
    vo = np.zeros_like(psi)
    # Reference uses one-sided differences (initialize_ocean.m:22-24).
    uo[1:, :] = -(psi[1:, :] - psi[:-1, :]) / dx
    vo[:, 1:] = (psi[:, 1:] - psi[:, :-1]) / dx
    return _forcing(-lx, dx, uo, vo, np.full(psi.shape, wind_u),
                    np.full(psi.shape, wind_v), dtype, device)


def uniform_forcing(
    lx: float = 4e5,
    dx: float = 1e4,
    uo: float = 0.0,
    vo: float = 0.0,
    ua: float = 0.0,
    va: float = 0.0,
    dtype=torch.float32,
    device=None,
) -> Forcing:
    """Spatially uniform forcing (for tests and the Nares wind case)."""
    xs = np.arange(-lx, lx + dx / 2, dx)
    shape = (len(xs), len(xs))
    return _forcing(-lx, dx, np.full(shape, uo), np.full(shape, vo),
                    np.full(shape, ua), np.full(shape, va), dtype, device)


def thermo_params(dt: float, n_dt_pack: int,
                  k: float = 2.14, t_air: float = -20.0, t_ocean: float = 0.0,
                  rho_ice: float = 920.0, latent: float = 2.93e5):
    """Ocean heat flux HFo and new-ice thickness h0
    (initialize_ocean.m:37-46).  NOTE the reference overwrites the caller's
    dt with 10 s at initialize_ocean.m:38; we honor the passed dt."""
    heat_flux = k * (t_air - t_ocean) / (rho_ice * latent)
    h0 = float(np.sqrt(max(2 * k * dt * n_dt_pack * (t_ocean - t_air), 0.0)
                       / (rho_ice * latent)))
    return heat_flux, h0
