"""Inputs the benchmark makes from a seed and hands to both sides: floe
polygons and thicknesses, the forcing grids, the modulus and the wall
schedule.  Numpy only; the program gets them through its public
constructors (:func:`program_forcing`)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .voronoi import voronoi_floe_field


@dataclasses.dataclass
class Inputs:
    """What one seed makes for one cell."""

    polys: list            # world-frame floe polygons [n_i, 2]
    heights: np.ndarray    # [n] thickness, m
    grid: dict             # forcing grid: x0, dx, uo, vo, ua, va (numpy)
    modulus: float
    heat_flux: float
    lx: float
    ly: float
    wall_fn: "Callable[[int], tuple[float, float]] | None" = None
    wall_cadence: int = 30


def shoelace(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def floe_field(lx: float, ly: float, v_cap: int, traffic: dict,
               recipe: dict, seed: int):
    """The Voronoi field of a cell: ``traffic['n_floes']`` floes on a
    ``traffic['conc_grid']`` square grid of concentration
    ``recipe['target_concentration']`` (a scalar where the grid is 1),
    culled below ``traffic['voronoi_min_floe_size']`` (the generator's
    default, 4 lx ly / 10000, where absent).

    With ``traffic['layout_seed']`` the field itself is that seed's, the
    same for every run, and ``seed`` puts its floes in another order: every
    seed then gives the program the same floes to move, so runs of two
    seeds do the same work.  Without it the field is ``seed``'s own."""
    g = int(traffic.get("conc_grid", 1))
    c = float(recipe["target_concentration"])
    conc = c if g == 1 else np.full((g, g), c)
    layout = traffic.get("layout_seed")
    polys, heights = voronoi_floe_field(
        lx, ly, v_cap, conc, int(traffic["n_floes"]),
        height_mean=float(recipe["height_mean"]),
        height_delta=float(recipe["height_delta"]),
        min_floe_size=traffic.get("voronoi_min_floe_size"),
        seed=seed if layout is None else int(layout))
    if layout is not None:
        order = np.random.default_rng([seed % 2**63, 3]).permutation(
            len(polys))
        polys = [polys[i] for i in order]
        heights = np.asarray(heights)[order]
    return polys, heights


def modulus_of(polys, coeff: float) -> float:
    """``coeff`` x (mean + min of sqrt(area)) over the floes (Subzero.m:77)."""
    r = np.sqrt(np.abs(np.array([shoelace(p) for p in polys])))
    return float(coeff * (r.mean() + r.min()))


def gyre_grid(lx: float, dx: float, transport: float, n_gyres: int = 4,
              wind_u: float = 0.0, wind_v: float = 0.0) -> dict:
    """The reference's 4-gyre ocean (initialize_ocean.m:11-24): psi = T
    sin(4 k X) sin(4 k Y) on [-lx, lx]^2, velocities by one-sided
    differences of psi, and uniform winds."""
    k = np.pi / lx
    xs = np.arange(-lx, lx + dx / 2, dx)
    xg, yg = np.meshgrid(xs, xs)
    psi = transport * np.sin(n_gyres * k * xg) * np.sin(n_gyres * k * yg)
    uo = np.zeros_like(psi)
    vo = np.zeros_like(psi)
    uo[1:, :] = -(psi[1:, :] - psi[:-1, :]) / dx
    vo[:, 1:] = (psi[:, 1:] - psi[:, :-1]) / dx
    return dict(x0=-lx, dx=dx, uo=uo, vo=vo, ua=np.full(psi.shape, wind_u),
                va=np.full(psi.shape, wind_v))


def still_grid(lx: float, dx: float) -> dict:
    """Still ocean and air on a [-lx, lx]^2 grid."""
    n = len(np.arange(-lx, lx + dx / 2, dx))
    z = np.zeros((n, n))
    return dict(x0=-lx, dx=dx, uo=z, vo=z, ua=z, va=z)


def thermo_heat_flux(k: float = 2.14, t_air: float = -20.0,
                     t_ocean: float = 0.0, rho_ice: float = 920.0,
                     latent: float = 2.93e5) -> float:
    """Ocean heat flux HFo of initialize_ocean.m:37-46."""
    return k * (t_air - t_ocean) / (rho_ice * latent)


def program_forcing(grid: dict, dtype, device):
    """The grid as the program's ``Forcing`` (its public dataclass)."""
    import torch

    from subzero_tpu_torch.forcing import Forcing

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)

    return Forcing(x0=t(grid["x0"]), y0=t(grid["x0"]), dx=t(grid["dx"]),
                   uo=t(grid["uo"]), vo=t(grid["vo"]), ua=t(grid["ua"]),
                   va=t(grid["va"]))
