"""Builds the uniaxial-compression recipe (SubZero README.md, Validation 1)
as a ``subzero_tpu_torch.sim.Simulation``, through the program's public
constructors: the parameters of ``subzero_tpu_torch/validation.py:
uniaxial_sim``, read from ``uniaxial.json`` and the cell's traffic."""

from __future__ import annotations

from benchlib.inputs import Inputs, floe_field, modulus_of, program_forcing, still_grid


def make_inputs(recipe: dict, traffic: dict, seed: int) -> Inputs:
    """The seed's floes, forcing grid, modulus and wall schedule."""
    lx = float(traffic.get("lx", recipe["lx"]))
    ly = float(traffic.get("ly", recipe["ly"]))
    polys, heights = floe_field(lx, ly, int(recipe["max_verts"]), traffic,
                                recipe, seed)
    step_m = float(recipe["wall_step_m"])
    cad = int(recipe["wall_cadence"])
    stop = float(recipe["wall_stop_frac"]) * ly

    def wall_fn(step_idx: int):
        # the N/S walls close wall_step_m every wall_cadence steps until
        # they reach wall_stop_frac of the half-width (README.md 1j)
        return lx, max(ly - step_m * (step_idx // cad), stop)

    return Inputs(polys=polys, heights=heights,
                  grid=still_grid(4 * lx, lx / 10),
                  modulus=modulus_of(polys, float(recipe["modulus_coeff"])),
                  heat_flux=float(recipe["heat_flux"]), lx=lx, ly=ly,
                  wall_fn=wall_fn, wall_cadence=cad)


def build(recipe: dict, traffic: dict, seed: int, device, dtype=None):
    """(Simulation, Inputs) for one seed; ``dtype`` overrides the recipe's
    (the CPU tests run float64)."""
    import torch

    from subzero_tpu_torch.config import (
        CapacityConfig, ContactConfig, DomainConfig, NumericsConfig,
        PhysicsConfig, ProcessConfig, SimConfig,
    )
    from subzero_tpu_torch.sim import Simulation
    from subzero_tpu_torch.state import state_from_polygons

    inp = make_inputs(recipe, traffic, seed)
    dtype = dtype or recipe["dtype"]
    n = len(inp.polys)
    cfg = SimConfig(
        physics=PhysicsConfig(ocean_coupling=bool(recipe["ocean_coupling"]),
                              mu_friction=float(recipe["mu_friction"])),
        contact=ContactConfig(per_region=bool(recipe["per_region"])),
        processes=ProcessConfig(
            collision=bool(recipe["collision"]),
            fractures=bool(recipe["fractures"]),
            corners=bool(recipe["corners"]),
            n_fracture=int(recipe["n_fracture"]),
            fracture_sig11=float(recipe["fracture_sig11"])),
        numerics=NumericsConfig(dt=float(recipe["dt"]), dtype=dtype,
                                contact_impl=recipe["contact_impl"]),
        domain=DomainConfig(lx=inp.lx, ly=inp.ly),
        capacity=CapacityConfig(
            max_floes=-(-2 * n // 8) * 8,
            max_verts=int(recipe["max_verts"]),
            max_neighbors=int(recipe["max_neighbors"]),
            n_mc_points=int(recipe["n_mc_points"]),
            stress_window=int(recipe["stress_window"])),
    )
    st = state_from_polygons(inp.polys, inp.heights, cfg, seed=seed,
                             device=device)
    cfg = cfg.replace(min_floe_size=float(
        traffic.get("min_floe_size", 4 * inp.lx * inp.ly / 20000.0)))
    tdt = torch.float32 if dtype == "float32" else torch.float64
    sim = Simulation(cfg=cfg, state=st,
                     forcing=program_forcing(inp.grid, tdt, device),
                     modulus=inp.modulus, heat_flux=inp.heat_flux,
                     wall_fn=inp.wall_fn, wall_cadence=inp.wall_cadence,
                     seed=seed, step_idx=int(traffic.get("start_step", 0)))
    return sim, inp
