"""Builds the winter recipe (SubZero validation_cases/winter.tar.gz,
winter/Subzero.m:5-22, with README.md Validation 3's mu) as a
``subzero_tpu_torch.sim.Simulation``, through the program's public
constructors: the parameters of ``subzero_tpu_torch/validation.py:
winter_sim``, read from ``winter.json`` and the cell's traffic (which may
scale the domain and the gyre with it)."""

from __future__ import annotations

from benchlib.inputs import (
    Inputs, floe_field, gyre_grid, modulus_of, program_forcing,
    thermo_heat_flux,
)


def make_inputs(recipe: dict, traffic: dict, seed: int) -> Inputs:
    """The seed's floes, gyre ocean, modulus and heat flux."""
    lx = float(traffic.get("lx", recipe["lx"]))
    ly = float(traffic.get("ly", recipe["ly"]))
    polys, heights = floe_field(lx, ly, int(recipe["max_verts"]), traffic,
                                recipe, seed)
    grid = gyre_grid(float(traffic.get("gyre_lx", recipe["gyre_lx"])),
                     float(traffic.get("gyre_dx", recipe["gyre_dx"])),
                     float(traffic.get("gyre_transport",
                                       recipe["gyre_transport"])),
                     wind_u=float(recipe["winds"]),
                     wind_v=float(recipe["winds"]))
    return Inputs(polys=polys, heights=heights, grid=grid,
                  modulus=modulus_of(polys, 1.5e3),
                  heat_flux=thermo_heat_flux(), lx=lx, ly=ly)


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
    flags = ("collision", "fractures", "corners", "welding", "ridging",
             "rafting", "packing", "periodic", "keep_min", "average")
    cfg = SimConfig(
        physics=PhysicsConfig(mu_friction=float(recipe["mu_friction"])),
        contact=ContactConfig(per_region=bool(recipe["per_region"])),
        processes=ProcessConfig(n_pack=int(recipe["n_pack"]),
                                **{k: bool(recipe[k]) for k in flags}),
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
    cfg = cfg.replace(
        min_floe_size=float(traffic.get(
            "min_floe_size", 4 * inp.lx * inp.ly / 20000.0)),
        heat_flux=inp.heat_flux)
    tdt = torch.float32 if dtype == "float32" else torch.float64
    sim = Simulation(cfg=cfg, state=st,
                     forcing=program_forcing(inp.grid, tdt, device),
                     modulus=inp.modulus, heat_flux=inp.heat_flux,
                     seed=seed, step_idx=int(traffic.get("start_step", 0)))
    return sim, inp
