"""Builds SubZero's Nares Strait export (README.md Validation 2) as a
``subzero_tpu_torch.sim.Simulation``, through the program's public
constructors: the parameters of ``subzero_tpu_torch/validation.py:
nares_sim``, read from ``nares.json`` and the cell's traffic.

Slots ``[0, n_boundary)`` hold the two static coastline polygons; the free
floes follow.  ``--seed`` reorders the free floes only, so the coastline
stays below ``n_boundary`` for every seed.  A cell whose traffic names a
``start_state`` (``nares_start.py`` writes it) starts from the free floes
and fields that file holds, at its step, instead of the published field at
step 0; the modulus stays the published field's."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from benchlib.inputs import (
    Inputs, floe_field, gyre_grid, modulus_of, program_forcing,
)

HERE = Path(__file__).resolve().parent

# the per-floe fields a start state carries besides the polygon (h sets
# the mass through state_from_polygons; the rest are set as stored)
START_FIELDS = ("h", "u", "v", "ksi", "dx_p", "dy_p", "dalpha_p", "du_p",
                "dv_p", "dksi_p", "fx_oa", "fy_oa", "tq_oa", "stress_hist",
                "stress", "strain", "overlap_area")


@dataclasses.dataclass
class NaresInputs(Inputs):
    """The inputs, the number of coastline polygons leading ``polys``,
    and the start state's fields for the free floes (``None``: the
    published field at rest)."""

    n_boundary: int = 0
    start: "dict | None" = None
    start_step: int = 0


def coastline(lx: float, ly: float, half_width: float, top: float,
              bottom: float) -> list:
    """The idealized Nares coastline, the port's own copy of
    ``subzero_tpu_torch/validation.py:nares_topography``: two mirror-image
    land masses forming a funnel (north) into a straight channel of
    half-width ``half_width`` between ``top`` and ``bottom``, opening to
    the south basin."""
    west = np.array([
        [-lx, bottom],
        [-half_width, bottom],
        [-half_width, top],
        [-lx * 0.85, top + 1.1e5],
        [-lx, top + 1.2e5],
    ])
    east = west.copy()
    east[:, 0] = -east[:, 0]
    return [west, east[::-1]]


def published_field(recipe: dict, traffic: dict, seed: int):
    """The free floes of the recipe's start (concentration [1; 0], README
    1d): the generator's field in a box of half-height ly/2, moved north
    by ly/2, floes outside |y| < ly dropped; ``seed`` orders them."""
    lx, ly = float(recipe["lx"]), float(recipe["ly"])
    polys, heights = floe_field(lx, ly / 2, int(recipe["max_verts"]), traffic,
                                recipe, seed)
    polys = [p + np.array([0.0, ly / 2]) for p in polys]
    keep = [k for k, p in enumerate(polys) if np.all(np.abs(p[:, 1]) < ly)]
    return [polys[k] for k in keep], np.asarray(heights, np.float64)[keep]


def write_start(path, step: int, polys, fields: dict, **meta) -> None:
    """A start state as a plain npz: the step ``S``, each free floe's
    world-frame polygon (``poly`` padded to the longest, ``nv`` vertices
    each) and its ``fields`` (:data:`START_FIELDS`, one row a floe), and
    numbers that describe it (``meta``)."""
    n = len(polys)
    nv = np.array([len(p) for p in polys], np.int32)
    poly = np.zeros((n, int(nv.max(initial=1)), 2))
    for k, p in enumerate(polys):
        poly[k, :len(p)] = p
        poly[k, len(p):] = p[-1]
    arrays = {f: np.asarray(fields[f]) for f in START_FIELDS}
    for f, a in arrays.items():
        if len(a) != n:
            raise ValueError(f"{f} has {len(a)} rows for {n} floes")
    np.savez_compressed(path, S=np.int64(step), poly=poly, nv=nv, **arrays,
                        **{k: np.asarray(v) for k, v in meta.items()})


def read_start(path):
    """(step, polygons, fields, meta) of a file :func:`write_start` made."""
    with np.load(path) as z:
        nv = z["nv"]
        polys = [z["poly"][k, :nv[k]].astype(np.float64)
                 for k in range(len(nv))]
        fields = {f: z[f] for f in START_FIELDS}
        meta = {k: z[k] for k in z.files
                if k not in START_FIELDS and k not in ("S", "poly", "nv")}
        return int(z["S"]), polys, fields, meta


def make_inputs(recipe: dict, traffic: dict, seed: int) -> NaresInputs:
    """The coastline, the seed's free floes, the forcing grid and the
    modulus (over the published field's free floes)."""
    lx, ly = float(recipe["lx"]), float(recipe["ly"])
    coast = coastline(lx, ly, float(recipe["coast_half_width"]),
                      float(recipe["coast_top"]),
                      float(recipe["coast_bottom"]))
    free, heights = published_field(recipe, traffic, seed)
    modulus = modulus_of(free, float(recipe["modulus_coeff"]))
    start, step = None, int(traffic.get("start_step", 0))
    if traffic.get("start_state"):
        # a name beside this file, or an absolute path (the tests')
        s_step, free, fields, _ = read_start(HERE / traffic["start_state"])
        if s_step != step:
            raise ValueError(f"the start state is at step {s_step}, the "
                             f"cell starts at step {step}")
        order = np.random.default_rng([seed % 2**63, 3]).permutation(
            len(free))
        free = [free[k] for k in order]
        start = {f: np.asarray(a)[order] for f, a in fields.items()}
        heights = start["h"].astype(np.float64)
    grid = gyre_grid(float(recipe["forcing_lx"]), float(recipe["forcing_dx"]),
                     float(recipe["ocean_transport"]),
                     wind_u=float(recipe["wind_u"]),
                     wind_v=float(recipe["wind_v"]))
    return NaresInputs(
        polys=coast + free,
        heights=np.concatenate([np.full(len(coast), float(recipe["coast_h"])),
                                heights]),
        grid=grid, modulus=modulus, heat_flux=0.0, lx=lx, ly=ly,
        n_boundary=len(coast), start=start, start_step=step)


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
    flags = ("collision", "fractures", "corners", "kill_below_ymin",
             "periodic")
    cfg = SimConfig(
        physics=PhysicsConfig(mu_friction=float(recipe["mu_friction"])),
        contact=ContactConfig(per_region=bool(recipe["per_region"])),
        processes=ProcessConfig(
            n_fracture=int(recipe["n_fracture"]),
            fracture_criterion=recipe["fracture_criterion"],
            fracture_pstar=float(recipe["fracture_pstar"]),
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
        n_boundary=inp.n_boundary,
    )
    st = state_from_polygons(inp.polys, inp.heights, cfg, seed=seed,
                             device=device)
    if inp.start is not None:
        rows = slice(inp.n_boundary, n)
        upd = {}
        for f, a in inp.start.items():
            if f == "h":
                continue
            t = getattr(st, f).clone()
            t[rows] = torch.as_tensor(a).to(device=t.device, dtype=t.dtype)
            upd[f] = t
        st = st.replace(**upd)
    cfg = cfg.replace(min_floe_size=float(
        traffic.get("min_floe_size", 4 * inp.lx * inp.ly / 20000.0)))
    tdt = torch.float32 if dtype == "float32" else torch.float64
    sim = Simulation(cfg=cfg, state=st,
                     forcing=program_forcing(inp.grid, tdt, device),
                     modulus=inp.modulus, heat_flux=inp.heat_flux,
                     seed=seed, step_idx=inp.start_step)
    return sim, inp
