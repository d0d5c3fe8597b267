"""The PyTorch port's physics step against the JAX step, float64 on the CPU.

Both packages start from the same numpy state and forcing (carried across
with ``subzero_tpu_torch.convert``) and run in lockstep in the
aggregate-contact mode (``ContactConfig(per_region=False)``, the mode the
port runs so far).  Tolerances: positions within 1e-6 m and velocities
within 1e-9 m/s — the convex envelope of test_golden.py — and the same
collision count every step.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.config import (
    CapacityConfig, ContactConfig, DomainConfig, NumericsConfig,
    ProcessConfig, SimConfig,
)
from subzero_tpu.dynamics.step import make_step_fn
from subzero_tpu.forcing import gyre_ocean, uniform_forcing
from subzero_tpu.state import state_from_polygons

import subzero_tpu_torch.config as tcfg
from subzero_tpu_torch.convert import (
    forcing_from_numpy, state_from_numpy, state_to_numpy,
)
from subzero_tpu_torch.dynamics.step import make_step_fn as torch_step_fn

torch.set_num_threads(1)

MODULUS = 1.6e8


def lattice(side: int, seed: int = 0, pitch: float = 4000.0):
    """A side x side dense pack of jittered quads at ~93% concentration
    (the bench.py workload at small size), with random velocities."""
    lx = side * pitch / 2
    rng = np.random.default_rng(seed)
    sq = 0.5 * np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    polys = []
    for k in range(side * side):
        i, j = divmod(k, side)
        center = np.array([-lx + (j + 0.5) * pitch, -lx + (i + 0.5) * pitch])
        jitter = rng.uniform(-0.03, 0.03, size=(4, 2)) * pitch
        polys.append(sq * pitch * 0.97 + jitter + center)
    vel = rng.uniform(-0.1, 0.1, size=(side * side, 2))
    return polys, vel, lx


def configs(n, lx, periodic):
    """The same configuration in both packages (the port keeps its own
    copy of config.py)."""
    kw = dict(
        capacity=dict(max_floes=n, max_verts=16, max_neighbors=8,
                      n_mc_points=32, stress_window=16),
        numerics=dict(dtype="float64"),
        domain=dict(lx=lx, ly=lx),
        processes=dict(periodic=periodic),
        contact=dict(per_region=False),
    )
    jcfg = SimConfig(
        capacity=CapacityConfig(**kw["capacity"]),
        numerics=NumericsConfig(**kw["numerics"]),
        domain=DomainConfig(**kw["domain"]),
        processes=ProcessConfig(**kw["processes"]),
        contact=ContactConfig(**kw["contact"]),
    )
    pcfg = tcfg.SimConfig(
        capacity=tcfg.CapacityConfig(**kw["capacity"]),
        numerics=tcfg.NumericsConfig(**kw["numerics"]),
        domain=tcfg.DomainConfig(**kw["domain"]),
        processes=tcfg.ProcessConfig(**kw["processes"]),
        contact=tcfg.ContactConfig(**kw["contact"]),
    )
    return jcfg, pcfg


def to_numpy(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def run_lockstep(jcfg, pcfg, jstate, jforcing, n_steps):
    """Run both steps; return the largest position and velocity deltas and
    the per-step wall-contact counts.  Collision counts must agree every
    step, and collisions must happen."""
    jstep = make_step_fn(jcfg, jforcing, MODULUS)
    pstep = torch_step_fn(pcfg, forcing_from_numpy(to_numpy(jforcing),
                                                   device="cpu"),
                          MODULUS, device="cpu")
    pstate = state_from_numpy(to_numpy(jstate), device="cpu",
                              dtype=torch.float64)
    dpos = dvel = 0.0
    walls, collisions = [], 0
    for i in range(n_steps):
        jstate, jaux = jstep(jstate, jnp.asarray(i))
        pstate, paux = pstep(pstate, i)
        a, b = to_numpy(jstate), state_to_numpy(pstate)
        dpos = max(dpos, np.max(np.abs(a["x"] - b["x"])),
                   np.max(np.abs(a["y"] - b["y"])))
        dvel = max(dvel, np.max(np.abs(a["u"] - b["u"])),
                   np.max(np.abs(a["v"] - b["v"])),
                   np.max(np.abs(a["ksi"] - b["ksi"])))
        assert int(jaux.n_collisions) == int(paux.n_collisions), f"step {i}"
        np.testing.assert_array_equal(np.asarray(jaux.nbr_idx),
                                      paux.nbr_idx.numpy())
        np.testing.assert_array_equal(a["alive"], b["alive"])
        walls.append(int(paux.boundary_contact.sum()))
        collisions += int(paux.n_collisions)
    assert collisions > 0
    return dpos, dvel, walls


def test_periodic_lattice_matches_jax():
    polys, vel, lx = lattice(8)
    jcfg, pcfg = configs(64, lx, periodic=True)
    jstate = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    jforcing = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1,
                               dtype=jnp.float64)
    dpos, dvel, _ = run_lockstep(jcfg, pcfg, jstate, jforcing, 50)
    assert dpos < 1e-6
    assert dvel < 1e-9


def test_walled_gyre_matches_jax():
    # Same lattice between walls, under the 4-gyre ocean with wind: the
    # edge floes press on the walls from the first steps, so the wall
    # (difference) clip and the ocean forcing refresh both run.
    polys, vel, lx = lattice(6, seed=1)
    jcfg, pcfg = configs(40, lx, periodic=False)
    jstate = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    jforcing = gyre_ocean(lx=4 * lx, dx=lx / 8, transport=2e3, wind_u=8.0,
                          wind_v=-4.0, dtype=jnp.float64)
    dpos, dvel, walls = run_lockstep(jcfg, pcfg, jstate, jforcing, 50)
    assert sum(walls[:20]) > 0, "no floe touched a wall"
    assert dpos < 1e-6
    assert dvel < 1e-9


def test_make_step_fn_rejects_unported_options():
    _, pcfg = configs(8, 1e4, periodic=True)
    fc = forcing_from_numpy(to_numpy(uniform_forcing(dtype=jnp.float64)),
                            device="cpu")
    for bad in (
        pcfg.replace(contact=tcfg.ContactConfig(per_region=True)),
        pcfg.replace(contact=tcfg.ContactConfig(per_region=False,
                                                pair_pool=True)),
        pcfg.replace(numerics=tcfg.NumericsConfig(contact_impl="xla")),
        pcfg.replace(numerics=tcfg.NumericsConfig(broadphase="cells")),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            torch_step_fn(bad, fc, MODULUS, device="cpu")


def test_entry_points_need_cuda_by_default(monkeypatch):
    from subzero_tpu_torch.state import state_from_polygons as tsfp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = configs(8, 1e4, periodic=True)
    fc = forcing_from_numpy(to_numpy(uniform_forcing(dtype=jnp.float64)),
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_step_fn(pcfg, fc, MODULUS)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsfp([np.array([[0, 0], [1, 0], [1, 1.0]])], 1.0, pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        forcing_from_numpy(to_numpy(uniform_forcing()))
