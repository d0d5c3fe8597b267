"""The PyTorch port's physics step against the JAX step, float64 on the CPU.

Both packages start from the same numpy state and forcing (carried across
with ``subzero_tpu_torch.convert``) and run in lockstep: quad lattices in
aggregate-contact mode, with the dense and the cell-list broad phase;
test_golden.py's two per-region concave scenarios; and a lattice of
interlocking concave stars under the default ContactConfig (per-region
contacts), periodic and walled.  Tolerances: positions within 1e-6 m and
velocities within 1e-9 m/s — the convex envelope of test_golden.py — and the
same collision count, neighbour table and pool counters every step.
The walled lattice also runs under ``contact_impl="xla"`` (the
segment-midpoint clip), aggregate and per-region.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.config as jconfig
from subzero_tpu.config import SimConfig
from subzero_tpu.dynamics.step import make_step_fn
from subzero_tpu.forcing import gyre_ocean, uniform_forcing
from subzero_tpu.state import state_from_polygons

import subzero_tpu_torch.config as tcfg
from subzero_tpu_torch.convert import (
    forcing_from_numpy, state_from_numpy, state_to_numpy,
)
from subzero_tpu_torch.dynamics.step import make_step_fn as torch_step_fn
from test_golden import _complex, _modulus

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


def star_lattice(side: int, seed: int = 0, pitch: float = 4000.0,
                 radius: float = 0.45):
    """A side x side lattice of interlocking concave stars, bench.py's
    concave workload (``build_concave``) at small size: 5-8 arms (10-16
    vertices), arm tips at ``radius * pitch * 1.45`` from the centre, random
    velocities.  Nearly every contact crosses four or more times."""
    lx = side * pitch / 2
    rng = np.random.default_rng(seed)
    polys = []
    for k in range(side * side):
        i, j = divmod(k, side)
        cx, cy = -lx + (j + 0.5) * pitch, -lx + (i + 0.5) * pitch
        nv = 2 * int(rng.integers(5, 9))
        th = (np.linspace(0, 2 * np.pi, nv + 1)[:-1]
              + rng.uniform(0, np.pi / nv))
        r = radius * pitch * (
            1 + 0.45 * np.where(np.arange(nv) % 2 == 0, 1.0, -1.0)
            + rng.uniform(-0.1, 0.1, nv))
        polys.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)],
                              axis=1))
    vel = rng.uniform(-0.1, 0.1, size=(side * side, 2))
    return polys, vel, lx


_SECTIONS = {"capacity": "CapacityConfig", "numerics": "NumericsConfig",
             "domain": "DomainConfig", "processes": "ProcessConfig",
             "contact": "ContactConfig", "physics": "PhysicsConfig"}


def configs(n, lx, periodic, contact=None, **sections):
    """The same configuration in both packages (the port keeps its own
    copy of config.py): V=16, K=8, float64, aggregate contacts unless
    ``contact`` gives ContactConfig fields; ``lx=None`` keeps the default
    domain.  ``sections``: more fields per section, e.g.
    ``numerics=dict(broadphase="cells")``."""
    kw = dict(
        capacity=dict(max_floes=n, max_verts=16, max_neighbors=8,
                      n_mc_points=32, stress_window=16),
        numerics=dict(dtype="float64"),
        domain={} if lx is None else dict(lx=lx, ly=lx),
        processes=dict(periodic=periodic),
        contact=dict(per_region=False) if contact is None else contact,
        physics={},
    )
    for name, fields in sections.items():
        kw[name] = {**kw[name], **fields}
    jcfg = SimConfig(**{name: getattr(jconfig, cls)(**kw[name])
                        for name, cls in _SECTIONS.items()})
    pcfg = tcfg.SimConfig(**{name: getattr(tcfg, cls)(**kw[name])
                             for name, cls in _SECTIONS.items()})
    return jcfg, pcfg


def to_numpy(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def run_lockstep(jcfg, pcfg, jstate, jforcing, n_steps, modulus=MODULUS):
    """Run both steps; return the largest position and velocity deltas, the
    per-step wall-contact counts and the per-step region-pool demand.
    Collision counts, the neighbour table, the alive mask and every pool
    counter and overflow flag must agree every step, and collisions must
    happen."""
    jstep = make_step_fn(jcfg, jforcing, modulus)
    pstep = torch_step_fn(pcfg, forcing_from_numpy(to_numpy(jforcing),
                                                   device="cpu"),
                          modulus, device="cpu")
    pstate = state_from_numpy(to_numpy(jstate), device="cpu",
                              dtype=torch.float64)
    dpos = dvel = 0.0
    walls, needs, collisions = [], [], 0
    for i in range(n_steps):
        jstate, jaux = jstep(jstate, jnp.asarray(i))
        pstate, paux = pstep(pstate, i)
        a, b = to_numpy(jstate), state_to_numpy(pstate)
        dpos = max(dpos, np.max(np.abs(a["x"] - b["x"])),
                   np.max(np.abs(a["y"] - b["y"])))
        dvel = max(dvel, np.max(np.abs(a["u"] - b["u"])),
                   np.max(np.abs(a["v"] - b["v"])),
                   np.max(np.abs(a["ksi"] - b["ksi"])))
        for f in ("n_collisions", "region_pool_need", "region_overflow",
                  "pair_pool_need", "pair_pool_overflow", "nbr_overflow",
                  "nbr_demand"):
            assert int(getattr(jaux, f)) == int(getattr(paux, f)), \
                f"step {i}: {f}"
        np.testing.assert_array_equal(np.asarray(jaux.nbr_idx),
                                      paux.nbr_idx.numpy())
        np.testing.assert_array_equal(a["alive"], b["alive"])
        walls.append(int(paux.boundary_contact.sum()))
        needs.append(int(paux.region_pool_need))
        collisions += int(paux.n_collisions)
    assert collisions > 0
    return dpos, dvel, walls, needs


def test_periodic_lattice_matches_jax():
    polys, vel, lx = lattice(8)
    jcfg, pcfg = configs(64, lx, periodic=True)
    jstate = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    jforcing = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1,
                               dtype=jnp.float64)
    dpos, dvel, _, _ = run_lockstep(jcfg, pcfg, jstate, jforcing, 50)
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
    dpos, dvel, walls, _ = run_lockstep(jcfg, pcfg, jstate, jforcing, 50)
    assert sum(walls[:20]) > 0, "no floe touched a wall"
    assert dpos < 1e-6
    assert dvel < 1e-9


# test_golden.py's per-region scenarios 4 (two concave floes) and 5 (a
# concave floe against the +x wall), moved so that contact begins within
# the first 10 steps.
# Scenario 4: complex2 sits 3,170 m further +x and 300 m further +y than
# in test_golden.py; the two close at 2.1 m per step, touch at +3,190 m and
# cross four times from +3,200 m, where two lobes meet.  Scenario 5: complex1
# sits 480 m further +x, 151 m into the wall, past the 142 m at which its
# second lobe crosses it too: the wall difference starts as two regions.
GOLDEN = {
    "two_concave_floes": (
        [(5, (0.0, 0.0)), (4, (-1e4 + 1.2e3 + 3170.0, -4e4 + 300.0))],
        [[-0.11, 0.02], [0.1, 0.02]]),
    "concave_floe_hits_wall": ([(5, (7.95e4 + 480.0, 0.0))], [[0.11, 0.02]]),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_per_region_matches_jax(name):
    shapes, vels = GOLDEN[name]
    polys = [_complex(k, t) for k, t in shapes]
    jcfg, pcfg = configs(
        8, None, periodic=False,
        contact=dict(per_region=True, region_cap=16),
        capacity=dict(max_verts=64, n_mc_points=1000, stress_window=1000),
        physics=dict(ocean_coupling=False),
        processes=dict(corners=False))
    modulus = _modulus(polys)
    jstate = state_from_polygons(polys, 0.25, jcfg, seed=0,
                                 velocities=np.asarray(vels))
    jforcing = uniform_forcing(lx=4e5, dx=1e4)
    dpos, dvel, walls, needs = run_lockstep(jcfg, pcfg, jstate, jforcing,
                                            150, modulus=modulus)
    assert dpos < 1e-6
    assert dvel < 1e-9
    assert max(needs) > 0, "the region decomposition never ran"
    assert next(i for i, w in enumerate(needs) if w) < 60


@pytest.mark.parametrize("periodic", [True, False])
def test_star_lattice_matches_jax(periodic):
    # bench.py's concave workload at 64 floes, default ContactConfig: the
    # 128-slot region pool fits the demand; walled, the edge stars' wall
    # differences are decomposed as well
    polys, vel, lx = star_lattice(8)
    jcfg, pcfg = configs(64, lx, periodic=periodic, contact={})
    jstate = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    jforcing = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1,
                               dtype=jnp.float64)
    dpos, dvel, walls, needs = run_lockstep(jcfg, pcfg, jstate, jforcing, 30)
    assert dpos < 1e-6
    assert dvel < 1e-9
    assert min(needs) > 0
    assert periodic or sum(walls) > 0


def test_cells_broadphase_lattice_matches_jax():
    polys, vel, lx = lattice(8)
    jcfg, pcfg = configs(64, lx, periodic=True,
                         numerics=dict(broadphase="cells",
                                       cell_size=1.5 * 4000.0),
                         capacity=dict(max_per_cell=8))
    jstate = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    jforcing = uniform_forcing(lx=4 * lx, dx=lx / 8, uo=0.1,
                               dtype=jnp.float64)
    dpos, dvel, _, _ = run_lockstep(jcfg, pcfg, jstate, jforcing, 30)
    assert dpos < 1e-6
    assert dvel < 1e-9


def test_make_step_fn_rejects_unported_options():
    # contact_impl="xla", the one option the port once rejected, now builds
    # a working step: the segment-midpoint clip (geometry/clip_batched.py)
    # in lockstep with the JAX step on test_walled_gyre_matches_jax's
    # lattice, in aggregate and in per-region mode.
    polys, vel, lx = lattice(6, seed=1)
    jforcing = gyre_ocean(lx=4 * lx, dx=lx / 8, transport=2e3, wind_u=8.0,
                          wind_v=-4.0, dtype=jnp.float64)
    for contact in (None, {}):
        jcfg, pcfg = configs(40, lx, periodic=False, contact=contact,
                             numerics=dict(contact_impl="xla"))
        jstate = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
        dpos, dvel, walls, _ = run_lockstep(jcfg, pcfg, jstate, jforcing, 50)
        assert sum(walls[:20]) > 0, "no floe touched a wall"
        assert dpos < 1e-6
        assert dvel < 1e-9


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
