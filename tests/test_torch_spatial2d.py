"""The port's 2-D tile decomposition (``make_spatial_step_2d``) on 4 gloo
ranks (2x2 tiles) against JAX's on a 2x2 mesh of CPU devices, float64:
``tests/test_spatial2d.py``'s cases (the lattice run walled and periodic,
the corner-ghost contact, the two-phase diagonal migration, the overlapped
halo against the serialized exchange) and ``load_imbalance``.  The ranks
are subprocesses of this file, launched once from a module fixture; live
rows within 1e-6 m and 1e-9 m/s, and per step the same collision count,
overflow flags and demands (test_torch_spatial.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

if __name__ != "__main__":
    from test_torch_spatial import (
        SQ, assert_matches, f64_forcing, live_rows, run_both, scenario,
    )

MESH = (2, 2)


def _cfg(periodic, cap=64, **capacity):
    from subzero_tpu.config import (
        CapacityConfig, DomainConfig, NumericsConfig, PhysicsConfig,
        ProcessConfig, SimConfig,
    )

    return SimConfig(
        physics=PhysicsConfig(ocean_coupling=False),
        processes=ProcessConfig(periodic=periodic, corners=False),
        numerics=NumericsConfig(dtype="float64"),
        domain=DomainConfig(lx=1e5, ly=1e5),
        capacity=CapacityConfig(**{
            **dict(max_floes=cap, max_verts=8, max_neighbors=8,
                   max_ghosts=16, n_mc_points=32, stress_window=8),
            **capacity}),
        min_floe_size=1.0,
    )


def _lattice(n_side):
    """The jittered square lattice of test_spatial2d.py's ``_setup``."""
    lx = 1e5
    rng = np.random.default_rng(3)
    pitch = 2 * lx / n_side
    polys = []
    for k in range(n_side * n_side):
        i, j = divmod(k, n_side)
        c = np.array([-lx + (j + 0.5) * pitch, -lx + (i + 0.5) * pitch])
        polys.append(SQ * pitch * 0.49 + c
                     + rng.uniform(-0.02, 0.02, (4, 2)) * pitch)
    vel = rng.uniform(-0.3, 0.3, (len(polys), 2))
    return polys, vel


def scenarios() -> dict:
    forcing = f64_forcing(lx=4e5, dx=1e4)
    out = {}
    polys, vel = _lattice(6)
    out["lattice_walled"] = scenario(_cfg(False), polys, 10, vel,
                                     forcing=forcing, modulus=9e7)
    # periodic: the 8x8 lattice, overlapped halo (the default) and
    # serialized exchange; the first is also the periodic lattice run
    polys, vel = _lattice(8)
    base = _cfg(True, cap=128)
    for ov in (True, False):
        c = base.replace(numerics=dataclasses.replace(base.numerics,
                                                      overlap_halo=ov))
        out[f"overlap_{ov}"] = scenario(c, polys, 10, vel, forcing=forcing,
                                        modulus=9e7)
    small = _cfg(False, cap=32, max_neighbors=4, max_ghosts=8,
                 n_mc_points=16, stress_window=4)
    # two floes overlapping across the tiles' common corner
    out["corner"] = scenario(
        small, [SQ * 4e3 + [-3.9e3, -3.9e3], SQ * 4e3 + [3.9e3, 3.9e3]], 1,
        np.array([[0.1, 0.1], [-0.1, -0.1]]), forcing=forcing, modulus=9e7)
    # a floe just inside tile (0, 0) moving across the corner (alone, so
    # the collision switch of test_spatial2d.py changes nothing)
    out["diagonal"] = scenario(
        small, [SQ * 2e3 + [-80.0, -80.0]], 3, np.array([[20.0, 20.0]]),
        forcing=forcing, modulus=9e7)
    for sc in out.values():
        sc["kind"], sc["mesh"] = "2d", MESH
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    port, jax, scs = run_both(__file__, {4: scenarios()},
                              tmp_path_factory.mktemp("spatial2d"))[4]
    return port, jax, scs


@pytest.mark.parametrize("name", ["lattice_walled", "overlap_True"])
def test_matches_jax_2d(runs, name):
    port, jax, _ = runs
    assert_matches(port[name], jax[name], name)
    assert not port[name]["scalars"][:, 1].any()     # no overflow
    assert port[name]["scalars"][:, 0].max() > 0     # contacts happened


def test_corner_ghost_contact(runs):
    port, jax, _ = runs
    assert_matches(port["corner"], jax["corner"], "corner")
    assert port["corner"]["scalars"][0, 0] >= 1, "corner contact missed"
    cf = port["corner"]["collision_force"]
    assert np.abs(cf).max() > 0
    np.testing.assert_allclose(cf, jax["corner"]["collision_force"],
                               rtol=1e-9, atol=1e-6)


def test_two_phase_migration_diagonal(runs):
    port, jax, scs = runs
    assert_matches(port["diagonal"], jax["diagonal"], "diagonal")
    st = port["diagonal"]["state"]
    alive = st["alive"]
    assert alive.sum() == 1
    slot = int(np.nonzero(alive)[0][0])
    assert st["x"][slot] > 0 and st["y"][slot] > 0
    n_loc = scs["diagonal"]["_jax"][0].capacity.max_floes // 4
    assert slot // n_loc == 3, f"slot {slot} not in tile (1, 1)'s block"


def test_overlap_matches_serialized_exchange_2d(runs):
    port, jax, _ = runs
    for ov in (False, True):
        assert_matches(port[f"overlap_{ov}"], jax[f"overlap_{ov}"],
                       f"overlap_halo={ov}")
    a, b = port["overlap_False"], port["overlap_True"]
    np.testing.assert_allclose(live_rows(a["state"]), live_rows(b["state"]),
                               rtol=1e-9, atol=1e-9)
    assert a["scalars"][-1, 0] == b["scalars"][-1, 0]


@pytest.mark.parametrize("tiles", [(4, 2), (2, 2)])
def test_load_imbalance(tiles):
    import jax.numpy as jnp

    from subzero_tpu.parallel import load_imbalance as j_imbalance
    from subzero_tpu.state import state_from_polygons

    from subzero_tpu_torch.convert import state_from_numpy
    from subzero_tpu_torch.parallel import load_imbalance
    from test_torch_init import jax_numpy, port_cfg

    cfg = _cfg(False)
    polys, vel = _lattice(6)
    st = state_from_polygons(polys, 0.5, cfg, velocities=vel)
    clustered = st.replace(x=jnp.abs(st.x) * 0 - 9e4, y=st.y * 0 - 9e4)
    for s, want in ((st, None), (clustered, float(np.prod(tiles)))):
        got = load_imbalance(state_from_numpy(jax_numpy(s), device="cpu"),
                             port_cfg(cfg), *tiles)
        assert got == j_imbalance(s, cfg, *tiles)
        if want is None:
            assert got < 1.5            # the lattice is near balanced
        else:
            assert got == want          # everything in one corner tile


if __name__ == "__main__":
    import torch_ranks

    torch_ranks.rank_main()
