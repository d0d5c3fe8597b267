"""``Simulation(mesh=...)`` of the port on 4 gloo ranks against the JAX
driver on a mesh of 4 CPU devices, float64, chunk by chunk: each chunk of
the port starts from the JAX run's chunk-start state, config, dissolved
grid and lifecycle run state, and must end it with positions within
1e-6 m, velocities within 1e-9 m/s (floes lighter than the median live
floe: the same bound on momentum) and identical ``alive`` and ``nv``.
Every rank must end every chunk holding the same global state.

* ``test_simulation_2d_mesh`` (tests/test_driver.py): the 8x8 periodic
  quad lattice on 2x2 tiles for 20 steps.
* ``TestMovingWallsOnMesh`` (tests/test_spatial.py): ``uniaxial_sim`` on 4
  x-slabs with the y-walls closing 150 m every 5 steps, 40 steps.
* The out-of-box recipe with corner grinding on 4 x-slabs for 30 steps:
  lifecycle boundaries on a mesh (the gathered aux, the rebalance).

The ranks are subprocesses of this file, launched once from a module
fixture; JAX runs first, in the test process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

if __name__ != "__main__":
    import torch_ranks

TOL_POS = 1e-6       # m
TOL_VEL = 1e-9       # m/s


def _mesh(shape):
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, ("shards",) if len(shape) == 1 else ("sx", "sy"))


def _f64(js):
    """``js``'s state and config in float64."""
    import jax.numpy as jnp

    from test_torch_init import jax_numpy

    cfg = js.cfg.replace(numerics=dataclasses.replace(js.cfg.numerics,
                                                      dtype="float64"))
    st = js.state.replace(**{
        k: jnp.asarray(v, jnp.float64) for k, v in jax_numpy(js.state).items()
        if v.dtype.kind == "f"})
    return cfg, st


def lattice_sim():
    from subzero_tpu.config import (
        CapacityConfig, DomainConfig, NumericsConfig, ProcessConfig,
        SimConfig,
    )
    from subzero_tpu.sim import Simulation
    from subzero_tpu.state import state_from_polygons
    from test_torch_spatial import SQ, f64_forcing

    side, pitch = 8, 4000.0
    lx = side * pitch / 2
    cfg = SimConfig(
        capacity=CapacityConfig(max_floes=128, max_verts=16,
                                max_neighbors=8, n_mc_points=64,
                                stress_window=16, max_ghosts=32),
        numerics=NumericsConfig(dtype="float64"),
        domain=DomainConfig(lx=lx, ly=lx),
        processes=ProcessConfig(periodic=True, corners=False))
    rng = np.random.default_rng(0)
    polys = [0.5 * SQ * pitch * 0.9
             + [-lx + (k % side + 0.5) * pitch, -lx + (k // side + 0.5)
                * pitch] for k in range(side * side)]
    vel = rng.uniform(-2.0, 2.0, size=(side * side, 2))
    st = state_from_polygons(polys, 0.5, cfg, velocities=vel)
    return Simulation(cfg=cfg, state=st,
                      forcing=f64_forcing(lx=4 * lx, dx=lx / 8, uo=0.1),
                      modulus=1.6e8, mesh=_mesh((2, 2))), {}


def uniaxial_sim():
    import subzero_tpu.validation as jval
    from subzero_tpu.sim import Simulation

    js = jval.uniaxial_sim(n_floes=48, seed=1)
    cfg, st = _f64(js)
    wall = (150.0, 5, 8.5e4)      # 150 m every 5 steps down to 85 km
    sim = Simulation(cfg=cfg, state=st, forcing=js.forcing,
                     modulus=js.modulus, seed=1, mesh=_mesh((4,)))
    sim.wall_fn = (lambda i: (1e5, max(1e5 - wall[0] * (i // wall[1]),
                                       wall[2])))
    return sim, {"seed": 1, "wall": wall}


def out_of_box_sim():
    from subzero_tpu.config import CapacityConfig, NumericsConfig, SimConfig
    from subzero_tpu.forcing import gyre_ocean
    from subzero_tpu.init import initial_state
    from subzero_tpu.sim import Simulation

    cfg = SimConfig(capacity=CapacityConfig(max_floes=40),
                    numerics=NumericsConfig(dtype="float64"))
    st, modulus = initial_state(cfg, 1.0, 10, 0.25, seed=0)
    import jax.numpy as jnp

    return Simulation(cfg=cfg, state=st, forcing=gyre_ocean(
        dtype=jnp.float64), modulus=modulus, mesh=_mesh((4,))), {}


def record(js, steps: int) -> tuple[list, list]:
    """Run the JAX driver chunk by chunk; returns each chunk's start run
    state and end state."""
    from test_torch_init import jax_numpy, port_run_state

    chunk = js._pick_chunk()
    starts, ends = [], []
    while js.step_idx < steps:
        n = min(chunk - js.step_idx % chunk, steps - js.step_idx)
        lc = js.lifecycle
        starts.append({
            "step": js.step_idx, "n": n, "state": jax_numpy(js.state),
            "cfg": dataclasses.asdict(js.cfg),
            "dissolved": np.array(js.dissolved),
            "rng": lc.rng.bit_generator.state,
            "lifecycle": {f: getattr(lc, f, 0) for f in
                          ("amax", "exported_mass", "last_birth_nv")},
            "run": port_run_state(js)})
        js.run(n)
        ends.append({"step": js.step_idx, "state": jax_numpy(js.state),
                     "cfg": dataclasses.asdict(js.cfg),
                     "dissolved": np.array(js.dissolved),
                     "wall": getattr(js, "_wall_now", None)})
    return starts, ends


CASES = {"lattice_2d": (lattice_sim, 20), "uniaxial": (uniaxial_sim, 40),
         "out_of_box": (out_of_box_sim, 30)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_init import jax_numpy

    scs, jax_ends = {}, {}
    for name, (build, steps) in CASES.items():
        js, kw = build()
        mesh = tuple(js.mesh.devices.shape)
        starts, jax_ends[name] = record(js, steps)
        scs[name] = {"kind": "sim", "mesh": mesh, "starts": starts,
                     "forcing": jax_numpy(js.forcing),
                     "modulus": js.modulus, "sim_kw": kw}
    port = torch_ranks.Ranks(__file__, 4, scs,
                             tmp_path_factory.mktemp("driver")).result()
    return port, jax_ends


def chunk_deltas(a: dict, b: dict, where: str):
    assert np.array_equal(a["alive"], b["alive"]), where
    assert np.array_equal(a["nv"], b["nv"]), where
    w = np.minimum(1.0, a["mass"] / np.median(a["mass"][a["alive"]]))
    dpos = max(np.max(np.abs(a[k] - b[k])) for k in ("x", "y"))
    dvel = max(np.max(np.abs(a[k] - b[k]) * w) for k in ("u", "v", "ksi"))
    return dpos, dvel


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_driver_matches_jax(runs, name):
    port, jax_ends = runs
    chunks = port[name]["chunks"]
    assert len(chunks) == len(jax_ends[name])
    for p, j in zip(chunks, jax_ends[name]):
        where = f"{name} step {j['step']}"
        assert p["step"] == j["step"], where
        assert p["same_on_all_ranks"], f"{where}: the ranks' states differ"
        assert p["cfg"]["capacity"] == j["cfg"]["capacity"], where
        dpos, dvel = chunk_deltas(p["state"], j["state"], where)
        assert dpos <= TOL_POS and dvel <= TOL_VEL, (where, dpos, dvel)
        np.testing.assert_allclose(p["dissolved"], j["dissolved"],
                                   rtol=1e-9, atol=1e-6, err_msg=where)
    end = chunks[-1]["state"]
    alive = end["alive"]
    assert np.all(np.isfinite(end["x"][alive]))
    if name == "lattice_2d":
        assert int(alive.sum()) == 64


def test_moving_walls_on_mesh(runs):
    port, jax_ends = runs
    chunks = port["uniaxial"]["chunks"]
    walls = [tuple(c["wall"]) for c in chunks]
    assert walls == [tuple(j["wall"]) for j in jax_ends["uniaxial"]]
    assert walls[-1][1] < 1e5                  # the y-walls closed in
    st = chunks[-1]["state"]
    a = st["alive"]
    assert a.sum() > 0
    assert np.max(np.abs(np.concatenate([st["u"][a], st["v"][a]]))) > 0


if __name__ == "__main__":
    import torch_ranks

    torch_ranks.rank_main()
