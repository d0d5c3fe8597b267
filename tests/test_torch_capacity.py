"""The driver's capacity paths of the port against the JAX driver's, float64
on the CPU: ``tests/test_capacity.py`` and ``tests/test_verts_auto.py``
case by case.

* ``capacity_guard``: the same births kept, the same mass dissolved.
* ``Simulation._grow_floes`` (also under a mesh: slot multiple
  ``lcm(8, S)``), ``_grow_verts`` and ``_fit_verts``: the same
  ``cfg.capacity`` and identical state arrays after the growth; the port's
  run then continues.
* The rung's shrink window in ``_maybe_shrink_pools``: the same rung and
  ``cfg.capacity`` after every chunk boundary of a run, and after a
  boundary birth.
* Resumes: a snapshot loads in both packages at the saved rung and at a
  larger floe capacity alike; a resume continues bit for bit with its
  lifecycle RNG; an export across a resume closes the ledger like JAX's
  straight run.
* Birth truncation at ``max_verts``, not at the rung.

Both packages start from the same numpy state of the out-of-box recipe
(``out_of_box_sim``) in float64.  JAX runs only where a case is about
running, so the file stays short.
"""

from __future__ import annotations

import dataclasses
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.sim as jsim
from subzero_tpu.config import CapacityConfig, NumericsConfig, SimConfig
from subzero_tpu.forcing import gyre_ocean, uniform_forcing
from subzero_tpu.init import initial_state
from subzero_tpu.processes import host as jhost
from subzero_tpu.processes.lifecycle import capacity_guard as j_guard
from subzero_tpu.state import state_from_polygons

import subzero_tpu_torch.sim as tsim
from subzero_tpu_torch.chunk_io import Summary, read_summary
from subzero_tpu_torch.convert import (
    forcing_from_numpy, state_from_numpy, state_to_numpy,
)
from subzero_tpu_torch.processes import host as thost
from subzero_tpu_torch.processes.lifecycle import capacity_guard as t_guard
from test_torch_init import jax_numpy, port_cfg

torch.set_num_threads(1)


def oob_cfg(n_floes):
    return SimConfig(capacity=CapacityConfig(max_floes=max(4 * n_floes, 16)),
                     numerics=NumericsConfig(dtype="float64"))


def oob_pair(n_floes=6, seed=0):
    """``out_of_box_sim(seed, n_floes)`` in float64 in both packages."""
    cfg = oob_cfg(n_floes)
    st, modulus = initial_state(cfg, 1.0, n_floes, 0.25, seed=seed)
    fc = gyre_ocean(dtype=jnp.float64)
    js = jsim.Simulation(cfg=cfg, state=st, forcing=fc, modulus=modulus)
    ps = tsim.Simulation(
        cfg=port_cfg(cfg), state=state_from_numpy(jax_numpy(st),
                                                  device="cpu"),
        forcing=forcing_from_numpy(jax_numpy(fc), device="cpu"),
        modulus=modulus)
    return js, ps


def assert_same(js, ps, where=""):
    """The same capacity config and identical state arrays."""
    assert dataclasses.asdict(js.cfg.capacity) == dataclasses.asdict(
        ps.cfg.capacity), where
    a, b = jax_numpy(js.state), state_to_numpy(ps.state)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
            f"{where}: {k}"


def test_ladders_match_jax():
    for cap in (16, 64, 128):
        for need in range(1, 200):
            assert tsim._ladder_v(need, cap) == jsim._ladder_v(need, cap)
    for need in range(1, 500):
        assert tsim._ladder_k(need) == jsim._ladder_k(need)
        assert tsim._pool_slots(need) == jsim._pool_slots(need)
    assert tsim._ladder_v(80, 64) == 64 and tsim._ladder_v(70, 128) == 80


def _sq(cx, cy, w):
    return np.array([[cx - w / 2, cy - w / 2], [cx + w / 2, cy - w / 2],
                     [cx + w / 2, cy + w / 2], [cx - w / 2, cy + w / 2]])


GUARD_CASES = {
    # 2 free slots, 4 births: the two largest survive
    "trims_smallest": (8, [True] * 6 + [False] * 2, set(),
                       (1e3, 3e3, 2e3, 4e3)),
    # a killed slot is free for a birth
    "kill_slots_free": (4, [True] * 4, {1}, (1e3,)),
    "room": (8, [True] * 2 + [False] * 6, set(), (1e3,)),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_capacity_guard_matches_jax(case):
    n, alive, kills, widths = GUARD_CASES[case]
    out = []
    for host, guard, mk in ((jhost, j_guard, lambda c: c),
                            (thost, t_guard, port_cfg)):
        cfg = SimConfig(numerics=NumericsConfig(dtype="float64"),
                        capacity=CapacityConfig(max_floes=n, max_verts=16))
        edit = host.StateEdit(kills=set(kills), new_floes=[
            host.NewFloe(poly=_sq(0, 0, w), h=1.0) for w in widths])
        lost = guard(edit, np.array(alive), mk(cfg), step_idx=0)
        out.append((lost, [f.poly.tolist() for f in edit.new_floes],
                    edit.dissolve_mass))
    assert out[0] == out[1]
    lost, kept, dissolved = out[1]
    if case == "trims_smallest":
        rho = SimConfig().physics.rho_ice
        assert np.isclose(lost, rho * (1e3 ** 2 + 2e3 ** 2))
        assert sorted(np.ptp(np.array(p)[:, 0]) for p in kept) == [3e3, 4e3]
    else:
        assert lost == 0.0 and len(kept) == len(widths) and not dissolved


@pytest.mark.parametrize("shards", [None, 3])
def test_grow_floes_matches_jax(shards):
    """``_grow_floes`` pads every array with dead slots to a multiple of 8
    (of lcm(8, S) under an S-device mesh: 24 for 3 shards)."""
    js, ps = oob_pair()
    js._fit_verts()
    ps._fit_verts()
    if shards:
        import jax
        from jax.sharding import Mesh

        # the slot multiple reads the mesh's size only: attached without
        # resharding, on both sides
        js.mesh = Mesh(np.array(jax.devices()[:shards]), ("shards",))
        ps.mesh = types.SimpleNamespace(size=shards)
    n0 = ps.state.n
    alive0 = int(ps.state.alive.sum())
    js.state = js._grow_floes(js.state, n0 + 100)
    ps.state = ps._grow_floes(ps.state, n0 + 100)
    assert ps.state.n >= n0 + 100
    assert ps.state.n % math.lcm(8, shards or 1) == 0
    assert ps.cfg.capacity.max_floes == ps.state.n
    assert_same(js, ps, f"grown, shards={shards}")
    if shards is None:
        ps.run(5)                    # rebuilds via the built-cfg check
        assert int(ps.state.alive.sum()) == alive0


def test_fit_and_grow_verts_match_jax():
    """The initial rung fit and a growth for a wide birth: same rung,
    config and arrays (the widened columns are vertex-0 pads)."""
    js, ps = oob_pair()
    v_cap = ps.state.v_cap
    js._fit_verts()
    ps._fit_verts()
    assert ps.state.v_cap < v_cap                 # the fit fired
    assert ps.cfg.capacity.verts_now == ps.state.v_cap
    assert_same(js, ps, "fitted")
    v0 = ps.state.v_cap
    vb0 = ps.state.verts_body.numpy().copy()
    js.state = js._grow_verts(js.state, v0 + 5)
    ps.state = ps._grow_verts(ps.state, v0 + 5)
    assert ps.state.v_cap == tsim._ladder_v(v0 + 5, 64) > v0
    assert_same(js, ps, "grown")
    vb = ps.state.verts_body.numpy()
    assert np.array_equal(vb[:, :v0], vb0)
    assert np.array_equal(vb[:, v0:], np.broadcast_to(
        vb0[:, :1], (vb0.shape[0], vb.shape[1] - v0, 2)))
    ps.run(5)
    assert np.isfinite(ps.total_mass())


def test_fitted_rung_physics_matches_static():
    """The port's fitted rung against its static max_verts build over one
    10-step chunk (test_verts_auto.py runs 20; padding columns are exact
    zeros, the narrower reductions may regroup the real terms)."""
    runs = []
    for auto in (True, False):
        _, ps = oob_pair(n_floes=8)
        if not auto:
            ps.cfg = ps.cfg.replace(capacity=dataclasses.replace(
                ps.cfg.capacity, verts_auto=False))
        ps.run(10)
        runs.append(ps)
    a, b = runs
    assert a.state.v_cap < b.state.v_cap
    for k, tol in (("x", 0.5), ("y", 0.5), ("u", 5e-3)):
        assert np.allclose(getattr(a.state, k).numpy(),
                           getattr(b.state, k).numpy(), atol=tol)
    assert torch.equal(a.state.nv, b.state.nv)
    assert np.isclose(a.total_mass(), b.total_mass(), rtol=1e-6)


def test_rung_shrink_window_matches_jax():
    """A spike to rung 48, then the two-chunk shrink window (whose first
    entry predates the spike): the same rung and config as JAX's after
    every chunk boundary, back at the fit."""
    js, ps = oob_pair()
    for sim in (js, ps):
        sim._SHRINK_WINDOW = 2
    js.run(5)
    ps.run(5)
    v_fit = ps.state.v_cap
    js.state = js._grow_verts(js.state, 40)
    ps.state = ps._grow_verts(ps.state, 40)
    assert ps.state.v_cap == 48
    rungs = []
    while ps.step_idx < 25:
        js.run(10 - ps.step_idx % 10)
        ps.run(10 - ps.step_idx % 10)
        assert dataclasses.asdict(js.cfg.capacity) == dataclasses.asdict(
            ps.cfg.capacity), ps.step_idx
        assert js.state.v_cap == ps.state.v_cap
        rungs.append(ps.state.v_cap)
    assert rungs[-1] == v_fit < 48


def test_shrink_floor_covers_boundary_births_like_jax():
    js, ps = oob_pair()
    for sim in (js, ps):
        sim._fit_verts()
        sim.state = sim._grow_verts(sim.state, 40)        # rung 48
        sim._SHRINK_WINDOW = 1
    s = np.zeros(13)
    s[12] = 6                                   # the summary says nv <= 6
    # the port's summary by name
    ps_s = read_summary(np.zeros(len(Summary._fields) - 1))._replace(
        max_nv=6)
    for birth, want in ((20, 24), (0, 8)):      # a boundary birth of 20
        for sim, summary in ((js, s), (ps, ps_s)):
            sim.lifecycle.last_birth_nv = birth
            sim._maybe_shrink_pools(summary)
            assert sim.lifecycle.last_birth_nv == 0
        assert ps.state.v_cap == js.state.v_cap == want
        assert_same(js, ps, f"birth {birth}")


def test_birth_truncation_at_max_verts_like_jax():
    """Without the driver's hook a birth is capped at the rung; with it the
    rung grows first and the birth keeps every vertex up to max_verts."""
    cfg = SimConfig(
        numerics=NumericsConfig(dtype="float64"),
        capacity=CapacityConfig(max_floes=8, max_verts=16, active_verts=8,
                                n_mc_points=64, stress_window=8))
    sq = 2e3 * np.array([[-1., -1.], [1., -1.], [1., 1.], [-1., 1.]])
    th = np.linspace(0, 2 * np.pi, 21)[:-1]
    circle = 3e3 * np.stack([np.cos(th), np.sin(th)], axis=1) + [1e4, 0]
    jst = state_from_polygons([sq], 1.0, cfg)
    pst = state_from_numpy(jax_numpy(jst), device="cpu")
    assert pst.v_cap == 8
    fc = uniform_forcing(lx=4e5, dtype=jnp.float64)
    js = jsim.Simulation(cfg=cfg, state=jst, forcing=fc, modulus=1e8)
    ps = tsim.Simulation(cfg=port_cfg(cfg), state=pst, forcing=
                         forcing_from_numpy(jax_numpy(fc), device="cpu"),
                         modulus=1e8)
    nv = {}
    for host, sim, st in ((jhost, js, jst), (thost, ps, pst)):
        lib = host.apply_edits(st, host.StateEdit(new_floes=[
            host.NewFloe(poly=circle, h=1.0)]), sim.cfg, seed=0)
        grown = sim.lifecycle.grow_verts_fn(st, min(len(circle), 16))
        drv = host.apply_edits(grown, host.StateEdit(new_floes=[
            host.NewFloe(poly=circle, h=1.0)]), sim.cfg, seed=0)
        nv[host is thost] = (lib, drv)
    (jl, jd), (pl, pd) = nv[False], nv[True]
    assert int(pl.nv[1]) == 8 and int(pd.nv[1]) == 16
    assert pd.v_cap == 16
    for a, b in ((jl, pl), (jd, pd)):
        ja, pb = jax_numpy(a), state_to_numpy(b)
        for k in ja:
            np.testing.assert_allclose(pb[k], ja[k], rtol=1e-12,
                                       atol=1e-9, err_msg=k)


@pytest.mark.parametrize("bigger", [False, True])
def test_resume_adopts_saved_rung_and_capacity(tmp_path, bigger):
    """A port snapshot at the fitted rung loads in both packages under a
    fresh default config (or at twice the floe capacity): the saved rung
    and the max_verts cap are adopted, extra slots come up dead, and the
    port's resumed run continues."""
    js, ps = oob_pair()
    ps.run(5)
    v0 = ps.state.v_cap
    assert v0 < 64
    ps.save(tmp_path / "snap")
    jcfg = js.cfg
    if bigger:
        jcfg = jcfg.replace(capacity=dataclasses.replace(
            jcfg.capacity, max_floes=2 * ps.state.n))
    j2 = jsim.Simulation.load(tmp_path / "snap", jcfg, js.forcing)
    p2 = tsim.Simulation.load(tmp_path / "snap", port_cfg(jcfg),
                              ps.forcing, device="cpu")
    assert_same(j2, p2, "loaded")
    assert p2.state.v_cap == v0 and p2.cfg.capacity.max_verts == 64
    assert p2.state.n == (2 if bigger else 1) * ps.state.n
    assert int(p2.state.alive.sum()) == int(ps.state.alive.sum())
    m0 = p2.total_mass()
    p2.run(5)
    assert abs(p2.total_mass() / m0 - 1) < 0.5


def test_resume_is_bit_identical_with_its_rng(tmp_path):
    """The straight run against save at 20 + load + 10 more, with corner
    grinding drawing from the lifecycle RNG: bit-identical in the port,
    and JAX loads the same run state (RNG, ledger, step)."""
    _, straight = oob_pair(n_floes=10)
    straight.run(30)
    _, first = oob_pair(n_floes=10)
    first.run(20)
    rng0 = np.random.default_rng(straight.seed + 1).bit_generator.state
    assert first.lifecycle.rng.bit_generator.state != rng0
    first.save(tmp_path / "snap")
    j2 = jsim.Simulation.load(tmp_path / "snap", oob_cfg(10),
                              gyre_ocean(dtype=jnp.float64))
    resumed = tsim.Simulation.load(tmp_path / "snap", first.cfg,
                                   first.forcing, device="cpu")
    assert (j2.lifecycle.rng.bit_generator.state
            == resumed.lifecycle.rng.bit_generator.state
            == first.lifecycle.rng.bit_generator.state)
    assert j2.step_idx == resumed.step_idx == 20
    assert j2.lifecycle.exported_mass == resumed.lifecycle.exported_mass
    resumed.run(10)
    a, b = state_to_numpy(straight.state), state_to_numpy(resumed.state)
    for k in a:
        if k == "verts_body":       # the rung is throughput state
            v = min(a[k].shape[1], b[k].shape[1])
            a[k], b[k] = a[k][:, :v], b[k][:, :v]
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(straight.dissolved, resumed.dissolved)


def test_export_across_a_resume_matches_jax(tmp_path):
    """A floe drifting across the kill line after a checkpoint: the port's
    resumed run exports it like JAX's straight run (the same floes, the
    same exported mass) and the ledger closes."""
    cfg = SimConfig(
        numerics=NumericsConfig(dtype="float64", dt=10.0),
        capacity=CapacityConfig(max_floes=8, max_verts=16, n_mc_points=64,
                                stress_window=16))
    cfg = cfg.replace(processes=dataclasses.replace(
        cfg.processes, kill_below_ymin=True, corners=False,
        fractures=False, n_dt_out=40))
    sq = 2000.0 * np.array([[-1., -1.], [1., -1.], [1., 1.], [-1., 1.]])
    polys = [sq + [0.0, -cfg.domain.ly + 2700.0], sq + [0.0, 5e4]]
    fc = uniform_forcing(lx=4e5, va=-40.0, dtype=jnp.float64)
    st = state_from_polygons(polys, 1.0, cfg)
    st = st.replace(v=jnp.where(jnp.arange(st.n) == 0, -1.0, 0.0))
    js = jsim.Simulation(cfg=cfg, state=st, forcing=fc, modulus=1e8, seed=7)
    m0 = js.total_mass()
    js.run(140)
    assert js.lifecycle.exported_mass > 0.0

    ps = tsim.Simulation(cfg=port_cfg(cfg), state=state_from_numpy(
        jax_numpy(st), device="cpu"), forcing=forcing_from_numpy(
        jax_numpy(fc), device="cpu"), modulus=1e8, seed=7)
    ps.run(70)
    assert ps.lifecycle.exported_mass == 0.0
    ps.save(tmp_path / "snap")
    p2 = tsim.Simulation.load(tmp_path / "snap", ps.cfg, ps.forcing,
                              device="cpu")
    p2.run(70)
    a, b = jax_numpy(js.state), state_to_numpy(p2.state)
    assert np.array_equal(a["alive"], b["alive"])
    assert np.isclose(p2.lifecycle.exported_mass,
                      js.lifecycle.exported_mass, rtol=1e-12)
    ledger = (p2.total_mass() + float(np.sum(p2.dissolved))
              + p2.lifecycle.exported_mass)
    assert abs(ledger / m0 - 1) < 1e-9
