"""The port's ``Simulation`` driver against the JAX package's, float64 on
the CPU.

* Lockstep on the out-of-box recipe (10 Voronoi floes, gyre ocean,
  collisions + corner grinding) for 300 steps, one 10-step chunk at a time:
  each chunk starts both drivers from JAX's state, config and lifecycle RNG
  and must end with positions within 1e-6 m, velocities within 1e-9 m/s
  (for floes lighter than the median live floe, the same bound on
  momentum: a rounding-level force difference moves a light corner piece
  faster — jitted and eager JAX differ by 2.3e-10 m/s over 10 steps on the
  heavy floes), identical ``alive`` and ``nv``, and the same lifecycle
  edits at the boundary.  Chunk by chunk, because this dense pack amplifies rounding:
  in JAX alone a 1e-8 m nudge to one floe grows to 1.3e-6 m and 4.9e-8 m/s
  by step 300, past the tolerances (ROADMAP §C).  Corner grinding
  subtracts triangles that share edges with the floe, and the native
  boolean then keeps or drops collinear split points on those edges
  depending on the last bits of its inputs (jitted and eager JAX disagree
  there too): a boundary whose vertex lists differ is held to the same
  kills, births and masses and to the same polygons (every vertex within
  1e-6 m of the other contour); such boundaries are counted and must stay
  a minority.
* Pool growth: an overflowing region pool and neighbour table grow to the
  same config as JAX's and the chunk is re-run from its untouched input.
* Checkpoints: a resume is bit-identical on the CPU; a JAX checkpoint
  continues in the port, and a port checkpoint in JAX, matching the
  straight runs.
* Output with AVERAGE and dissolved advection, moving walls, the merge-pair
  pool order, two-way pool shrinking, the profiler hook, and a ``mesh``
  that is not the port's (``Simulation(mesh=...)`` itself is held against
  JAX in test_torch_spatial_driver.py).
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.processes.lifecycle as jlc
import subzero_tpu.validation as jval
from subzero_tpu.config import (
    CapacityConfig, ContactConfig, DomainConfig, NumericsConfig,
    ProcessConfig, SimConfig,
)
from subzero_tpu.forcing import gyre_ocean, uniform_forcing
from subzero_tpu.init import initial_state
from subzero_tpu.sim import Simulation
from subzero_tpu.state import state_from_polygons

import subzero_tpu_torch.processes.lifecycle as tlc
import subzero_tpu_torch.chunk_io as chunk_io
import subzero_tpu_torch.sim as tsim
import subzero_tpu_torch.validation as tval
from subzero_tpu_torch.chunk_io import Summary, read_summary
from subzero_tpu_torch.convert import (
    forcing_from_numpy, state_from_numpy, state_to_numpy,
)
from chip_smoke import compare_edits
from test_torch_init import jax_numpy, port_cfg, port_run_state

torch.set_num_threads(1)


# -- helpers -----------------------------------------------------------------

def out_of_box_pair(seed=0, corners=True, **procs):
    """The out-of-box recipe (``out_of_box_sim``) in float64 in both
    packages, from the same numpy state and forcing."""
    cfg = SimConfig(capacity=CapacityConfig(max_floes=40),
                    numerics=NumericsConfig(dtype="float64"),
                    processes=ProcessConfig(corners=corners, **procs))
    st, modulus = initial_state(cfg, 1.0, 10, 0.25, seed=seed)
    fc = gyre_ocean()
    js = Simulation(cfg=cfg, state=st, forcing=fc, modulus=modulus)
    ps = tsim.Simulation(
        cfg=port_cfg(cfg), state=port_state(st),
        forcing=forcing_from_numpy(jax_numpy(fc), device="cpu",
                                   dtype="float32"),
        modulus=modulus)
    return js, ps


def port_state(jst):
    return state_from_numpy(jax_numpy(jst), device="cpu",
                            dtype=str(np.asarray(jst.x).dtype))


def deltas(js, ps, same_nv=True):
    """(max |d position|, max |d velocity|) after checking alive (and nv)
    are identical.  A floe lighter than the median live floe has its
    velocity delta scaled by its mass share (the same bound on momentum):
    one rounding-level force difference moves a light corner piece as many
    times faster as it is lighter."""
    a, b = jax_numpy(js.state), state_to_numpy(ps.state)
    assert np.array_equal(a["alive"], b["alive"]), js.step_idx
    assert not same_nv or np.array_equal(a["nv"], b["nv"]), js.step_idx
    w = np.minimum(1.0, a["mass"] / np.median(a["mass"][a["alive"]]))
    dpos = max(np.max(np.abs(a[k] - b[k])) for k in ("x", "y"))
    dvel = max(np.max(np.abs(a[k] - b[k]) * w) for k in ("u", "v", "ksi"))
    return float(dpos), float(dvel)


def record_edits(monkeypatch):
    logs = {"jax": [], "port": []}
    for mod, key in ((jlc, "jax"), (tlc, "port")):
        orig = mod.apply_edits

        def rec(state, edit, cfg, seed=0, view=None, _o=orig, _k=key):
            logs[_k].append(edit)
            return _o(state, edit, cfg, seed=seed, view=view)

        monkeypatch.setattr(mod, "apply_edits", rec)
    return logs


def resync(ps, js):
    """Set the port's simulation to the JAX one's state, config, dissolved
    grid, driver run state and lifecycle run state."""
    ps.cfg = port_cfg(js.cfg)
    ps.state = port_state(js.state)
    ps.dissolved = np.array(js.dissolved)
    ps.__post_init__()
    ps._chunk_frozen = True
    for k, v in port_run_state(js).items():
        setattr(ps, k, v)
    for k in ("amax", "exported_mass", "last_birth_nv"):
        setattr(ps.lifecycle, k, getattr(js.lifecycle, k, 0))
    ps.lifecycle.rng.bit_generator.state = js.lifecycle.rng.bit_generator.state


# -- lockstep ----------------------------------------------------------------

def test_out_of_box_lockstep_300_steps(monkeypatch):
    js, ps = out_of_box_pair(seed=0)
    logs = record_edits(monkeypatch)
    worst = [0.0, 0.0]
    verdicts = []
    while js.step_idx < 300:
        resync(ps, js)
        js.run(10)
        ps.run(10)
        assert ps.step_idx == js.step_idx
        assert len(logs["jax"]) == len(logs["port"])
        verdict = "same"
        if len(logs["jax"]) > len(verdicts):
            verdict = compare_edits(logs["jax"][-1], logs["port"][-1],
                                    f"step {js.step_idx}")
            verdicts.append(verdict)
        dpos, dvel = deltas(js, ps, same_nv=verdict == "same")
        worst = [max(worst[0], dpos), max(worst[1], dvel)]
        assert dpos < 1e-6 and dvel < 1e-9, js.step_idx
        np.testing.assert_allclose(ps.dissolved, js.dissolved, rtol=1e-9,
                                   atol=1e-9 * max(js.total_mass(), 1.0))
    n_births = sum(len(e.new_floes) for e in logs["jax"])
    assert len(verdicts) >= 20 and n_births > 0
    assert verdicts.count("same") >= len(verdicts) // 2, verdicts
    assert ps.total_mass() == pytest.approx(js.total_mass(), rel=1e-9)


# -- pool growth and chunk re-runs -------------------------------------------

def star(rng, r_mean, n_arms, c):
    n = 2 * n_arms
    th = np.linspace(0, 2 * np.pi, n + 1)[:-1] + rng.uniform(0, np.pi / n)
    r = r_mean * (1 + 0.45 * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
                  + rng.uniform(-0.1, 0.1, n))
    return np.stack([c[0] + r * np.cos(th), c[1] + r * np.sin(th)], axis=1)


def test_pool_overflow_grows_like_jax_and_reruns_the_chunk(monkeypatch):
    # tests/test_ledger.py's interlocking 9x9 star grid: the per-region
    # demand passes the 128-slot pool floor and the stars have more
    # candidates than K=4 holds
    rng = np.random.default_rng(7)
    polys = [star(rng, 6e3, int(rng.integers(5, 9)),
                  (-3.8e4 + gx * 9.5e3, -3.8e4 + gy * 9.5e3))
             for gy in range(9) for gx in range(9)]
    vel = rng.uniform(-0.2, 0.2, (len(polys), 2))
    cfg = SimConfig(
        capacity=CapacityConfig(max_floes=88, max_verts=16, max_neighbors=4,
                                n_mc_points=32, stress_window=16),
        numerics=NumericsConfig(dtype="float64"),
        domain=DomainConfig(lx=5e4, ly=5e4),
        processes=ProcessConfig(corners=False, periodic=True, n_simplify=2,
                                n_dt_out=2),
        contact=ContactConfig(region_pair_frac=1e-6))
    st = state_from_polygons(polys, 0.5, cfg, velocities=vel)
    fc = uniform_forcing(lx=2e5, dx=1e4, uo=0.1)
    js = Simulation(cfg=cfg, state=st, forcing=fc, modulus=9e7)
    ps = tsim.Simulation(cfg=port_cfg(cfg), state=port_state(st),
                         forcing=forcing_from_numpy(jax_numpy(fc),
                                                    device="cpu",
                                                    dtype="float32"),
                         modulus=9e7)
    inputs = []
    orig = tsim.Simulation._run_chunk

    def counted(self, state, *a):
        inputs.append(state_to_numpy(state))
        return orig(self, state, *a)

    monkeypatch.setattr(tsim.Simulation, "_run_chunk", counted)
    st0 = state_to_numpy(ps.state)
    js.run(2)
    ps.run(2)
    assert dataclasses.asdict(ps.cfg) == dataclasses.asdict(js.cfg)
    assert ps.cfg.capacity.max_neighbors > 4
    assert ps.cfg.contact.region_pair_frac > 1e-6
    # re-run from the chunk's untouched input: every attempt saw the same
    assert len(inputs) >= 2
    for got in inputs:
        for k in st0:
            assert np.array_equal(got[k], st0[k]), k
    assert getattr(ps, "region_overflow_steps", 0) == 0
    assert getattr(js, "region_overflow_steps", 0) == 0
    dpos, dvel = deltas(js, ps)
    assert dpos < 1e-6 and dvel < 1e-9


def test_pool_two_way_autosizing_shrinks():
    _, ps = out_of_box_pair(corners=False)
    ps.cfg = ps.cfg.replace(capacity=dataclasses.replace(
        ps.cfg.capacity, max_neighbors=64))
    ps.__post_init__()
    s = read_summary(np.zeros(len(Summary._fields) - 1))._replace(
        region_pool_need=40, nbr_demand=6, max_nv=8)
    for _ in range(ps._SHRINK_WINDOW):
        ps._maybe_shrink_pools(s)
    assert 8 <= ps.cfg.capacity.max_neighbors < 64
    ps.run(10)
    assert int(ps.state.alive.sum()) > 0


# -- checkpoints -------------------------------------------------------------

def test_resume_is_bit_identical(tmp_path):
    _, a = out_of_box_pair(seed=2)
    a.run(20)
    a.save(tmp_path / "ckpt")
    a.run(20)
    b = tsim.Simulation.load(tmp_path / "ckpt", a.cfg, a.forcing,
                             device="cpu")
    assert b.step_idx == 20
    b.run(20)
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    assert np.array_equal(a.dissolved, b.dissolved)
    assert (a.lifecycle.rng.bit_generator.state
            == b.lifecycle.rng.bit_generator.state)


def test_checkpoints_cross_between_packages(tmp_path):
    # JAX save -> port load -> continue, against the straight JAX run
    js, ps = out_of_box_pair(seed=0)
    js.run(20)
    js.save(tmp_path / "jax")
    js.run(20)
    p2 = tsim.Simulation.load(tmp_path / "jax", ps.cfg, ps.forcing,
                              device="cpu")
    p2.run(20)
    dpos, dvel = deltas(js, p2)
    assert dpos < 1e-6 and dvel < 1e-9
    np.testing.assert_allclose(p2.dissolved, js.dissolved, rtol=1e-9)
    # port save -> JAX load -> continue, against the straight port run
    ps.run(20)
    ps.save(tmp_path / "port")
    ps.run(20)
    j2 = Simulation.load(tmp_path / "port", js.cfg, js.forcing)
    j2.run(20)
    dpos, dvel = deltas(j2, ps)
    assert dpos < 1e-6 and dvel < 1e-9
    # the same files, keys, dtypes and metadata layout
    for name in ("state.npz", "meta.json", "dissolved.npy"):
        assert (tmp_path / "jax" / name).exists()
        assert (tmp_path / "port" / name).exists()
    za, zb = np.load(tmp_path / "jax" / "state.npz"), np.load(
        tmp_path / "port" / "state.npz")
    assert za.files == zb.files
    assert all(za[k].dtype == zb[k].dtype for k in za.files)
    ma = json.loads((tmp_path / "jax" / "meta.json").read_text())
    mb = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert ma.keys() == mb.keys() and ma["cfg"] == mb["cfg"]


# -- output, walls and small pieces -------------------------------------------

def quad_pack_pair(**procs):
    """16 jittered quads in the default walled domain under the gyre ocean,
    in float64 in both packages; no floe edge lies on an Eulerian cell
    edge (see test_torch_diagnostics for that case)."""
    rng = np.random.default_rng(3)
    sq = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    polys = [1.1e4 * sq + rng.uniform(-1e3, 1e3, (4, 2))
             + [-6.1e4 + 4.07e4 * (k % 4), -6.3e4 + 4.11e4 * (k // 4)]
             for k in range(16)]
    cfg = SimConfig(capacity=CapacityConfig(max_floes=24, max_verts=16,
                                            n_mc_points=64,
                                            stress_window=16),
                    numerics=NumericsConfig(dtype="float64"),
                    processes=ProcessConfig(corners=False, **procs))
    st = state_from_polygons(polys, 0.5, cfg,
                             velocities=rng.uniform(-0.3, 0.3, (16, 2)))
    fc = gyre_ocean()
    js = Simulation(cfg=cfg, state=st, forcing=fc, modulus=1e8)
    ps = tsim.Simulation(cfg=port_cfg(cfg), state=port_state(st),
                         forcing=forcing_from_numpy(jax_numpy(fc),
                                                    device="cpu",
                                                    dtype="float32"),
                         modulus=1e8)
    return js, ps


def test_output_with_average_and_advection_matches_jax(tmp_path):
    js, ps = quad_pack_pair(n_dt_out=10, average=True, advect_dissolved=True)
    for sim, sub in ((js, "jax"), (ps, "port")):
        sim.dissolved = np.zeros((10, 10))
        sim.dissolved[5, 2] = 1e9
        sim.output_dir = tmp_path / sub
        sim.run(20)
    for snap in ("snap0000010", "snap0000020"):
        ea = np.load(tmp_path / "jax" / snap / "eulerian.npz")
        eb = np.load(tmp_path / "port" / snap / "eulerian.npz")
        assert ea.files == eb.files
        # fields of two runs whose states agree to 1e-9 m/s: the
        # accelerations (du, dv) differ at 5e-9 of their scale, so 1e-6;
        # test_torch_diagnostics holds each function on one state to 1e-9
        for k in ea.files:
            np.testing.assert_allclose(eb[k], ea[k], rtol=1e-6,
                                       atol=1e-6 * np.abs(ea[k]).max(),
                                       err_msg=f"{snap} {k}")
    np.testing.assert_allclose(
        np.load(tmp_path / "port" / "mass_series.npy"),
        np.load(tmp_path / "jax" / "mass_series.npy"), rtol=1e-9)
    np.testing.assert_allclose(ps.dissolved, js.dissolved, rtol=1e-9,
                               atol=1e-9 * 1e9)
    assert ps._vd_tend is not None
    dpos, dvel = deltas(js, ps)
    assert dpos < 1e-6 and dvel < 1e-9


def test_uniaxial_walls_move_like_jax():
    js = jval.uniaxial_sim(n_floes=30, seed=1)
    ps = tval.uniaxial_sim(n_floes=30, seed=1, device="cpu")
    # the recipe in float64 in both packages
    cfg = js.cfg.replace(numerics=dataclasses.replace(js.cfg.numerics,
                                                      dtype="float64"))
    d = {k: np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f"
         else np.asarray(v) for k, v in jax_numpy(js.state).items()}
    js = Simulation(cfg=cfg, state=js.state.replace(
        **{k: jnp.asarray(v) for k, v in d.items()}), forcing=js.forcing,
        modulus=js.modulus, wall_fn=js.wall_fn, seed=1)
    ps = tsim.Simulation(cfg=port_cfg(cfg), state=state_from_numpy(
        d, device="cpu", dtype="float64"), forcing=ps.forcing,
        modulus=ps.modulus, wall_fn=ps.wall_fn, seed=1)
    js.run(40)
    ps.run(40)
    assert np.array_equal(np.asarray(js._domain), ps._domain.numpy())
    assert ps._wall_now == (1e5, 1e5 - 15.0)
    dpos, dvel = deltas(js, ps)
    assert dpos < 1e-6 and dvel < 1e-9


def test_merge_pool_keeps_nonzero_order():
    # flags in steps 1 and 3, one repeated: the packed pool must list the
    # pairs in np.nonzero's (step, floe, slot) order, deduplicated by first
    # occurrence, each against its own step's neighbour table
    chunk, n, k = 4, 5, 3
    merge_i = np.zeros((chunk, n, k), bool)
    nbr = np.zeros((chunk, n, k), np.int32)
    for s, i, kk, j in ((1, 4, 2, 0), (1, 2, 0, 3), (3, 2, 0, 1),
                        (3, 4, 2, 0), (0, 0, 1, 2)):
        merge_i[s, i, kk] = True
        nbr[s, i, kk] = j
    nbr[2, 2, 0] = 4        # a different floe in a step with no flag
    want = chunk_io._merge_pairs_from(merge_i, nbr, chunk)
    assert want == [(0, 2), (2, 3), (4, 0), (2, 1)]
    aux = chunk_io.ChunkAux([SimpleStep(merge_i[s], nbr[s], n, k)
                             for s in range(chunk)])
    assert tsim.chunk_merge_pairs(aux, chunk) == want
    st = boundary_state(n)
    dis = torch.zeros((2, 2), dtype=torch.float64)
    packed = chunk_io.pack_boundary(st, aux, dis, 16, merges=True).numpy()
    cols = chunk_io.boundary_columns(n, st.v_cap, 16, 4, merges=True)
    assert int(packed[:, cols["merges"]].T.reshape(-1)[0]) == 5
    got = chunk_io.fetch_boundary(st, aux, dis, 16, merges=True)
    assert got.merge_pairs == want
    assert tsim.chunk_merge_pairs(aux, 1) == [(0, 2)]


def boundary_state(n):
    """``n`` live triangles in float64, 3 km apart."""
    return port_state(state_from_polygons(
        [np.array([[0, 0], [1e3, 0], [0, 1e3]], float) + 3e3 * j
         for j in range(n)], 0.5,
        SimConfig(capacity=CapacityConfig(max_floes=n, max_verts=8,
                                          n_mc_points=8, stress_window=4),
                  numerics=NumericsConfig(dtype="float64"))))


@pytest.mark.parametrize("case", ["plain", "merges", "contact_overflow",
                                  "merge_overflow"])
def test_boundary_fetch_round_trip(case):
    """The boundary fetch's view, last-step aux, dissolved grid and merge
    pairs against the tensors they were packed from: with and without
    merges, and each pool overflowing into its dense fallback."""
    n, k, steps = 6, 3, 16
    rng = np.random.default_rng(7)
    st = boundary_state(n)
    merge_i = np.zeros((steps, n, k), bool)
    if case == "merges":
        merge_i[rng.integers(0, steps, 5), rng.integers(0, n, 5),
                rng.integers(0, k, 5)] = True
    elif case == "merge_overflow":
        merge_i[:] = True                     # 288 flags: past the pool
    # the last step's contacts: entries outside the pool (no contact, no
    # overlap) are zero, as only pooled entries come back
    valid = rng.random((n, k)) < 0.4
    valid[0, 0] = valid[-1, -1] = True        # the first and last slots
    over = np.where(rng.random((n, k)) < 0.3, rng.random((n, k)), 0.0)
    keep = valid | (over > 0)
    nbr = rng.integers(0, n, (steps, n, k)).astype(np.int32)
    nbr[-1, ~keep] = 0
    steps_aux = [SimpleStep(merge_i[s], nbr[s], n, k) for s in range(steps)]
    last = steps_aux[-1]._replace(
        pair_valid=torch.from_numpy(valid),
        pair_overlap=torch.from_numpy(over),
        boundary_contact=torch.from_numpy(rng.random(n) < 0.5),
        **{f: torch.from_numpy(np.where(keep, rng.normal(size=(n, k)), 0.0))
           for f in ("pair_px", "pair_py", "pair_fx", "pair_fy")})
    chunk = chunk_io.ChunkAux(steps_aux[:-1] + [last])
    dis = torch.from_numpy(rng.random((3, 5)))
    cap = 4 if case == "contact_overflow" else 16
    assert (int(keep.sum()) > cap) == (case == "contact_overflow")
    b = chunk_io.fetch_boundary(st, chunk, dis, cap,
                                merges=bool(merge_i.any()))
    # the view
    assert np.array_equal(b.view.alive, st.alive.numpy())
    assert np.array_equal(b.view.nv, st.nv.numpy())
    for f in ("x", "y", "u", "mass", "area"):
        assert np.array_equal(getattr(b.view, f), getattr(st, f).numpy()), f
    assert np.array_equal(b.view.stress, st.stress.numpy())
    world = st.verts_world().numpy()
    for i in range(n):
        assert np.array_equal(b.view.polys[i], world[i, :int(st.nv[i])])
    # the aux
    for f in ("pair_valid", "pair_px", "pair_py", "pair_fx", "pair_fy",
              "pair_overlap", "nbr_idx", "boundary_contact"):
        src = getattr(last, f).numpy()
        got = getattr(b.aux, f)
        assert got.shape == src.shape and np.array_equal(got, src), f
    assert b.aux.nbr_idx.dtype == np.int32
    assert b.aux.pair_valid.dtype == b.aux.boundary_contact.dtype == bool
    if case == "contact_overflow":
        assert b.aux_cap >= 1.25 * keep.sum() and b.aux_cap % cap == 0
    else:
        assert b.aux_cap == cap
    # the dissolved grid
    assert b.dissolved.dtype == np.float64
    assert np.array_equal(b.dissolved, dis.numpy())
    # the merge pairs, first occurrence first in (step, floe, slot) order
    want = list(dict.fromkeys((int(i), int(nbr[s, i, kk])) for s, i, kk
                              in zip(*np.nonzero(merge_i))))
    assert b.merge_pairs == want
    assert (len(want) > 0) == (case in ("merges", "merge_overflow"))


def SimpleStep(merge_i, nbr, n, k):
    """A StepAux with only the merge flags and neighbour table set."""
    from subzero_tpu_torch.dynamics.step import StepAux

    zf = torch.zeros((n, k), dtype=torch.float64)
    zb = torch.zeros((n,), dtype=torch.bool)
    return StepAux(
        n_collisions=torch.tensor(0), n_coast_pairs=torch.tensor(0),
        merge_i=torch.from_numpy(merge_i),
        merge_j=torch.zeros((n, k), dtype=torch.bool), absorb_boundary=zb,
        killed=zb, exported=zb, nbr_overflow=torch.tensor(False),
        nbr_demand=torch.tensor(0), overlap_area=torch.zeros(n),
        collision_force=torch.zeros((n, 2)), collision_torque=torch.zeros(n),
        nbr_idx=torch.from_numpy(nbr), pair_valid=zf > 0, pair_px=zf,
        pair_py=zf, pair_fx=zf, pair_fy=zf, pair_overlap=zf,
        boundary_contact=zb, region_overflow=torch.tensor(False),
        region_pool_need=torch.tensor(0),
        pair_pool_overflow=torch.tensor(False),
        pair_pool_need=torch.tensor(0))


def test_profile_writes_a_trace(tmp_path):
    _, ps = out_of_box_pair(corners=False)
    out = ps.profile(tmp_path / "trace.json", n_steps=2)
    assert (tmp_path / "trace.json").exists() and ps.step_idx == 2
    assert out == tmp_path / "trace.json"


def test_unported_options_raise():
    # every option is ported now; a mesh that is not the port's Mesh raises
    _, ps = out_of_box_pair()
    kw = dict(cfg=ps.cfg, state=ps.state, forcing=ps.forcing,
              modulus=ps.modulus)
    with pytest.raises(TypeError, match="parallel.distributed.Mesh"):
        tsim.Simulation(mesh=object(), **kw)
