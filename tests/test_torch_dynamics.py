"""The port's broad phase, contact forces and trajectory update against the
JAX package's, float64 on the CPU, from the same numpy inputs."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.dynamics.broadphase import (
    neighbor_candidates, neighbor_candidates_cells,
)
from subzero_tpu.dynamics.contact import boundary_contact, contact_forces
from subzero_tpu.dynamics.step import domain_polygon
from subzero_tpu.dynamics.trajectory import floe_stress, trajectory_update
from subzero_tpu.forcing import gyre_ocean, interp_bilinear_mxu
from subzero_tpu.state import state_from_polygons

from subzero_tpu_torch.convert import (
    forcing_from_numpy, state_from_numpy, state_to_numpy,
)
from subzero_tpu_torch.dynamics import broadphase as tbp
from subzero_tpu_torch.dynamics import contact as tcontact
from subzero_tpu_torch.dynamics import trajectory as ttraj
from subzero_tpu_torch.forcing import interp_bilinear_mxu as t_interp_mxu
from test_torch_step import configs, lattice, star_lattice, to_numpy

torch.set_num_threads(1)

MODULUS = 1.6e8


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype) if dtype else \
        torch.from_numpy(np.array(a))


def lattice_state(side, periodic, seed=0, n_dead=3):
    polys, vel, lx = lattice(side, seed=seed)
    n = side * side
    jcfg, pcfg = configs(n, lx, periodic)
    js = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    dead = np.zeros(n, bool)
    dead[np.random.default_rng(seed).choice(n, n_dead, replace=False)] = True
    js = js.replace(alive=js.alive & ~jnp.asarray(dead))
    return jcfg, pcfg, js, lx


def test_floe_stress_matches_jax():
    _, _, js, _ = lattice_state(4, True)
    rng = np.random.default_rng(7)
    n, k = js.n, 8
    cf = rng.normal(0.0, 1e6, (2, n, k))
    pt = np.asarray(js.x)[:, None] + rng.normal(0.0, 1e3, (2, n, k))
    pt[1] += np.asarray(js.y)[:, None] - np.asarray(js.x)[:, None]
    valid = rng.random((n, k)) < 0.6
    want = floe_stress(js, *(jnp.asarray(a) for a in (*cf, *pt, valid)))
    got = ttraj.floe_stress(state_from_numpy(to_numpy(js), device="cpu"),
                            *(_t(a) for a in (*cf, *pt, valid)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.max(np.abs(want)))


def test_interp_bilinear_mxu_matches_jax():
    # the port's gather against the JAX one-hot matmuls, points inside,
    # on and beyond the grid (clamped), through several JAX chunks
    fc = gyre_ocean(lx=4e4, dx=5e3, transport=2e3, wind_u=3.0,
                    dtype=jnp.float64)
    fields = jnp.stack([fc.uo, fc.vo, fc.ua, fc.va])
    rng = np.random.default_rng(8)
    fx, fy = rng.uniform(-5e4, 5e4, (2, 3, 700))
    fx[0, :5] = np.asarray(fc.x0) + 5e3 * np.arange(5)     # grid nodes
    want = interp_bilinear_mxu(fields, jnp.asarray(fx), jnp.asarray(fy),
                               fc.x0, fc.y0, fc.dx, chunk=512)
    got = t_interp_mxu(_t(fields), _t(fx), _t(fy), _t(fc.x0), _t(fc.y0),
                       _t(fc.dx), chunk=512)
    assert got.shape == want.shape == (4, 2100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("periodic,n_skip", [(True, 0), (False, 0),
                                             (False, 4)])
def test_broadphase_identical(periodic, n_skip):
    jcfg, _, js, lx = lattice_state(8, periodic)
    args = (js.x, js.y, js.rmax, js.alive, 8, periodic, lx, lx)
    want = neighbor_candidates(*args, n_skip_rows=n_skip)
    got = tbp.neighbor_candidates(
        _t(js.x), _t(js.y), _t(js.rmax), _t(js.alive), 8, periodic, lx, lx,
        n_skip_rows=n_skip)
    for f in ("idx", "valid", "shift", "overflow", "demand"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        # (idx and demand are int32 in the port, as in the JAX step's aux;
        # the JAX broad phase widens them to int64 under x64)
        assert g.dtype == (np.int32 if f in ("idx", "demand")
                           else w.dtype), f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert bool(np.asarray(want.valid).any())


def test_broadphase_overflow_and_ties():
    # a regular (untilted, unjittered) lattice has exact distance ties, and
    # K=3 < the 8 neighbours of an interior floe forces an overflow
    side, pitch = 5, 1000.0
    g = (np.arange(side) - (side - 1) / 2) * pitch
    x, y = [a.ravel() for a in np.meshgrid(g, g)]
    r = np.full(x.shape, 0.75 * pitch)
    alive = np.ones(x.shape, bool)
    lx = side * pitch / 2
    want = neighbor_candidates(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(r), jnp.asarray(alive), 3, True,
                               lx, lx)
    got = tbp.neighbor_candidates(_t(x), _t(y), _t(r), _t(alive), 3, True,
                                  lx, lx)
    for f in ("idx", "valid", "shift", "overflow", "demand"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert bool(got.overflow)


def _nbr_to_torch(nbr):
    return tbp.NeighborTable(*(_t(a) for a in nbr))


@pytest.mark.parametrize("periodic", [True, False])
def test_contact_forces_match(periodic):
    jcfg, pcfg, js, lx = lattice_state(6, periodic, seed=2)
    ts = state_from_numpy(to_numpy(js), device="cpu")
    nbr = neighbor_candidates(js.x, js.y, js.rmax, js.alive, 8, periodic,
                              lx, lx)
    dom = domain_polygon(jcfg)
    vw = js.verts_world()
    want = contact_forces(vw, js.x, js.y, js.u, js.v, js.ksi, js.h, js.area,
                          nbr, MODULUS, jcfg, nv=js.nv, domain_verts=dom)
    got = tcontact.contact_forces(
        ts.verts_world(), ts.x, ts.y, ts.u, ts.v, ts.ksi, ts.h, ts.area,
        _nbr_to_torch(nbr), MODULUS, pcfg, nv=ts.nv, domain_verts=_t(dom))
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        scale = max(1.0, float(np.max(np.abs(w))))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * scale,
                                   err_msg=f)
    assert np.count_nonzero(np.asarray(want.fx)) > 10
    if not periodic:
        wb = boundary_contact(vw, js.x, js.y, js.u, js.v, js.ksi, js.h,
                              js.area, js.alive, dom, MODULUS, jcfg, nv=js.nv)
        gb = tcontact.boundary_contact(
            ts.verts_world(), ts.x, ts.y, ts.u, ts.v, ts.ksi, ts.h, ts.area,
            ts.alive, _t(dom), MODULUS, pcfg, nv=ts.nv)
        for f in wb._fields:
            w = np.asarray(getattr(wb, f))
            scale = max(1.0, float(np.max(np.abs(w))))
            np.testing.assert_allclose(getattr(gb, f).numpy(), w, rtol=0,
                                       atol=1e-9 * scale, err_msg=f)
        assert np.count_nonzero(np.asarray(wb.fx)) > 0


@pytest.mark.parametrize("do_int", [True, False])
def test_trajectory_update_with_clamps(do_int):
    """Random contact forces large enough that the /10 force clamp, the
    acceleration cap and the spin cap all fire, with thin floes (the
    forcing refresh outside do_int steps), a tiny-mass death and the 4-gyre
    ocean with wind."""
    jcfg, pcfg, js, lx = lattice_state(6, False, seed=3)
    n = js.n
    rng = np.random.default_rng(4)
    h = rng.uniform(0.05, 2.0, n)
    h[::4] = rng.uniform(0.02, 0.1, h[::4].shape)       # thin: capped
    rho = jcfg.physics.rho_ice
    area = np.asarray(js.area)
    d = to_numpy(js)
    d.update(
        h=h, mass=area * h * rho, inertia=np.asarray(js.inertia) * h / 0.5,
        alpha=rng.uniform(-1, 1, n), ksi=rng.uniform(-1e-5, 1e-5, n),
        dx_p=rng.uniform(-0.1, 0.1, n), dy_p=rng.uniform(-0.1, 0.1, n),
        dalpha_p=rng.uniform(-1e-5, 1e-5, n),
        du_p=rng.uniform(-1e-3, 1e-3, n), dv_p=rng.uniform(-1e-3, 1e-3, n),
        dksi_p=rng.uniform(-1e-7, 1e-7, n),
        fx_oa=rng.uniform(-1, 1, n), fy_oa=rng.uniform(-1, 1, n),
        tq_oa=rng.uniform(-10, 10, n),
    )
    d["mass"][5] = 50.0                                 # dies: < min_mass
    js = js.replace(**{k: jnp.asarray(v) for k, v in d.items()})
    ts = state_from_numpy(d, device="cpu")
    mag = 10.0 ** rng.uniform(6, 11, (3, n))
    sgn = rng.choice([-1.0, 1.0], (3, n))
    cf = mag * sgn
    cf[2] *= 1e4                                        # torques
    jf = gyre_ocean(lx=4 * lx, dx=lx / 8, wind_u=6.0, wind_v=3.0,
                    dtype=jnp.float64)
    tf = forcing_from_numpy(to_numpy(jf), device="cpu")

    want = trajectory_update(js, jf, *(jnp.asarray(c) for c in cf), -1e-7,
                             jnp.asarray(do_int), jcfg)
    got = ttraj.trajectory_update(ts, tf, *(_t(c) for c in cf), -1e-7,
                                  do_int, pcfg)
    g = state_to_numpy(got)
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        # (relative to the field's scale: the strain's xy entry of a rigid
        # rotation is a cancellation at 1e-16 of the diagonal)
        scale = float(np.max(np.abs(w))) if w.dtype.kind == "f" else 0.0
        np.testing.assert_allclose(g[f.name], w, rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=f.name)

    # the clamps really fired
    limit = d["mass"] / (jcfg.clamps.force_dt_factor * jcfg.numerics.dt)
    assert np.any(np.maximum(np.abs(cf[0]), np.abs(cf[1])) > 10 * limit)
    dt = jcfg.numerics.dt
    accel = dt * np.maximum(np.abs(np.asarray(want.du_p)),
                            np.abs(np.asarray(want.dv_p)))
    capped = np.isclose(accel, jcfg.clamps.accel_h_factor
                        * np.asarray(want.h), rtol=1e-9)
    assert np.count_nonzero(capped & np.asarray(want.alive)) >= 3
    assert np.any(np.abs(np.asarray(want.ksi)) == jcfg.clamps.max_spin)
    assert not bool(want.alive[5])


# ---------------------------------------------------------------------------
# per-region contacts and the active-pair pool
# ---------------------------------------------------------------------------

# (ContactConfig fields, star radius factor, expected flags).  Radius 0.45
# is bench.py's concave lattice: 64 stars, P = 512 pair slots, a demand of
# 30 >= 4-crossing slots (the default 128-slot pool fits) and 264 valid
# pairs.  Radius 0.5 interlocks deeper: a demand of 142 overflows the
# 128-slot floor, and all 512 slots are bbox-active, past the pair pool's
# 256-slot floor.
REGION_CASES = {
    "default_pool": ({}, 0.45, dict(region_overflow=False)),
    "region_overflow": ({}, 0.5, dict(region_overflow=True)),
    "pair_pool": (dict(pair_pool=True, pair_pool_frac=1.0), 0.45,
                  dict(region_overflow=False, pair_pool_overflow=False)),
    "pair_pool_overflow": (dict(pair_pool=True), 0.5,
                           dict(pair_pool_overflow=True)),
    "pair_pool_aggregate": (dict(pair_pool=True, pair_pool_frac=1.0,
                                 per_region=False), 0.45,
                            dict(pair_pool_overflow=False)),
    "edge_mean": (dict(region_dl="edge_mean"), 0.45,
                  dict(region_overflow=False)),
    "reclip": (dict(normal_dir="reclip"), 0.45, dict(region_overflow=False)),
}



def _assert_fields_match(got, want, tol):
    """Flags and counters identical, float fields within ``tol`` of their
    scale.  The contact point of a pair that carries no force is the
    centroid of an overlap the cull dropped, often a sliver (0.2 m² in the
    deep-interlock lattice), where the aggregate clip's moment / area
    division leaves 3e-12 relative: there it is held to the 1e-9 of
    test_contact_forces_match."""
    force = np.asarray(want.fx != 0) | np.asarray(want.fy != 0)
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=f)
            continue
        scale = max(1.0, float(np.max(np.abs(w))))
        if f in ("px", "py"):
            np.testing.assert_allclose(g[force], w[force], rtol=0,
                                       atol=tol * scale, err_msg=f)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * scale,
                                       err_msg=f)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f)


@pytest.mark.parametrize("case", sorted(REGION_CASES))
def test_region_contacts_match(case):
    contact, radius, flags = REGION_CASES[case]
    polys, vel, lx = star_lattice(8, seed=0, radius=radius)
    jcfg, pcfg = configs(64, lx, True, contact=contact)
    js = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    ts = state_from_numpy(to_numpy(js), device="cpu")
    nbr = neighbor_candidates(js.x, js.y, js.rmax, js.alive, 8, True, lx, lx)
    dom = domain_polygon(jcfg)
    vw = js.verts_world()
    # (the JAX functions run eagerly: under jit XLA reorders the region
    # sums, and a sliver region moves its pair's contact point by 3e-12
    # relative)
    want = contact_forces(vw, js.x, js.y, js.u, js.v, js.ksi, js.h, js.area,
                          nbr, MODULUS, jcfg, nv=js.nv, domain_verts=dom)
    got = tcontact.contact_forces(
        ts.verts_world(), ts.x, ts.y, ts.u, ts.v, ts.ksi, ts.h, ts.area,
        _nbr_to_torch(nbr), MODULUS, pcfg, nv=ts.nv, domain_verts=_t(dom))
    _assert_fields_match(got, want, 1e-12)
    for f, v in flags.items():
        assert bool(getattr(got, f)) is v, f
    if jcfg.contact.per_region and not flags.get("pair_pool_overflow"):
        assert int(got.region_need) > 0
    if jcfg.contact.pair_pool:
        assert int(got.pair_pool_need) > 0
    assert np.count_nonzero(np.asarray(want.fx)) > 50 or \
        flags.get("pair_pool_overflow")

    # the edge stars stick out of the domain: multi-region differences
    wb = boundary_contact(vw, js.x, js.y, js.u, js.v, js.ksi, js.h, js.area,
                          js.alive, dom, MODULUS, jcfg, nv=js.nv)
    gb = tcontact.boundary_contact(
        ts.verts_world(), ts.x, ts.y, ts.u, ts.v, ts.ksi, ts.h, ts.area,
        ts.alive, _t(dom), MODULUS, pcfg, nv=ts.nv)
    _assert_fields_match(gb, wb, 1e-12)
    assert np.count_nonzero(np.asarray(wb.fx)) > 0
    if jcfg.contact.per_region:
        assert int(gb.region_need) > 0 and not bool(gb.region_overflow)


# ---------------------------------------------------------------------------
# cell-list broad phase
# ---------------------------------------------------------------------------

def _cells_both(x, y, r, alive, k, periodic, lx, cell, cap, n_skip=0):
    want = neighbor_candidates_cells(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(r), jnp.asarray(alive),
        k, periodic, lx, lx, cell, cap, n_skip_rows=n_skip)
    got = tbp.neighbor_candidates_cells(
        _t(x), _t(y), _t(r), _t(alive), k, periodic, lx, lx, cell, cap,
        n_skip_rows=n_skip)
    for f in ("idx", "valid", "shift", "overflow", "demand"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        if f in ("idx", "demand"):
            assert g.dtype == np.int32, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    return got


@pytest.mark.parametrize("periodic,n_skip", [(True, 0), (False, 0),
                                             (False, 4)])
def test_cells_broadphase_identical(periodic, n_skip):
    _, _, js, lx = lattice_state(8, periodic)
    got = _cells_both(np.asarray(js.x), np.asarray(js.y),
                      np.asarray(js.rmax), np.asarray(js.alive), 8,
                      periodic, lx, 1.5 * 4000.0, 8, n_skip)
    assert bool(got.valid.any()) and not bool(got.overflow)
    # the same table as the dense broad phase, up to candidate order
    dense = tbp.neighbor_candidates(
        _t(js.x), _t(js.y), _t(js.rmax), _t(js.alive), 8, periodic, lx, lx,
        n_skip_rows=n_skip)
    for i in range(got.idx.shape[0]):
        a = set(got.idx[i][got.valid[i]].tolist())
        assert a == set(dense.idx[i][dense.valid[i]].tolist()), i


@pytest.mark.parametrize("periodic", [True, False])
def test_cells_broadphase_overfull_cell_and_ties(periodic):
    # a regular lattice (exact distance ties) with K=3 < 8 neighbours, one
    # cell holding more floes than its cap of 4, and two dead floes
    side, pitch = 6, 1000.0
    g = (np.arange(side) - (side - 1) / 2) * pitch
    x, y = [a.ravel() for a in np.meshgrid(g, g)]
    x = np.concatenate([x, [10.0, 20.0, 30.0, 40.0]])
    y = np.concatenate([y, [15.0, 25.0, 35.0, 45.0]])
    r = np.full(x.shape, 0.72 * pitch)
    alive = np.ones(x.shape, bool)
    alive[[3, 17]] = False
    lx = side * pitch / 2
    got = _cells_both(x, y, r, alive, 3, periodic, lx, 2.0 * pitch, 4)
    assert bool(got.overflow)
    assert int(got.demand) > 3


def test_cells_broadphase_repeats_last_sorted_floe():
    # A fault of the reference kept for parity (ROADMAP §C): the slot
    # window of the last occupied cell runs past the end of the sorted
    # floes, is clamped to the last slot, and lists that floe once per
    # clamped slot.  On this 8 x 8 lattice with no dead floe (dead floes
    # sort last and absorb the clamp), floe 6's row holds floe 63 four
    # times, so its contact force with floe 63 counts four times.
    _, _, js, lx = lattice_state(8, True, n_dead=0)
    got = _cells_both(np.asarray(js.x), np.asarray(js.y),
                      np.asarray(js.rmax), np.asarray(js.alive), 8, True,
                      lx, 1.5 * 4000.0, 8)
    row = got.idx[6][got.valid[6]].tolist()
    assert row.count(63) == 4
    assert bool(got.overflow)
