"""The port's state construction and polygon helpers against the JAX
package's, float64 on the CPU."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.config import CapacityConfig, NumericsConfig, SimConfig
from subzero_tpu.geometry import polygon as jpoly
from subzero_tpu.state import state_from_polygons
from oracles import random_convex

import subzero_tpu_torch.config as tcfg
from subzero_tpu_torch.convert import (
    forcing_from_numpy, forcing_to_numpy, state_from_numpy, state_to_numpy,
)
from subzero_tpu_torch.forcing import gyre_ocean
from subzero_tpu_torch.geometry import polygon as tpoly
from subzero_tpu_torch.state import state_from_polygons as tstate_from_polygons

torch.set_num_threads(1)

ELL = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], dtype=float)


def polys(n=12, seed=0):
    rng = np.random.default_rng(seed)
    out = [1e3 * random_convex(rng, center=rng.uniform(-50, 50, 2))
           for _ in range(n - 2)]
    # concave and clockwise (reversed) inputs, and a duplicated closing vertex
    out.append(700.0 * ELL[::-1] + [3e4, -2e4])
    out.append(np.vstack([900.0 * ELL, 900.0 * ELL[:1]]) - [2e4, 1e4])
    return out


def configs(dtype):
    cap = dict(max_floes=16, max_verts=12, n_mc_points=64, stress_window=8)
    return (SimConfig(capacity=CapacityConfig(**cap),
                      numerics=NumericsConfig(dtype=dtype)),
            tcfg.SimConfig(capacity=tcfg.CapacityConfig(**cap),
                           numerics=tcfg.NumericsConfig(dtype=dtype)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_state_from_polygons_field_by_field(dtype):
    jcfg, pcfg = configs(dtype)
    ps = polys()
    vel = np.random.default_rng(1).uniform(-0.2, 0.2, (len(ps), 2))
    js = state_from_polygons(ps, 0.7, jcfg, seed=3, velocities=vel)
    ts = tstate_from_polygons(ps, 0.7, pcfg, seed=3, velocities=vel,
                              device="cpu")
    got = state_to_numpy(ts)
    for f in dataclasses.fields(js):
        want = np.asarray(getattr(js, f.name))
        assert got[f.name].dtype == want.dtype, f.name
        assert got[f.name].shape == want.shape, f.name
        np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)


def test_derived_geometry_matches():
    jcfg, pcfg = configs("float64")
    js = state_from_polygons(polys(), 0.7, jcfg, seed=3)
    d = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}
    d["alpha"] = np.random.default_rng(2).uniform(-3, 3, d["alpha"].shape)
    ts = state_from_numpy(d, device="cpu", dtype=torch.float64)
    js = js.replace(alpha=jnp.asarray(d["alpha"]))
    np.testing.assert_allclose(ts.verts_world().numpy(),
                               np.asarray(js.verts_world()), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ts.rot_matrix().numpy(),
                               np.asarray(js.rot_matrix()), rtol=0,
                               atol=1e-15)


def test_polygon_helpers_match():
    ps = polys(10, seed=4)
    pa, nv = tpoly.pad_polygons(ps, 12)
    ja, jnv = jpoly.pad_polygons(ps, 12)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(nv, jnv)
    t = torch.from_numpy(pa)
    j = jnp.asarray(pa)
    np.testing.assert_allclose(tpoly.poly_area(t).numpy(),
                               np.asarray(jpoly.poly_area(j)), rtol=1e-12)
    np.testing.assert_allclose(tpoly.poly_centroid(t).numpy(),
                               np.asarray(jpoly.poly_centroid(j)), rtol=1e-12)
    tm, jm = tpoly.poly_moments(t), jpoly.poly_moments(j)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-12, err_msg=k)
    pts = np.random.default_rng(5).uniform(-6e4, 6e4, (10, 200, 2))
    np.testing.assert_array_equal(
        tpoly.points_in_polygon(torch.from_numpy(pts), t).numpy(),
        np.asarray(jpoly.points_in_polygon(jnp.asarray(pts), j)))


def test_converters_round_trip():
    jcfg, _ = configs("float64")
    js = state_from_polygons(polys(), 0.7, jcfg, seed=3)
    d = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fc = gyre_ocean(lx=1e5, dx=1e4, dtype=torch.float64, device="cpu")
    fd = forcing_to_numpy(fc)
    fc2 = forcing_from_numpy(fd, device="cpu")
    for k, v in forcing_to_numpy(fc2).items():
        np.testing.assert_array_equal(v, fd[k], err_msg=k)
