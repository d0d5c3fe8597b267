"""The port's initial floe fields and validation builders against the JAX
package's, on the CPU.

The numpy generators are verbatim copies, so one seed must give the same
polygons, thicknesses, states (every field, ``np.array_equal``), moduli and
configurations (``dataclasses.asdict`` equal) in both packages.  The port's
entry points default to CUDA and raise without it, and its driver modules
import with JAX unimportable.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import subzero_tpu.validation as jval
from subzero_tpu.config import (
    CapacityConfig, DomainConfig, NumericsConfig, SimConfig,
)
from subzero_tpu.init import initial_state, voronoi_floe_field

import subzero_tpu_torch.config as tcfg
import subzero_tpu_torch.validation as tval
from subzero_tpu_torch.convert import forcing_to_numpy, state_to_numpy
from subzero_tpu_torch.init import (
    initial_state as t_initial_state,
    voronoi_floe_field as t_voronoi_floe_field,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def port_cfg(cfg):
    """The port's SimConfig with the same field values as a JAX one."""
    d = dataclasses.asdict(cfg)
    sections = {"physics": "PhysicsConfig", "contact": "ContactConfig",
                "clamps": "ClampConfig", "processes": "ProcessConfig",
                "capacity": "CapacityConfig", "numerics": "NumericsConfig",
                "domain": "DomainConfig"}
    kw = {k: getattr(tcfg, cls)(**d.pop(k)) for k, cls in sections.items()}
    return tcfg.SimConfig(**kw, **d)


def jax_numpy(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port_run_state(jsim) -> dict:
    """The JAX driver's run state under every name the port's driver
    declares (``sim.run_state_defaults``), as the port holds it: arrays as
    CPU tensors, the AVERAGE accumulator as the port's EulerianData."""
    import copy

    from subzero_tpu_torch.diagnostics import EulerianData
    from subzero_tpu_torch.sim import run_state_defaults

    def port(v):
        if hasattr(v, "_asdict"):
            return EulerianData(**{k: port(a) for k, a in
                                   v._asdict().items()})
        if hasattr(v, "__array__"):
            return torch.from_numpy(np.array(v))
        return copy.deepcopy(v)

    return {k: port(getattr(jsim, k, v))
            for k, v in run_state_defaults().items()}


def assert_states_equal(jstate, pstate):
    a, b = jax_numpy(jstate), state_to_numpy(pstate)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


CONCENTRATIONS = {
    "scalar": 1.0,
    "grid 2x2": np.array([[1.0, 0.6], [0.0, 0.9]]),
    "grid 3x1": np.array([[0.8], [1.0], [0.5]]),
}


@pytest.mark.parametrize("name", sorted(CONCENTRATIONS))
def test_voronoi_floe_field_matches_jax(name):
    cfg = SimConfig(capacity=CapacityConfig(max_floes=128, max_verts=12),
                    domain=DomainConfig(lx=5e4, ly=8e4))
    args = (CONCENTRATIONS[name], 40, 0.5, 0.2)
    polys, h = voronoi_floe_field(cfg, *args, seed=3)
    tpolys, th = t_voronoi_floe_field(port_cfg(cfg), *args, seed=3)
    assert len(polys) == len(tpolys) > 5
    assert all(np.array_equal(p, q) for p, q in zip(polys, tpolys))
    assert np.array_equal(h, th)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_initial_state_matches_jax(dtype):
    cfg = SimConfig(capacity=CapacityConfig(max_floes=48),
                    numerics=NumericsConfig(dtype=dtype))
    jst, jmod = initial_state(cfg, 1.0, 12, 0.25, 0.1, seed=5)
    pst, pmod = t_initial_state(port_cfg(cfg), 1.0, 12, 0.25, 0.1, seed=5,
                                device="cpu")
    assert_states_equal(jst, pst)
    assert pmod == jmod


def assert_sims_equal(jsim, psim):
    assert dataclasses.asdict(jsim.cfg) == dataclasses.asdict(psim.cfg)
    assert_states_equal(jsim.state, psim.state)
    for k in ("modulus", "heat_flux", "seed", "nx_coarse", "ny_coarse",
              "step_idx", "pack_target", "wall_cadence", "_chunk"):
        assert getattr(jsim, k) == getattr(psim, k), k
    fa, fb = jax_numpy(jsim.forcing), forcing_to_numpy(psim.forcing)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k
    assert (jsim.wall_fn is None) == (psim.wall_fn is None)
    if jsim.wall_fn is not None:
        for s in (0, 29, 30, 600, 10 ** 5):
            assert jsim.wall_fn(s) == psim.wall_fn(s)
    assert np.array_equal(np.asarray(jsim._domain), psim._domain.numpy())
    lj, lp = jsim.lifecycle, psim.lifecycle
    assert np.array_equal(lj.domain_poly, lp.domain_poly)
    assert (lj.amax, lj.pack_h0) == (lp.amax, lp.pack_h0)
    assert lj.rng.bit_generator.state == lp.rng.bit_generator.state


BUILDERS = {
    "uniaxial": dict(n_floes=60),
    "nares": dict(n_floes=40),
    "nares full basin": dict(n_floes=40, full_basin=True, islands=True),
    "winter": dict(n_floes=50),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_validation_builders_match_jax(name):
    fn = name.split()[0] + "_sim"
    kw = BUILDERS[name]
    jsim = getattr(jval, fn)(seed=2, **kw)
    psim = getattr(tval, fn)(seed=2, device="cpu", **kw)
    assert_sims_equal(jsim, psim)
    for stat in ("floe_size_distribution", "ice_thickness_distribution"):
        hj, ej = getattr(jval, stat)(jsim.state)
        hp, ep = getattr(tval, stat)(psim.state)
        assert np.array_equal(hj, hp) and np.array_equal(ej, ep)


def test_nares_topography_matches_jax():
    for a, b in zip(jval.nares_topography(5e4, 3.75e5),
                    tval.nares_topography(5e4, 3.75e5)):
        assert np.array_equal(a, b)


def test_builder_dtype_override():
    psim = tval.winter_sim(n_floes=20, device="cpu", dtype="float64")
    assert psim.cfg.numerics.dtype == "float64"
    assert psim.state.x.dtype == torch.float64


def test_entry_points_need_cuda_by_default(monkeypatch):
    from subzero_tpu_torch.sim import out_of_box_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (out_of_box_sim, lambda: tval.winter_sim(n_floes=20),
                  lambda: tval.uniaxial_sim(n_floes=20)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import subzero_tpu_torch.sim, subzero_tpu_torch.validation, "
            "subzero_tpu_torch.diagnostics, subzero_tpu_torch.dissolved; "
            "assert not any(m == 'subzero_tpu' or m.startswith('subzero_tpu.')"
            " for m in sys.modules), 'imported the JAX package'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
