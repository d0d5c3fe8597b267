"""The port's serial oracle (``subzero_tpu_torch.oracle``) against the JAX
package's, and the port's step against it, float64 on the CPU.

* The same state goes through both packages' ``floes_from_state``; then
  both oracles step in lockstep (200 steps of test_golden.py's head-on
  blocks, moved 480 m closer so they collide within the run, and 50 of its
  10-floe gyre scenario with ocean forcing) and every
  ``OFloe`` field must be identical after every step: both are the same
  numpy over the same native engine source.
* The port's CPU step (``make_step_fn(device="cpu")``) in lockstep with the
  port's oracle on two golden scenarios, at test_golden.py's check cadence
  and tolerances, with energy dissipation: the head-on blocks (per-region
  contacts, the default) and the two concave floes with per-region
  contacts.  Both start closer than in test_golden.py so contact begins
  within the first 10 steps of the cut depth (test_torch_step.py's GOLDEN
  placement for the concave floes; the blocks 480 m closer).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu import oracle as joracle
from subzero_tpu.forcing import gyre_ocean, uniform_forcing
from subzero_tpu.state import state_from_polygons

from subzero_tpu_torch import oracle as toracle
from subzero_tpu_torch.convert import forcing_from_numpy, state_from_numpy
from test_golden import SQ1, SQ2, _complex, _modulus
from test_torch_init import port_cfg
from test_torch_step import GOLDEN, to_numpy

import chip_smoke

torch.set_num_threads(1)


def gyre_case():
    """test_golden.py's out-of-box scenario inputs (10 Voronoi floes, seed
    3, those of at most 30 vertices, gyre ocean), in the JAX package."""
    from subzero_tpu.config import SimConfig
    from subzero_tpu.init import voronoi_floe_field

    polys, _ = voronoi_floe_field(SimConfig(), target_concentration=0.4,
                                  n_floes=10, height_mean=0.25, seed=3)
    return [p for p in polys if len(p) <= 30]


# test_golden.py's head-on blocks, 480 m closer: they touch at step 8
HEAD_ON = ([SQ1, SQ2 - [9.5e3 + 480.0, 0]], [[0.15, 0.02], [-0.1, 0.02]])

CASES = {
    "head_on_blocks": lambda: (*HEAD_ON, 200, dict(max_verts=64), None),
    "out_of_box_gyre": lambda: (
        gyre_case(), None, 50, dict(max_verts=32, ocean=True),
        gyre_ocean(lx=4e5, dx=1e4, dtype=jnp.float64)),
}


def assert_same_floes(a: list, b: list, where: str):
    assert len(a) == len(b)
    for i, (fa, fb) in enumerate(zip(a, b)):
        for f in dataclasses.fields(fa):
            va, vb = getattr(fa, f.name), getattr(fb, f.name)
            assert np.array_equal(np.asarray(va), np.asarray(vb)), \
                f"{where}: floe {i} field {f.name}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_oracle_equals_jax_oracle(case):
    polys, vels, steps, kw, jforcing = CASES[case]()
    vels = np.zeros((len(polys), 2)) if vels is None else np.asarray(vels)
    pcfg = chip_smoke.golden_config(len(polys), **kw)
    jcfg = jax_config(pcfg)
    jst = state_from_polygons(polys, 0.25, jcfg, seed=0, velocities=vels)
    pst = state_from_numpy(to_numpy(jst), device="cpu")
    jforcing = jforcing or uniform_forcing(lx=4e5, dx=1e4)
    pforcing = forcing_from_numpy(to_numpy(jforcing), device="cpu",
                                  dtype=str(jforcing.uo.dtype))
    modulus = _modulus(polys)
    ja = joracle.floes_from_state(jst, jcfg, n=len(polys))
    pa = toracle.floes_from_state(pst, pcfg, n=len(polys))
    assert_same_floes(ja, pa, "floes_from_state")
    touched = 0
    for s in range(steps):
        joracle.oracle_step(ja, jforcing, jcfg, modulus, s)
        toracle.oracle_step(pa, pforcing, pcfg, modulus, s)
        assert_same_floes(ja, pa, f"step {s}")
        touched += sum(len(f.interactions) > 0 for f in pa)
    assert touched > 0, "no contact in the oracle run"
    assert toracle.kinetic_energy(pa) == joracle.kinetic_energy(ja)


def jax_config(pcfg):
    """The JAX SimConfig equal to the port's ``pcfg`` field for field."""
    import subzero_tpu.config as jconfig

    def conv(obj):
        if dataclasses.is_dataclass(obj):
            cls = getattr(jconfig, type(obj).__name__)
            return cls(**{f.name: conv(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)})
        return obj

    jcfg = conv(pcfg)
    assert port_cfg(jcfg) == pcfg
    return jcfg


GOLDEN_CASES = {
    # (polys, velocities, steps, lockstep kwargs, tol m, tol m/s)
    "head_on_blocks": lambda: (*HEAD_ON, 100, {}, 1e-5, 1e-9),
    "two_concave_floes_per_region": lambda: (
        [_complex(k, t) for k, t in GOLDEN["two_concave_floes"][0]],
        GOLDEN["two_concave_floes"][1], 100,
        dict(contact=dict(per_region=True, region_cap=16)), 1e-6, 1e-9),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_port_step_tracks_port_oracle(case):
    polys, vels, steps, kw, tol_x, tol_u = GOLDEN_CASES[case]()
    r = chip_smoke.golden_lockstep(polys, vels, steps, "cpu", **kw)
    assert r["launches"] == 0
    assert r["max_dx"] < tol_x
    assert r["max_du"] < tol_u
    chip_smoke.assert_dissipation(r, case)
    k = r["k"]
    assert k[-1] < k[0] * (1 - 1e-6), "the floes never collided"
