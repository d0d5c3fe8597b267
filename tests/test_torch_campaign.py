"""The port's validation campaign (``subzero_tpu_torch.campaign``) on the
CPU in float64, against the JAX package's driver.

Every case runs a short leg (20 steps, 40 for the uniaxial walls, which
move at step 30 under the campaign's closure rate) into a temporary
directory with the output cadence cut to 20 steps, so each leg writes one
snapshot.  The out-of-box, uniaxial and winter legs are held against JAX
``Simulation``s built from the same initial state, config, forcing and
walls (as test_torch_sim.py builds them): equal live counts, the mass
series (the ledger) within 1e-9 and equal distributions.  The snapshot's
Eulerian fields equal JAX's ``eulerian_data`` of the snapshot's state
within 1e-9 (the floe area per cell within 1e-9 of the cell area); for
out-of-box and uniaxial also the free-running JAX run's, the area within
1e-9 of the cell area and the other fields within 1e-6 of their scale
(two free-running states: see test_torch_sim.py's output test).  Then a
resumed campaign against a straight one, and a snapshot of the port's
campaign resumed in JAX.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.config as jconf
import subzero_tpu.diagnostics as jdiag
import subzero_tpu.validation as jval
from subzero_tpu.forcing import Forcing as JForcing
from subzero_tpu.sim import Simulation as JSimulation
from subzero_tpu.state import FloeState as JFloeState

import subzero_tpu_torch.campaign as camp
from subzero_tpu_torch.convert import forcing_to_numpy, state_to_numpy
from subzero_tpu_torch.sim import out_of_box_sim
from subzero_tpu_torch.validation import uniaxial_sim, winter_sim

torch.set_num_threads(1)

EVERY = 20
STEPS = {"out_of_box": 20, "uniaxial": 40, "nares": 20, "nares_export": 20,
         "winter": 20}
BUILDERS = {"out_of_box": lambda: out_of_box_sim(seed=0, n_floes=10,
                                                 device="cpu",
                                                 dtype="float64"),
            "uniaxial": lambda: uniaxial_sim(n_floes=200, seed=0,
                                             device="cpu", dtype="float64"),
            "winter": lambda: winter_sim(n_floes=100, seed=0, device="cpu",
                                         dtype="float64")}


def jax_cfg(cfg):
    """The JAX package's SimConfig with the same field values as the
    port's."""
    d = dataclasses.asdict(cfg)
    sections = {"physics": "PhysicsConfig", "contact": "ContactConfig",
                "clamps": "ClampConfig", "processes": "ProcessConfig",
                "capacity": "CapacityConfig", "numerics": "NumericsConfig",
                "domain": "DomainConfig"}
    kw = {k: getattr(jconf, c)(**d.pop(k)) for k, c in sections.items()}
    return jconf.SimConfig(**kw, **d)


def jax_twin(sim, out_dir):
    """A JAX Simulation from the port Simulation's state, config, forcing,
    walls and coefficients, writing its outputs to ``out_dir``."""
    state = JFloeState(**{k: jnp.asarray(v)
                          for k, v in state_to_numpy(sim.state).items()})
    forcing = JForcing(**{k: jnp.asarray(v)
                          for k, v in forcing_to_numpy(sim.forcing).items()})
    js = JSimulation(cfg=jax_cfg(sim.cfg), state=state, forcing=forcing,
                     modulus=sim.modulus, heat_flux=sim.heat_flux,
                     seed=sim.seed, wall_fn=sim.wall_fn,
                     output_dir=out_dir)
    return js


def cadenced(sim):
    sim.cfg = sim.cfg.replace(processes=dataclasses.replace(
        sim.cfg.processes, n_dt_out=EVERY))
    return sim


@pytest.fixture(scope="module", autouse=True)
def no_figures():
    # the figures are the plotting module's (test_torch_plotting.py)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(camp, "_can_plot", lambda: False)
        yield


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Each case's leg through the campaign: {case: summary lines}, and
    the campaign."""
    c = camp.Campaign(out=tmp_path_factory.mktemp("campaign"), device="cpu",
                      dtype="float64", n_dt_out=EVERY)
    return c, {name: camp.CASES[name](STEPS[name], c) for name in STEPS}


@pytest.mark.parametrize("name", list(STEPS))
def test_case_leg_writes_its_outputs(legs, name):
    c, lines = legs[0], legs[1][name]
    d = c.out / name
    series = np.load(d / "mass_series.npy")
    assert series.shape[1] == 4
    assert list(series[:, 0]) == list(range(EVERY, STEPS[name] + 1, EVERY))
    m0 = float(np.load(d / "m0.npy"))
    total = series[-1, 1] + series[-1, 2] + series[-1, 3]
    # winter freezes: growth adds mass; every other case conserves it
    if name != "winter":
        assert abs(total / m0 - 1.0) < 1e-9
    dist = np.load(d / "distributions.npz")
    assert sorted(dist.files) == ["fsd", "fsd_edges", "itd", "itd_edges"]
    assert 0 < dist["fsd"].sum() <= dist["itd"].sum()
    snap = d / f"snap{STEPS[name]:07d}"
    for f in ("meta.json", "state.npz", "eulerian.npz", "dissolved.npy"):
        assert (snap / f).exists(), f
    results = (c.out / "RESULTS.md").read_text()
    for line in lines:
        assert line in results
    assert lines[1].startswith(f"- steps: {STEPS[name]}, wall: ")
    assert lines[1].endswith(" steps/s, cpu)")
    assert any(x.startswith("- ledger (floes+dissolved+exported)/m0: ")
               for x in lines)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_case_leg_matches_jax(legs, name, tmp_path):
    c, lines = legs[0], legs[1][name]
    sim = cadenced(BUILDERS[name]())
    if name == "uniaxial":
        rate = max(15.0, (1e5 - 8.5e4) / max(STEPS[name] // 30, 1))
        sim.wall_fn = lambda s: (1e5, max(1e5 - rate * (s // 30), 8.5e4))
    js = jax_twin(sim, tmp_path)
    js.lifecycle.shadow_ledger = name == "uniaxial"
    js.run(STEPS[name])
    d = c.out / name
    alive = int(np.asarray(js.state.alive).sum())
    assert f"- live floes: {alive}" in lines
    np.testing.assert_allclose(np.load(d / "mass_series.npy"),
                               np.load(tmp_path / "mass_series.npy"),
                               rtol=1e-9)
    fsd, fsd_edges = jval.floe_size_distribution(js.state)
    itd, itd_edges = jval.ice_thickness_distribution(js.state)
    dist = np.load(d / "distributions.npz")
    assert np.array_equal(dist["fsd"], fsd)
    assert np.array_equal(dist["itd"], itd)
    np.testing.assert_allclose(dist["fsd_edges"], fsd_edges, rtol=1e-9)
    np.testing.assert_allclose(dist["itd_edges"], itd_edges, rtol=1e-9)
    snap = f"snap{STEPS[name]:07d}"
    eb = np.load(d / snap / "eulerian.npz")
    dom = sim.cfg.domain
    cell = (2 * dom.lx / sim.nx_coarse) * (2 * dom.ly / sim.ny_coarse)
    # the port's snapshot fields against JAX's eulerian_data on the
    # snapshot's own state, run eagerly: a floe that only touches a cell
    # has an area of ~0 whose sign XLA's fused rounding can flip under jit,
    # and the mean overlap counts the floes of positive area
    loaded = JSimulation.load(d / snap, js.cfg, js.forcing)
    with jax.disable_jit():
        want = jdiag.eulerian_data(loaded.state, loaded.cfg,
                                   sim.nx_coarse, sim.ny_coarse)._asdict()
    assert sorted(want) == sorted(eb.files)
    assert np.max(np.abs(eb["area"] - np.asarray(want["area"]))) \
        <= 1e-9 * cell
    assert float(eb["area"].max()) > 0.1 * cell
    for k, v in want.items():
        v = np.asarray(v)
        assert np.max(np.abs(eb[k] - v)) <= 1e-9 * np.abs(v).max(), k
    if name == "winter":
        # winter's boundaries reshape floes through the native boolean,
        # whose vertex lists differ between the packages in the last bits;
        # vertex capping then moves the polygons (ROADMAP §C), so its
        # free-running snapshots are not compared field by field
        return
    ea = np.load(tmp_path / snap / "eulerian.npz")
    assert np.max(np.abs(eb["area"] - ea["area"])) <= 1e-9 * cell
    for k in ea.files:
        np.testing.assert_allclose(eb[k], ea[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(ea[k]).max(),
                                   err_msg=k)


def test_resume_continues_the_straight_run(tmp_path):
    straight = camp.Campaign(out=tmp_path / "a", device="cpu",
                             dtype="float64", n_dt_out=10)
    want = camp.run_out_of_box(20, straight)
    legs = camp.Campaign(out=tmp_path / "b", device="cpu", dtype="float64",
                         n_dt_out=10)
    camp.run_out_of_box(10, legs)
    m0_path = tmp_path / "b" / "out_of_box" / "m0.npy"
    m0 = float(np.load(m0_path))
    # the resumed leg reads the baseline of step 0: halve the ledger by
    # doubling it on disk
    np.save(m0_path, 2 * m0)
    got = camp.run_out_of_box(20, dataclasses.replace(legs, resume=True))
    assert float(np.load(m0_path)) == 2 * m0
    a, b = (np.load(tmp_path / s / "out_of_box" / "snap0000020" /
                    "state.npz") for s in "ab")
    for k in ("x", "y"):
        assert np.max(np.abs(a[k] - b[k])) <= 1e-9
    sa, sb = (np.load(tmp_path / s / "out_of_box" / "mass_series.npy")
              for s in "ab")
    assert list(sb[:, 0]) == [10, 20]
    np.testing.assert_array_equal(sa, sb)

    def ledger(lines):
        key = "- ledger (floes+dissolved+exported)/m0: "
        return float(next(x for x in lines if x.startswith(key))[len(key):])

    assert ledger(got) == pytest.approx(ledger(want) / 2, rel=1e-8)
    assert want[1].startswith("- steps: 20, ") and got[1].startswith(
        "- steps: 20, ")


def test_port_snapshot_resumes_in_jax(legs):
    # the out-of-box leg's snapshot, written by the port, in JAX's
    # Simulation.load: the same fields, run state and ten more steps
    c, _ = legs
    snap = c.out / "out_of_box" / f"snap{STEPS['out_of_box']:07d}"
    sim = cadenced(BUILDERS["out_of_box"]())
    twin = jax_twin(sim, None)
    js = JSimulation.load(snap, twin.cfg, twin.forcing)
    ps = camp.Simulation.load(snap, sim.cfg, sim.forcing, device="cpu")
    assert js.step_idx == ps.step_idx == STEPS["out_of_box"]
    saved = np.load(snap / "state.npz")
    for k in saved.files:
        assert np.array_equal(np.asarray(getattr(js.state, k)), saved[k]), k
    assert (js.lifecycle.rng.bit_generator.state
            == ps.lifecycle.rng.bit_generator.state)
    js.run(10)
    ps.run(10)
    a, b = np.asarray(js.state.x), ps.state.x.numpy()
    assert np.max(np.abs(a - b)) < 1e-6


def test_float32_parity_clip_overlap_is_the_reference_s():
    # The pair behind the nares_export campaign's float32 blow-up on the
    # card (ROADMAP §C, chip_smoke.coastline_pair): the floe lies 6.6 m
    # from the coastline's 270 km edge, within the clip's float32 nudge
    # (scale x eps^(2/3) = 6.6 m), and the parity-integral clip reports an
    # overlap of more than twice the floe's area where there is none; the
    # merge pass then fuses the floe into the coastline.  The port's plain
    # version equals JAX's default "integral" clip there (chip_smoke phase
    # 2 holds the CUDA kernel to the plain version on the same pair); in
    # float64, and in the segment-midpoint clip, the overlap is 0.
    from subzero_tpu.geometry.clip import overlap_stats as j_midpoint
    from subzero_tpu.geometry.clip_integral import overlap_stats_int
    from subzero_tpu_torch.geometry.clip import overlap_stats as midpoint
    from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
    from chip_smoke import coastline_pair

    p, q = coastline_pair()
    x, y = p[0, :7].T
    floe_area = 0.5 * abs(x @ np.roll(y, -1) - y @ np.roll(x, -1))
    area = {}
    for dt in (np.float32, np.float64):
        a, b = p.astype(dt), q.astype(dt)
        area[dt] = float(clip_integral_bm(torch.from_numpy(a),
                                          torch.from_numpy(b),
                                          False).area[0])
        assert area[dt] == float(overlap_stats_int(jnp.asarray(a),
                                                   jnp.asarray(b)).area[0])
        assert float(midpoint(torch.from_numpy(a),
                              torch.from_numpy(b)).area[0]) == 0.0
        assert float(j_midpoint(jnp.asarray(a), jnp.asarray(b)).area[0]) \
            == 0.0
    assert area[np.float32] > 2 * floe_area
    assert area[np.float64] == 0.0
