"""The Nares configuration on the CPU: its builder against the port's own
recipe (``validation.py:nares_sim``), the coastline's slots for every
seed, the start-state file, and a tiny cell run through the harness.

The tiny cell is 36 floes of the published domain in float64 (under
"integral", the float64 clip), started from a state this file writes: the
published field at rest, moved south until a floe overlaps the
coastline, and set drifting south at 5-8 cm/s.  That state is a
construction of these tests only; the real cell starts from a state the
recipe reached (``configs/nares_start.py``)."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import BENCH, make_root

from benchlib import runner
from benchlib.catalog import Catalog

torch.set_num_threads(1)

NB = 2
TINY_TRAFFIC = {"n_floes": 36, "layout_seed": 20261020, "start_step": 140,
                "segment_steps": 20, "check_steps": 2, "check_floes": 12}


def builder():
    cat = Catalog(BENCH)
    conf = cat.config("nares")
    return cat.builder(conf), conf


def inside(pts, poly):
    """Points strictly inside a simple polygon (even-odd ray casting)."""
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x0, y0 = poly[:, 0][None], poly[:, 1][None]
    x1, y1 = np.roll(poly[:, 0], -1)[None], np.roll(poly[:, 1], -1)[None]
    cross = ((y0 > y) != (y1 > y)) & (
        x < x0 + (y - y0) * (x1 - x0) / np.where(y1 == y0, 1.0, y1 - y0))
    return cross.sum(axis=1) % 2 == 1


def jammed_start(path: Path, seed: int):
    """The published field at rest, moved south in 100 m steps until a
    floe has a vertex inside the coastline, drifting south at 5-8 cm/s
    with no history: a test-only start state at step 140."""
    b, conf = builder()
    inp = b.make_inputs(conf["recipe"], TINY_TRAFFIC, seed)
    coast, free = inp.polys[:NB], inp.polys[NB:]
    for k in range(1, 5000):
        moved = [p - np.array([0.0, 100.0 * k]) for p in free]
        if any(inside(p, c).any() for p in moved for c in coast):
            break
    n = len(moved)
    w = int(conf["recipe"]["stress_window"])
    z = np.zeros(n)
    fields = {f: z for f in b.START_FIELDS}
    fields.update(h=inp.heights[NB:], v=-0.05 - 1e-3 * np.arange(n),
                  stress_hist=np.zeros((n, w, 3)), stress=np.zeros((n, 3)),
                  strain=np.zeros((n, 3)))
    b.write_start(path, TINY_TRAFFIC["start_step"], moved, fields,
                  shift_m=100.0 * k)
    return moved, fields


@pytest.fixture(scope="module")
def nares_root(tmp_path_factory):
    """A root with the configuration ``nares-f64`` (the recipe in float64
    under "integral") and the cell ``nares-tiny``, limited as the float64
    cell uniaxial-10k is."""
    tmp = tmp_path_factory.mktemp("nares")
    start = tmp / "start.npz"
    jammed_start(start, 20261020)
    traffic = dict(TINY_TRAFFIC, start_state=str(start))
    root = make_root(tmp, cells={"nares-tiny": {
        "config": "nares-f64", "traffic": traffic,
        "limits_of": "uniaxial-10k"}})
    (root / "configs").unlink()
    (root / "configs").mkdir()
    for p in (BENCH / "configs").iterdir():
        (root / "configs" / p.name).symlink_to(p)
    conf = json.loads((BENCH / "configs" / "nares.json").read_text())
    conf["name"] = "nares-f64"
    conf["recipe"].update(dtype="float64", contact_impl="integral")
    (root / "configs" / "nares-f64.json").write_text(json.dumps(conf))
    return root


@pytest.fixture(scope="module")
def tiny_run(nares_root):
    """One run of the tiny cell: its checks, the control's numbers, and
    the coast-pair metric read from the last timed segment."""
    cat = Catalog(nares_root)
    r = runner.Run("nares-tiny", 2**31 + 11, 0.0, False, device="cpu",
                   catalog=cat, log=lambda m: None)
    try:
        r.setup()
        r.window()
        r.hooks.recorder.active = False
        checks = r.check()
        control = r.control()
    finally:
        r.hooks.uninstall()
    ctx = dict(run=r, phase=r.phase, passes=r.passes, marks=None,
               profile=None, steps=r.timed_steps)
    coast = cat.readers()["contact.coast_pairs_per_step"].read(ctx)
    return r, checks, control, coast


def test_builder_is_the_ports_recipe():
    """At step 0 the builder's coastline, processes, physics, forcing and
    sizes are ``nares_sim``'s, its contact clip the configuration's."""
    from subzero_tpu_torch.validation import nares_sim, nares_topography

    b, conf = builder()
    traffic = {"n_floes": 150, "layout_seed": 5}
    sim, inp = b.build(conf["recipe"], traffic, 5, torch.device("cpu"))
    ref = nares_sim(seed=5, device="cpu")
    topo = nares_topography(5e4, 3.75e5, channel_top=-1.25e5,
                            channel_bot=-2.75e5)
    for got, want in zip(inp.polys[:NB], topo):
        np.testing.assert_array_equal(got, want)
    for part in ("processes", "physics", "domain"):
        assert getattr(sim.cfg, part) == getattr(ref.cfg, part), part
    assert sim.cfg.n_boundary == ref.cfg.n_boundary == NB
    assert sim.cfg.min_floe_size == ref.cfg.min_floe_size
    assert sim.cfg.numerics.dt == ref.cfg.numerics.dt
    assert sim.cfg.numerics.contact_impl == "pallas"
    for f in ("x0", "y0", "dx", "uo", "vo", "ua", "va"):
        torch.testing.assert_close(getattr(sim.forcing, f),
                                   getattr(ref.forcing, f), rtol=0, atol=0)
    # the modulus over the free floes alone, as nares_sim takes it
    areas = sim.state.area[NB:len(inp.polys)].double().numpy()
    r = np.sqrt(areas)
    assert inp.modulus == pytest.approx(1.5e3 * (r.mean() + r.min()),
                                        rel=1e-6)
    assert sim.state.area[:NB].min() > 6e9


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3, 2**40 + 1])
def test_every_seed_keeps_the_coastline_below_n_boundary(nares_root, seed):
    cat = Catalog(nares_root)
    cell = cat.cell("nares-tiny")
    conf = cat.config("nares-f64")
    b = cat.builder(conf)
    sim, inp = b.build(conf["recipe"], cell["traffic"], seed,
                       torch.device("cpu"))
    base, _ = b.build(conf["recipe"], cell["traffic"], 0,
                      torch.device("cpu"))
    st, st0 = sim.state, base.state
    n = len(inp.polys)
    assert sim.cfg.n_boundary == NB and sim.step_idx == 140
    for k in ("x", "y", "area", "u", "v"):
        torch.testing.assert_close(getattr(st, k)[:NB], getattr(st0, k)[:NB])
    assert float(st.area[:NB].min()) > 6e9
    assert not bool(st.u[:NB].any()) and not bool(st.v[:NB].any())
    # the free floes are the same set, in the seed's order
    key = lambda s: sorted(zip(s.x[NB:n].tolist(), s.y[NB:n].tolist()))  # noqa: E731
    assert key(st) == key(st0)


def test_start_state_round_trips(nares_root, tmp_path):
    b, _ = builder()
    moved, fields = jammed_start(tmp_path / "s.npz", 20261020)
    step, polys, got, meta = b.read_start(tmp_path / "s.npz")
    assert step == 140 and float(meta["shift_m"]) > 0
    assert len(polys) == len(moved)
    for p, q in zip(polys, moved):
        np.testing.assert_array_equal(p, q)
    for f in b.START_FIELDS:
        np.testing.assert_array_equal(got[f], fields[f])
    # and through the builder: the state's polygons and velocities, in the
    # seed's order
    cat = Catalog(nares_root)
    cell = cat.cell("nares-tiny")
    conf = cat.config("nares-f64")
    sim, inp = cat.builder(conf).build(conf["recipe"], cell["traffic"], 99,
                                       torch.device("cpu"))
    st = sim.state
    world = st.verts_world().numpy()
    nv = st.nv.numpy()
    for k, p in enumerate(inp.polys):
        w = world[k, :nv[k]]
        scale = np.abs(p).max()
        assert np.abs(w - p).max() <= 1e-9 * scale, k
    order = np.random.default_rng([99, 3]).permutation(len(moved))
    n = len(inp.polys)
    np.testing.assert_array_equal(st.v[NB:n].numpy(), fields["v"][order])
    np.testing.assert_array_equal(st.u[NB:n].numpy(), 0.0)


def test_sound_run_is_correct_and_the_control_is_not(tiny_run):
    _, checks, control, _ = tiny_run
    limited = {n: (v, lim) for n, (v, lim) in checks.items()
               if lim is not None}
    assert limited
    for n, (v, lim) in limited.items():
        assert math.isfinite(v) and v <= lim, (n, v, lim)
    assert any(control[n] > lim for n, (_, lim) in limited.items()), control


def test_coast_pairs_per_step_is_positive(tiny_run):
    r, _, _, coast = tiny_run
    assert coast is not None and coast > 0
    assert r.end.phase_times.counts["contact.coast_pairs"] == coast * 20


def test_coast_pairs_metric_is_silent_without_a_coastline_or_a_count():
    from types import SimpleNamespace

    read = Catalog(BENCH).readers()["contact.coast_pairs_per_step"].read
    cfg = SimpleNamespace(n_boundary=NB)
    end = SimpleNamespace(phase_times=SimpleNamespace(counts={}))
    run = SimpleNamespace(start=SimpleNamespace(cfg=cfg), end=end, n_seg=10)
    assert read(dict(run=run)) is None
    end.phase_times.counts["contact.coast_pairs"] = 30
    assert read(dict(run=run)) == 3.0
    cfg.n_boundary = 0
    assert read(dict(run=run)) is None


def test_start_script_takes_each_free_floes_world_polygon(nares_root):
    """``nares_start.live_free_floes`` on a built start state gives back
    the stored polygons (alpha 0 there) and fields, coastline left out."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "nares_start", BENCH / "configs" / "nares_start.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cat = Catalog(nares_root)
    conf = cat.config("nares-f64")
    b = cat.builder(conf)
    sim, inp = b.build(conf["recipe"], cat.cell("nares-tiny")["traffic"], 4,
                       torch.device("cpu"))
    polys, fields = mod.live_free_floes(sim, b.START_FIELDS)
    assert len(polys) == len(inp.polys) - NB
    for p, q in zip(polys, inp.polys[NB:]):
        assert np.abs(p - q).max() <= 1e-9 * np.abs(q).max()
    np.testing.assert_array_equal(fields["v"], inp.start["v"])
