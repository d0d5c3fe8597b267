"""The port's lifecycle boundary against the JAX package's, float64 on the
CPU: the host view, ``apply_edits``, and whole ``Lifecycle.step`` calls.

``extract_view`` must be identical.  ``apply_edits`` with kills, births,
updates and reshapes must match field by field: ints and bools exactly,
floats within 1e-12 of each field's scale (the port recomputes the mean
stress with its own reduction order).  The scenarios of
tests/test_lifecycle_host.py and tests/test_processes.py — fusion and
dissolve merges, ridging, rafting, fracture, corner grinding, welding
across the periodic seam, simplification and new-ice packing — run through
both ``Lifecycle.step``s with the same seed and must give identical edits
(every kill, birth polygon, mass and update bit for bit: the passes are
verbatim numpy on identical views), identical dissolved grids, exported
mass and RNG state, and states that match as above.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.processes.lifecycle as jlc
from subzero_tpu.config import (
    CapacityConfig, DomainConfig, NumericsConfig, ProcessConfig, SimConfig,
)
from subzero_tpu.forcing import thermo_params
from subzero_tpu.processes.host import (
    NewFloe, StateEdit, apply_edits, extract_view,
)
from subzero_tpu.state import state_from_polygons

import subzero_tpu_torch.processes.lifecycle as tlc
from subzero_tpu_torch.convert import state_from_numpy, state_to_numpy
from subzero_tpu_torch.processes.host import (
    NewFloe as TNewFloe, StateEdit as TStateEdit, apply_edits as t_apply,
    extract_view as t_extract,
)
from test_torch_init import jax_numpy, port_cfg

torch.set_num_threads(1)

LX = 1e5
SQ = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])


def rect(cx, cy, w, h):
    return np.array([[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
                     [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]])


DOMAIN = rect(0, 0, 2 * LX, 2 * LX)


def cfg_of(periodic=False, max_verts=32, **processes):
    return SimConfig(
        numerics=NumericsConfig(dtype="float64", dt=10.0),
        capacity=CapacityConfig(max_floes=64, max_verts=max_verts,
                                max_neighbors=4, n_mc_points=100,
                                stress_window=20),
        domain=DomainConfig(lx=LX, ly=LX),
        processes=ProcessConfig(periodic=periodic, **processes),
        min_floe_size=1e5)


def port_state(jst):
    return state_from_numpy(jax_numpy(jst), device="cpu", dtype="float64")


def assert_states_match(jst, pst, what=""):
    a, b = jax_numpy(jst), state_to_numpy(pst)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind in "biu":
            assert np.array_equal(a[k], b[k]), f"{what} {k}"
        else:
            scale = max(float(np.max(np.abs(a[k]))), 1e-300)
            d = float(np.max(np.abs(a[k] - b[k])))
            assert d <= 1e-12 * scale, f"{what} {k}: {d:.3e} of {scale:.3e}"


def assert_views_equal(va, vb):
    assert va.n == vb.n
    assert np.array_equal(va.alive, vb.alive)
    assert np.array_equal(va.nv, vb.nv)
    assert np.array_equal(va.stress, vb.stress)
    assert np.array_equal(va.strain, vb.strain)
    assert va.fields.keys() == vb.fields.keys()
    for k in va.fields:
        assert np.array_equal(va.fields[k], vb.fields[k]), k
    for p, q in zip(va.polys, vb.polys):
        assert (p is None) == (q is None)
        assert p is None or np.array_equal(p, q)


def edit_record(edit) -> dict:
    """Everything a StateEdit carries, as plain comparable values."""
    return dict(
        kills=sorted(edit.kills), dissolve_kills=sorted(edit.dissolve_kills),
        dissolve_mass=list(edit.dissolve_mass), export=edit.export_mass,
        updates={k: dict(v) for k, v in edit.updates.items()},
        reshapes={k: (np.asarray(p), m) for k, (p, m) in
                  edit.reshapes.items()},
        births=[(np.asarray(f.poly), f.h, f.mass, f.u, f.v, f.ksi, f.dx_p,
                 f.dy_p, f.du_p, f.dv_p, f.dksi_p,
                 None if f.strain is None else np.asarray(f.strain),
                 list(f.stress_blend)) for f in edit.new_floes])


def assert_edits_identical(a: dict, b: dict):
    for k in ("kills", "dissolve_kills", "dissolve_mass", "export",
              "updates"):
        assert a[k] == b[k], k
    assert a["reshapes"].keys() == b["reshapes"].keys()
    for s in a["reshapes"]:
        assert np.array_equal(a["reshapes"][s][0], b["reshapes"][s][0])
        assert a["reshapes"][s][1] == b["reshapes"][s][1]
    assert len(a["births"]) == len(b["births"])
    for x, y in zip(a["births"], b["births"]):
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                assert np.array_equal(u, v)
            else:
                assert u == v


def run_both(monkeypatch, cfg, polys, heights, step_idx, *, velocities=None,
             edit_state=None, aux=None, merge_pairs=None, lc_seed=0,
             amax=1e9, pack_h0=0.0, nxy=(10, 10), drift=None):
    """One Lifecycle.step of each package from the same numpy inputs, with
    the shadow ledger on; returns the edits (JAX's) after checking them and
    the results.  ``drift``: a list that receives JAX's ledger drift."""
    jst = state_from_polygons(polys, heights, cfg, velocities=velocities)
    if edit_state is not None:
        jst = edit_state(jst)
    pst = port_state(jst)
    assert_views_equal(extract_view(jst, cfg), t_extract(pst, port_cfg(cfg)))
    logs = {"jax": [], "port": []}
    for mod, key in ((jlc, "jax"), (tlc, "port")):
        orig = mod.apply_edits

        def rec(state, edit, c, seed=0, view=None, _o=orig, _k=key):
            logs[_k].append((edit_record(edit), seed))
            return _o(state, edit, c, seed=seed, view=view)

        monkeypatch.setattr(mod, "apply_edits", rec)
    nx, ny = nxy
    kw = dict(seed=lc_seed, amax=amax, pack_h0=pack_h0, nx=nx, ny=ny)
    jl = jlc.Lifecycle(cfg, DOMAIN, **kw)
    tl = tlc.Lifecycle(port_cfg(cfg), DOMAIN, **kw)
    jl.shadow_ledger = tl.shadow_ledger = True
    dis = np.zeros((ny, nx))
    j2, jdis, jch = jl.step(jst, aux, step_idx, dis.copy(),
                            merge_pairs=merge_pairs)
    p2, pdis, pch = tl.step(pst, aux, step_idx, dis.copy(),
                            merge_pairs=merge_pairs)
    assert jch == pch
    assert len(logs["jax"]) == len(logs["port"])
    for (ea, sa), (eb, sb) in zip(logs["jax"], logs["port"]):
        assert sa == sb
        assert_edits_identical(ea, eb)
    assert np.array_equal(jdis, pdis)
    assert jl.exported_mass == tl.exported_mass
    assert jl.rng.bit_generator.state == tl.rng.bit_generator.state
    m = float(np.sum(np.asarray(jst.mass)[np.asarray(jst.alive)]))
    assert abs(jl.ledger_drift - tl.ledger_drift) <= 1e-12 * m
    if drift is not None:
        drift.append(jl.ledger_drift)
    assert_states_match(j2, p2, "after step")
    return logs["jax"][0][0] if logs["jax"] else None, j2


def empty_aux(n, k):
    z = np.zeros((n, k))
    return SimpleNamespace(
        pair_valid=np.zeros((n, k), bool), pair_px=z.copy(),
        pair_py=z.copy(), pair_fx=z.copy(), pair_fy=z.copy(),
        pair_overlap=z.copy(), nbr_idx=np.zeros((n, k), np.int32),
        boundary_contact=np.zeros(n, bool))


def alive_count(st):
    return int(np.sum(np.asarray(st.alive)))


# -- the view and apply_edits ------------------------------------------------

def test_extract_view_identical_on_a_moved_state():
    cfg = cfg_of(periodic=True)
    rng = np.random.default_rng(0)
    polys = [rect(*rng.uniform(-9e4, 9e4, 2), *rng.uniform(5e3, 2e4, 2))
             for _ in range(20)]
    jst = state_from_polygons(polys, 0.5, cfg)
    d = {k: np.array(v) for k, v in jax_numpy(jst).items()}
    for k in ("x", "y", "u", "v", "ksi", "overlap_area", "du_p"):
        d[k] = d[k] + rng.normal(0, 10, d[k].shape)
    d["stress"] = rng.normal(0, 1e4, d["stress"].shape)
    d["alive"][3] = False
    jst = jst.replace(**{k: jnp.asarray(v) for k, v in d.items()})
    assert_views_equal(extract_view(jst, cfg),
                       t_extract(port_state(jst), port_cfg(cfg)))


def test_apply_edits_kills_births_updates_reshapes():
    cfg = cfg_of()
    polys = [rect(-5e4 + 1.5e4 * k, 0, 1e4, 1e4) for k in range(6)]
    jst = state_from_polygons(polys, 0.5, cfg,
                              velocities=np.linspace(-1, 1, 12).reshape(6, 2))
    rng = np.random.default_rng(1)
    hist = rng.normal(0, 1e3, np.asarray(jst.stress_hist).shape)
    jst = jst.replace(stress_hist=jnp.asarray(hist),
                      stress=jnp.asarray(hist.mean(axis=1)))
    pst = port_state(jst)
    edits = []
    for E, F in ((StateEdit, NewFloe), (TStateEdit, TNewFloe)):
        e = E()
        e.kills |= {1}
        e.dissolve_kills |= {4}
        e.updates = {2: {"h": 0.9, "mass": 9.2e7, "inertia": 1e15},
                     5: {"h": 0.7}}
        e.reshapes = {0: (rect(-5e4, 0, 9e3, 1.1e4), 4.2e7)}
        e.new_floes = [
            F(poly=rect(3e4, 5e4, 8e3, 6e3), h=0.4, u=0.1, v=-0.2, ksi=1e-6,
              strain=np.array([1e-6, 2e-6, 3e-6]),
              stress_blend=[(1, 0.25), (4, 0.75)]),
            F(poly=np.array([[0.0, 4e4], [1e4, 4e4], [5e3, 4.8e4]]), h=0.0,
              mass=2e7, stress_blend=[]),
        ]
        edits.append(e)
    j2 = apply_edits(jst, edits[0], cfg, seed=7)
    p2 = t_apply(pst, edits[1], port_cfg(cfg), seed=7)
    assert_states_match(j2, p2, "apply_edits")
    # the input state is left as it was
    assert_states_match(jst, pst, "input")
    assert alive_count(j2) == 6
    # updates of fields outside (h, mass, inertia) take the per-field path
    out = []
    for E, st, apply, c in ((StateEdit, jst, apply_edits, cfg),
                            (TStateEdit, pst, t_apply, port_cfg(cfg))):
        e = E()
        e.updates = {3: {"u": 0.5, "h": 0.3}, 2: {"ksi": -1e-6}}
        out.append(apply(st, e, c))
    assert_states_match(*out, "per-field updates")


def test_apply_edits_capacity_overflow_raises():
    cfg = cfg_of().replace(capacity=CapacityConfig(
        max_floes=2, max_verts=8, n_mc_points=10, stress_window=4))
    pcfg = port_cfg(cfg)
    jst = state_from_polygons([rect(0, 0, 8e3, 8e3), rect(1e4, 0, 8e3, 8e3)],
                              0.5, cfg)
    e = TStateEdit()
    e.new_floes = [TNewFloe(poly=rect(k * 1e4, 3e4, 4e3, 4e3), h=0.5)
                   for k in range(3)]
    with pytest.raises(RuntimeError, match="capacity"):
        t_apply(port_state(jst), e, pcfg)


# -- Lifecycle.step scenarios ------------------------------------------------

def test_merges_fuse_and_dissolve(monkeypatch):
    cfg = cfg_of()
    polys = [2000 * SQ, 2000 * SQ + [3000.0, 0.0],
             rect(4e4, 0, 3e3, 3e3), rect(4.2e4, 0, 80, 80)]
    edit, st = run_both(monkeypatch, cfg, polys, [0.5, 0.8, 0.5, 0.5], 3,
                        velocities=np.array([[0.2, 0], [-0.1, 0.1], [0, 0],
                                             [0.05, 0]]),
                        merge_pairs=[(1, 0), (3, 2)])
    assert edit["dissolve_kills"] == [3]
    assert len(edit["births"]) == 1 and set(edit["kills"]) >= {0, 1}
    assert alive_count(st) == 2


@pytest.mark.parametrize("mode,heights", [("ridge", [2.0, 0.5]),
                                          ("raft", [0.2, 0.15])])
def test_ridge_and_raft(monkeypatch, mode, heights):
    cfg = cfg_of(**{"ridging" if mode == "ridge" else "rafting": True})
    polys = [4000 * SQ, 4000 * SQ + [7000.0, 0.0]]

    def overlapped(st):
        # rafting keeps a floe out with probability 1 - overlap/(2 area)
        # (raft.m); the step's recorded overlap area drives it
        return st.replace(overlap_area=1.6 * st.area)

    fired = 0
    for seed in range(6):
        edit, _ = run_both(monkeypatch, cfg, polys, heights, 10,
                           aux=empty_aux(64, 4), merge_pairs=[],
                           lc_seed=seed, edit_state=overlapped)
        fired += bool(edit["updates"] or edit["reshapes"]
                      or edit["births"])
    assert fired >= 1


def test_ridge_across_periodic_seam(monkeypatch):
    cfg = cfg_of(periodic=True, ridging=True)
    polys = [rect(-LX + 2e3, 0, 1e4, 1e4), rect(LX - 2e3, 0, 1e4, 1e4)]
    edit, _ = run_both(monkeypatch, cfg, polys, [0.4, 1.0], 20, lc_seed=3,
                       aux=empty_aux(64, 4), merge_pairs=[])
    assert edit is not None and edit["updates"]


def test_fracture(monkeypatch):
    cfg = cfg_of(fractures=True)

    def stressed(st):
        stress = np.zeros((st.n, 3))
        stress[0] = [5e5, 5e5, 0.0]
        stress[1] = [-1e3, 2e3, 0.0]                 # inside the cone
        return st.replace(stress=jnp.asarray(stress))

    edit, st = run_both(monkeypatch, cfg,
                        [4000 * SQ, 4000 * SQ + [3e4, 0.0]], 0.5, 75,
                        velocities=np.array([[0.1, 0.0], [0.0, 0.1]]),
                        edit_state=stressed)
    assert edit["kills"] == [0] and len(edit["births"]) >= 2
    assert alive_count(st) >= 3


def test_corners(monkeypatch):
    cfg = cfg_of()
    poly = np.array([[0, 0], [2e4, 0], [2.6e4, 2.6e4], [1e4, 1.9e4],
                     [-0.6e4, 2.6e4]], float)
    aux = empty_aux(64, 4)
    aux.pair_valid[0, 0] = True
    aux.nbr_idx[0, 0] = 1
    aux.pair_px[0, 0], aux.pair_py[0, 0] = 1e4, 3.1e4
    aux.pair_overlap[0, 0] = 1e3
    aux.pair_valid[1, 0] = True
    aux.pair_px[1, 0], aux.pair_py[1, 0] = 1e4, 3.1e4
    fired = 0
    for seed in range(12):
        edit, _ = run_both(monkeypatch, cfg, [poly, rect(1e4, 2.7e4, 4e4,
                                                         1e4)],
                           0.5, 10, aux=aux, merge_pairs=[], lc_seed=seed)
        fired += edit is not None and 0 in edit["kills"]
    assert fired >= 1


def test_weld_across_periodic_seam(monkeypatch):
    cfg = cfg_of(periodic=True, welding=True)
    polys = ([rect(-LX + 2e3, 0, 1e4, 1e4), rect(LX - 2e3, 0, 1e4, 1e4)]
             + [rect(-5e4 + 1.4e4 * k, 6e4, 1e4, 1e4) for k in range(8)])
    fired = 0
    for seed in range(6):
        # step 5000: the 1x1 pyramid level (weld.m coarse cadence)
        edit, _ = run_both(monkeypatch, cfg, polys, 0.5, 5000,
                           lc_seed=seed, amax=1e9)
        fired += edit is not None and edit["kills"] == [0, 1]
    assert fired >= 1


def test_simplify(monkeypatch):
    cfg = cfg_of()
    cfg = cfg.replace(processes=dataclasses.replace(
        cfg.processes, simplify_max_verts=20))
    sq = rect(0, 0, 4e4, 4e4)
    rng = np.random.default_rng(1)
    pts = []
    for k in range(4):
        a, b = sq[k], sq[(k + 1) % 4]
        for t in np.linspace(0, 1, 8, endpoint=False):
            nrm = (b - a)[::-1] * [1, -1] / np.linalg.norm(b - a)
            pts.append(a + t * (b - a) + nrm * rng.uniform(-5, 5))
    edit, st = run_both(monkeypatch, cfg,
                        [np.asarray(pts), rect(3e4, 0, 3e4, 1e4)], 0.5, 20,
                        aux=empty_aux(64, 4), merge_pairs=[])
    assert 0 in edit["reshapes"]
    assert int(np.asarray(st.nv)[0]) < 32


def test_pack(monkeypatch):
    cfg = cfg_of(packing=True)
    heat, h0 = thermo_params(10.0, cfg.processes.n_pack)
    cfg = cfg.replace(heat_flux=heat)
    polys = [rect(-6e4, -6e4, 3e4, 3e4), rect(2e4, 4e4, 5e4, 2e4),
             rect(7e4, -5e4, 2e4, 2e4)]
    edit, st = run_both(monkeypatch, cfg, polys, 0.5, 500, pack_h0=h0,
                        nxy=(4, 4))
    assert len(edit["births"]) > 0
    assert alive_count(st) > 3


def test_ridge_gain_lost_when_the_winner_is_simplified(monkeypatch):
    # A fault of the reference (ROADMAP §C), kept for parity: a ridge
    # winner's gained mass is an update, and Lifecycle._guarded hides only
    # killed and reshaped slots from later passes, so simplify reshapes the
    # winner from the view's pre-ridge mass and the gain is lost.  Both
    # packages lose exactly the winner's gain (shadow ledger).
    cfg = cfg_of(ridging=True)
    sq = rect(0, 0, 4e4, 4e4)
    pts = [sq[k] + t * (sq[(k + 1) % 4] - sq[k]) for k in range(4)
           for t in np.linspace(0, 1, 8, endpoint=False)]
    winner = np.asarray(pts)                     # 32 vertices > 30
    loser = rect(2.4e4, 0, 1e4, 1e4)             # 2e3 m into the winner
    fired = 0
    for seed in range(6):
        drift = []
        edit, _ = run_both(monkeypatch, cfg, [winner, loser], [1.0, 0.1],
                           20, aux=empty_aux(64, 4), merge_pairs=[],
                           lc_seed=seed, drift=drift)
        if 0 in edit["updates"] and 0 in edit["reshapes"]:
            fired += 1
            gain = edit["updates"][0]["mass"] - edit["reshapes"][0][1]
            assert gain > 0
            assert drift[0] == pytest.approx(-gain, rel=1e-9)
    assert fired >= 1
