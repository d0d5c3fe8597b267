"""The driver's coastline and export counts (``contact.coast_pairs``,
``step.exported_floes`` in ``Simulation.phase_times.counts``), read from
the chunk summary's one device->host copy, on tiny float64 CPU runs: a
coastline strip (a static floe, ``n_boundary`` 1) with a floe pressed on
it and a floe pressed on that one, the same floes without a coastline,
and a floe pushed past the southern wall under the export rule."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import subzero_tpu_torch.sim as simmod
from subzero_tpu_torch.chunk_io import Summary, read_summary
from subzero_tpu_torch.config import (
    CapacityConfig, DomainConfig, NumericsConfig, PhysicsConfig,
    ProcessConfig, SimConfig,
)
from subzero_tpu_torch.forcing import uniform_forcing
from subzero_tpu_torch.sim import Simulation
from subzero_tpu_torch.state import state_from_polygons

torch.set_num_threads(1)

L = 2e4


def box(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)


# a coastline strip along the southern wall; floe A overlaps it by 100 m,
# floe B overlaps A by 100 m, floe C touches nothing
COAST = box(-L, -L, L, -1.5e4)
FLOES = [box(-1e3, -1.51e4, 1e3, -1.31e4), box(-1e3, -1.32e4, 1e3, -1.12e4),
         box(8e3, 5e3, 1e4, 7e3)]
# lowest vertex 500 m below the southern wall, centroid inside the domain
BELOW = box(-1.5e4, -L - 500.0, -1.3e4, -1.8e4)


def tiny_sim(polys, n_boundary=0, kill_below_ymin=False):
    cfg = SimConfig(
        physics=PhysicsConfig(ocean_coupling=False),
        processes=ProcessConfig(collision=True, fractures=False,
                                corners=False,
                                kill_below_ymin=kill_below_ymin),
        numerics=NumericsConfig(dt=10.0, dtype="float64"),
        domain=DomainConfig(lx=L, ly=L),
        capacity=CapacityConfig(max_floes=8, max_verts=8, max_neighbors=4,
                                n_mc_points=50, stress_window=10),
        n_boundary=n_boundary,
    )
    st = state_from_polygons(polys, np.ones(len(polys)), cfg, seed=1,
                             device="cpu")
    return Simulation(cfg=cfg, state=st,
                      forcing=uniform_forcing(lx=4 * L, dx=L / 2,
                                              dtype=torch.float64,
                                              device="cpu"),
                      modulus=1e7, seed=1)


def steps_seen(monkeypatch):
    """Every step's StepAux, in order, as the driver's step returns it."""
    seen = []
    step0 = simmod.physics_step

    def step(*a, **kw):
        out, aux = step0(*a, **kw)
        seen.append(aux)
        return out, aux

    monkeypatch.setattr(simmod, "physics_step", step)
    return seen


def test_coast_pairs_count_the_steps_own_floe_vs_coast_pairs(monkeypatch):
    seen = steps_seen(monkeypatch)
    sim = tiny_sim([COAST] + FLOES, n_boundary=1)
    sim.run(12)
    assert len(seen) == 12
    want = sum(int((a.pair_valid & (a.nbr_idx < 1)).sum()) for a in seen)
    assert want >= 12            # floe A rests on the coast every step
    assert sim.phase_times.counts["contact.coast_pairs"] == want
    assert all(int(a.n_coast_pairs) == int(
        (a.pair_valid & (a.nbr_idx < 1)).sum()) for a in seen)
    # the floe-floe contact (A, B) counts in n_collisions, not here
    assert all(int(a.n_collisions) > int(a.n_coast_pairs) for a in seen)
    assert sim.phase_times.counts["step.exported_floes"] == 0


def test_coast_pairs_are_zero_without_boundary_floes(monkeypatch):
    seen = steps_seen(monkeypatch)
    sim = tiny_sim(FLOES)
    sim.run(12)
    assert any(bool(a.pair_valid.any()) for a in seen)
    assert sim.phase_times.counts["contact.coast_pairs"] == 0
    assert all(int(a.n_coast_pairs) == 0 for a in seen)


def test_exported_floes_count_a_floe_past_the_southern_wall(monkeypatch):
    seen = steps_seen(monkeypatch)
    sim = tiny_sim(FLOES + [BELOW], kill_below_ymin=True)
    sim.run(5)
    assert bool(seen[0].exported[3]) and not bool(sim.state.alive[3])
    assert sum(int(a.exported.sum()) for a in seen) == 1
    assert sim.phase_times.counts["step.exported_floes"] == 1
    assert sim.lifecycle.exported_mass == pytest.approx(
        920.0 * 2e3 * 2.5e3, rel=1e-9)
    # without the rule the floe stays
    sim = tiny_sim(FLOES + [BELOW])
    sim.run(5)
    assert sim.phase_times.counts["step.exported_floes"] == 0
    assert bool(sim.state.alive[3])


def test_summary_keeps_its_entries_with_the_counts_inserted():
    """Every summary field, read by name from the chunk's one vector,
    against the chunk's own outputs; then the per-step export slots."""
    sim = tiny_sim([COAST] + FLOES + [BELOW], n_boundary=1,
                   kill_below_ymin=True)
    sim.run(0)
    n = 7
    dis = torch.as_tensor(sim.dissolved, dtype=torch.float64)
    st0 = sim.state
    state, _, _, _, chunk, summary = sim._run_chunk(
        st0, 0, n, dis, None, None, sim._domain)
    s = read_summary(summary.numpy())
    last = chunk.last
    exp_steps = [float(torch.where(a, st0.mass, 0.0).sum())
                 for a in chunk.exported]
    want = Summary(
        merge_any=bool(chunk.merge_i.any()),
        region_overflow=int(chunk.region_overflow.sum()),
        region_pool_need=int(chunk.region_pool_need.max()),
        n_collisions=int(chunk.n_collisions.max()),
        any_oversize=bool(torch.any(state.alive & (
            state.nv > sim.cfg.processes.simplify_max_verts))),
        any_contact=bool(torch.any(last.pair_valid)
                         | torch.any(last.boundary_contact)),
        any_pair_overlap=bool(torch.any(last.overlap_area > 0)),
        nbr_overflow=bool(chunk.nbr_overflow.any()),
        nbr_demand=int(chunk.nbr_demand.max()),
        pair_pool_overflow=int(chunk.pair_pool_overflow.sum()),
        pair_pool_need=int(chunk.pair_pool_need.max()),
        max_nv=int(torch.max(torch.where(state.alive, state.nv, 0))),
        coast_pairs=int(chunk.n_coast_pairs.sum()),
        exported_floes=int(chunk.exported.sum()),
        export_slots=None)
    for f in Summary._fields[:-1]:
        got = getattr(s, f)
        assert type(got) is type(getattr(want, f)), f
        assert got == pytest.approx(getattr(want, f), rel=1e-12), f
    assert s.coast_pairs >= n and s.exported_floes == 1
    assert len(s.export_slots) == sim._chunk
    assert list(s.export_slots[:n]) == pytest.approx(exp_steps, rel=1e-12)
    assert not s.export_slots[n:].any()
    assert s.exported_mass == pytest.approx(sum(exp_steps), rel=1e-12)
