"""The port's Eulerian diagnostics, coverage, dissolved-mass binning and
dissolved-ice advection against the JAX package's, float64 on the CPU.

The port keeps one reduction path (each floe clipped against its window of
cells, through the segment-midpoint clip); the JAX package has two, the
host-windowed scatter (a concrete call) and the dense block path (under a
trace).  The port must equal both: ``exact_boundary=True`` against the
concrete call, ``exact_boundary=False`` against the traced one (which
subtracts the per-floe boundary areas instead of their union).  Every field
within 1e-9 of its largest magnitude.  States: periodic with floes across
the seam, walled with floes across the walls, topography floes
(``n_boundary > 0``) that overlap each other, and the t=0 Voronoi field,
whose floe edges lie on the Eulerian cell edges.  Last, the port driver's
mass ledger (floes + dissolved + exported) over 1000 thermo-off steps,
within 1e-9 relative, and the reference's area loss next to cell edges,
which the port reproduces.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.diagnostics as jdiag
from subzero_tpu.config import (
    CapacityConfig, DomainConfig, NumericsConfig, ProcessConfig, SimConfig,
)
from subzero_tpu.dissolved import advect_dissolved
from subzero_tpu.forcing import gyre_ocean
from subzero_tpu.init import initial_state
from subzero_tpu.state import state_from_polygons

import subzero_tpu_torch.diagnostics as tdiag
from subzero_tpu_torch.convert import (
    forcing_from_numpy, state_from_numpy, state_to_numpy,
)
from subzero_tpu_torch.dissolved import advect_dissolved as t_advect
from test_torch_init import jax_numpy, port_cfg

torch.set_num_threads(1)

TOL = 1e-9


def close(a, b, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(a))), 1e-300)
    d = float(np.max(np.abs(a - b)))
    assert d <= TOL * scale, f"{what}: max|d| {d:.3e} vs scale {scale:.3e}"


def stirred(jst, seed):
    """The state with seeded random kinematics, stresses, strains, overlap
    areas and rotations in every slot, so each Eulerian field is non-trivial
    (the slots' polygons and masses are kept)."""
    rng = np.random.default_rng(seed)
    d = jax_numpy(jst)
    n = d["x"].shape[0]
    for k in ("u", "v", "du_p", "dv_p"):
        d[k] = rng.normal(0, 0.1, n)
    d["alpha"] = rng.uniform(-0.3, 0.3, n)
    d["h"] = d["h"] * rng.uniform(0.5, 1.5, n)
    d["stress"] = rng.normal(0, 1e4, (n, 3))
    d["strain"] = rng.normal(0, 1e-6, (n, 3))
    d["overlap_area"] = rng.uniform(0, 1e6, n)
    return jst.replace(**{k: jnp.asarray(v) for k, v in d.items()})


def rect(cx, cy, w, h):
    return np.array([[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
                     [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]])


def cfg_for(periodic, n_boundary=0, max_floes=64):
    return SimConfig(
        numerics=NumericsConfig(dtype="float64"),
        capacity=CapacityConfig(max_floes=max_floes, max_verts=16,
                                n_mc_points=16, stress_window=8),
        domain=DomainConfig(lx=1e5, ly=8e4),
        processes=ProcessConfig(periodic=periodic),
        n_boundary=n_boundary)


def scattered(cfg, seed, n=30):
    """Seeded concave and convex floes over the whole domain, several across
    its edges (the seam when periodic, the walls when not)."""
    rng = np.random.default_rng(seed)
    lx, ly = cfg.domain.lx, cfg.domain.ly
    polys = []
    for k in range(n):
        c = rng.uniform([-lx, -ly], [lx, ly])
        if k % 5 == 0:                      # straddle an edge
            c[k % 2] = (lx, ly)[k % 2] * rng.choice([-1, 1]) * 0.98
        m = 2 * int(rng.integers(3, 7))
        th = np.linspace(0, 2 * np.pi, m + 1)[:-1]
        r = rng.uniform(4e3, 1.4e4) * np.where(
            np.arange(m) % 2 == 0, 1.0, rng.uniform(0.5, 1.0))
        polys.append(np.stack([c[0] + r * np.cos(th), c[1] + r * np.sin(th)],
                              1))
    return polys


def topo_cfg_state():
    cfg = cfg_for(False, n_boundary=3)
    b1 = rect(-7e4, -5e4, 4e4, 4e4)
    b2 = b1 + [2e4, 0]                      # overlaps b1 by 2e4 x 4e4
    b3 = rect(6e4, 5e4, 3e4, 2e4)
    polys = [b1, b2, b3] + scattered(cfg, 3, n=20)
    return cfg, state_from_polygons(polys, 0.7, cfg)


def voronoi_cfg_state():
    # a 2x2 target-concentration grid: the Voronoi floes' edges lie on
    # x = 0, y = 0 and the domain edges, which are Eulerian cell edges
    cfg = cfg_for(True)
    st, _ = initial_state(cfg, np.array([[1.0, 1.0], [1.0, 1.0]]), 24,
                          0.3, seed=4)
    return cfg, st


def case(name):
    if name == "periodic":
        cfg = cfg_for(True)
        return cfg, stirred(state_from_polygons(scattered(cfg, 1), 0.5, cfg),
                            1)
    if name == "walled":
        cfg = cfg_for(False)
        return cfg, stirred(state_from_polygons(scattered(cfg, 2), 0.5, cfg),
                            2)
    if name == "topography":
        cfg, st = topo_cfg_state()
        return cfg, stirred(st, 3)
    if name == "voronoi t=0":
        return voronoi_cfg_state()
    raise KeyError(name)


CASES = ["periodic", "walled", "topography", "voronoi t=0"]


def port_state(jst):
    return state_from_numpy(jax_numpy(jst), device="cpu", dtype="float64")


def assert_eulerian_close(jeul, peul, what):
    for k in jeul._fields:
        close(getattr(jeul, k), getattr(peul, k).numpy(), f"{what} {k}")


@pytest.mark.parametrize("name", CASES)
def test_eulerian_data_matches_both_jax_paths(name):
    cfg, jst = case(name)
    pcfg, pst = port_cfg(cfg), port_state(jst)
    nx, ny = (4, 4) if name == "voronoi t=0" else (7, 5)
    concrete = jdiag.eulerian_data(jst, cfg, nx, ny)
    traced = jax.jit(lambda s: jdiag.eulerian_data(s, cfg, nx, ny))(jst)
    exact = tdiag.eulerian_data(pst, pcfg, nx, ny)
    assert_eulerian_close(concrete, exact, f"{name} concrete")
    assert_eulerian_close(
        traced, tdiag.eulerian_data(pst, pcfg, nx, ny, exact_boundary=False),
        f"{name} traced")
    if cfg.n_boundary == 0:
        assert_eulerian_close(traced, exact, f"{name} traced vs exact")
    assert float(exact.c.max()) > 0.3
    # the window the driver passes for a chunk gives the same fields
    win = tdiag.cell_window(pst, pcfg, nx, ny)
    assert_eulerian_close(concrete, tdiag.eulerian_data(pst, pcfg, nx, ny,
                                                        window=win), name)


def test_voronoi_concentration_is_exact_on_cell_edges():
    # full concentration: every cell of the t=0 field is covered once, so
    # the concentration is 1 to rounding in each Eulerian cell whose edges
    # the floe edges run along
    cfg, jst = voronoi_cfg_state()
    cfg = dataclasses.replace(cfg, min_floe_size=0.0)
    c = tdiag.eulerian_data(port_state(jst), port_cfg(cfg), 2, 2).c.numpy()
    np.testing.assert_allclose(c, np.asarray(
        jdiag.eulerian_data(jst, cfg, 2, 2).c), rtol=TOL)


@pytest.mark.parametrize("name", CASES)
def test_coverage_fraction_matches_jax(name):
    cfg, jst = case(name)
    close(jdiag.coverage_fraction(jst, cfg, 6, 9),
          tdiag.coverage_fraction(port_state(jst), port_cfg(cfg), 6, 9),
          name)


def test_boundary_union_and_cell_grid_match_jax():
    cfg, jst = topo_cfg_state()
    cells, centers, area = jdiag.cell_grid(cfg, 3, 2)
    tcells, tcenters, tarea = tdiag.cell_grid(port_cfg(cfg), 3, 2)
    assert np.array_equal(np.asarray(cells), tcells)
    assert np.array_equal(np.asarray(centers), tcenters)
    assert area == tarea
    got = tdiag._boundary_union_cell_areas(port_state(jst), port_cfg(cfg),
                                           tcells, 3).numpy()
    assert np.array_equal(np.asarray(jdiag._boundary_union_cell_areas(
        jst, cfg, cells, 3)), got)
    # the union, not the per-floe sum: the south-west cell (x < -1e5/3,
    # y < 0) holds x in [-9e4, -1e5/3] of the 4e4-tall union
    assert abs(got.reshape(2, 3)[1, 0] - (9e4 - 1e5 / 3) * 4e4) < 1e-3


def test_dissolved_mass_grid_and_total_mass_match_jax():
    cfg = cfg_for(False)
    jst = state_from_polygons(scattered(cfg, 5), 0.5, cfg)
    pst = port_state(jst)
    killed = np.random.default_rng(5).random(jst.n) < 0.5
    got = tdiag.dissolved_mass_grid(pst, torch.from_numpy(killed),
                                    port_cfg(cfg), 8, 6).numpy()
    want = np.asarray(jdiag.dissolved_mass_grid(jst, jnp.asarray(killed),
                                                cfg, 8, 6))
    close(want, got, "dissolved")
    assert got.sum() > 0
    assert float(tdiag.total_mass(pst)) == pytest.approx(
        float(jdiag.total_mass(jst)), rel=1e-15)


def test_advect_dissolved_matches_jax():
    cfg = cfg_for(False)
    fj = gyre_ocean(lx=4e5, transport=2e4)     # float32, as the driver's
    fp = forcing_from_numpy(jax_numpy(fj), device="cpu", dtype="float32")
    rng = np.random.default_rng(6)
    vd = rng.uniform(0, 1e9, (6, 8))
    tend = rng.normal(0, 1e4, (6, 8))
    jv, jt = jnp.asarray(vd), jnp.asarray(tend)
    pv, pt = torch.from_numpy(vd), torch.from_numpy(tend)
    for _ in range(20):
        jv, jt = advect_dissolved(jv, jt, fj, cfg, 10.0, 8, 6)
        pv, pt = t_advect(pv, pt, fp, port_cfg(cfg), 10.0, 8, 6)
        close(jv, pv.numpy(), "vd")
        close(jt, pt.numpy(), "tendency")
    assert float(pv.min()) >= 0.0


def test_mass_ledger_closes_over_1000_steps():
    # tests/test_ledger.py's run (thermo off: heat_flux 0, corner grinding,
    # simplification and contact merges on) at 8 floes with 16-slot pools
    # and a 16-vertex cap, so that 1000 plain-PyTorch steps fit the CPU
    # budget; births above the cap are truncated conserving area, and the
    # ledger sets their mass explicitly.  floes + dissolved + exported must
    # stay within 1e-9 of the initial mass.
    from subzero_tpu_torch.config import (
        CapacityConfig as TCap, NumericsConfig as TNum, SimConfig as TSim,
    )
    from subzero_tpu_torch.forcing import gyre_ocean as t_gyre
    from subzero_tpu_torch.init import initial_state as t_initial_state
    from subzero_tpu_torch.sim import Simulation as TSimulation

    cfg = TSim(capacity=TCap(max_floes=16, max_neighbors=8, max_verts=16),
               numerics=TNum(dtype="float64"))
    st, modulus = t_initial_state(cfg, 1.0, 8, 0.25, seed=0, device="cpu")
    sim = TSimulation(cfg=cfg, state=st, forcing=t_gyre(device="cpu"),
                      modulus=modulus)
    m0 = sim.total_mass()
    worst = 0.0
    for _ in range(10):
        sim.run(100)
        tot = (sim.total_mass() + float(np.sum(sim.dissolved))
               + sim.lifecycle.exported_mass)
        worst = max(worst, abs(tot - m0) / m0)
    assert worst < 1e-9, f"ledger drift {worst:.3e}"
    assert sim.lifecycle.pass_times["corners"] > 0
    assert int(sim.state.alive.sum()) > 8          # corner pieces were born


def test_eulerian_area_loss_is_the_reference_s():
    # A fault of the reference, kept in the port for parity (ROADMAP §C):
    # two steps into the out-of-box recipe (seed 1, corners off) the floes
    # along the walls still lie almost on the Eulerian cell edges, and the
    # segment-midpoint clip (geometry/clip.py _overlap_one in both
    # packages) misses millions of m^2 of a 4e8 m^2 cell against the native
    # engine's exact floe∩cell areas; how much depends on the frame each
    # path clips in.  The port's fields equal JAX's concrete ones, and with
    # exact_boundary=False its traced ones, within 1e-9 of the cell area,
    # and all four miss the exact areas by more than 1e6 m^2.
    from subzero_tpu.native import poly_area, poly_boolean
    from subzero_tpu.state import FloeState
    from subzero_tpu_torch.config import ProcessConfig as TProc
    from subzero_tpu_torch.sim import out_of_box_sim

    sim = out_of_box_sim(seed=1, device="cpu", dtype="float64")
    sim.cfg = sim.cfg.replace(processes=TProc(corners=False))
    sim.run(2)
    pst, pcfg = sim.state, sim.cfg
    jcfg = SimConfig(capacity=CapacityConfig(
        max_floes=pcfg.capacity.max_floes,
        active_verts=pcfg.capacity.active_verts),
        numerics=NumericsConfig(dtype="float64"),
        processes=ProcessConfig(corners=False))
    d = state_to_numpy(pst)
    jst = FloeState(**{k: jnp.asarray(v) for k, v in d.items()})
    cells, _, cell_area = tdiag.cell_grid(pcfg, 10, 10)
    vw = pst.verts_world().numpy()
    nv, alive = d["nv"], d["alive"]
    exact = np.array([sum(poly_area(r) for i in np.nonzero(alive)[0]
                          for r in poly_boolean(vw[i, :nv[i]], cells[c],
                                                "int"))
                      for c in range(100)]).reshape(10, 10)
    port = tdiag.eulerian_data(pst, pcfg, 10, 10).area.numpy()
    port_traced = tdiag.eulerian_data(pst, pcfg, 10, 10,
                                      exact_boundary=False).area.numpy()
    concrete = np.asarray(jdiag.eulerian_data(jst, jcfg, 10, 10).area)
    traced = np.asarray(jax.jit(
        lambda s: jdiag.eulerian_data(s, jcfg, 10, 10))(jst).area)
    assert np.max(np.abs(port - concrete)) < 1e-9 * cell_area
    assert np.max(np.abs(port_traced - traced)) < 1e-9 * cell_area
    for got in (port, port_traced, concrete, traced):
        assert np.max(np.abs(got - exact)) > 1e6
