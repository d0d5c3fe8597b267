"""The port's 1-D slab decomposition (``subzero_tpu_torch.parallel``) on 2
and 4 gloo ranks against JAX's ``make_spatial_step`` on a mesh of as many
CPU devices, float64: ``tests/test_spatial.py``'s cases (the 20-step
equivalence run, a cross-stripe collision, migration, the periodic seam,
the overlapped halo against the serialized exchange, the flagged band
ghost overflow) and the 1,024-floe ``dryrun_multichip`` pack.

The ranks are subprocesses of this file (``torch_ranks``), launched once
per world size from a module fixture that runs every scenario; JAX runs in
the test process meanwhile.  Live rows are compared sorted: positions
within 1e-6 m, velocities within 1e-9 m/s, and per step the same collision
count, overflow flags and demands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

if __name__ != "__main__":
    import torch_ranks

SQ = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
TOL_POS = 1e-6       # m
TOL_VEL = 1e-9       # m/s


def spatial_cfg(periodic=False, cap=64, **capacity):
    from subzero_tpu import SimConfig
    from subzero_tpu.config import (
        CapacityConfig, DomainConfig, NumericsConfig, PhysicsConfig,
        ProcessConfig,
    )

    return SimConfig(
        physics=PhysicsConfig(cd_ocean=0.0, cd_atm=0.0, f_coriolis=0.0),
        processes=ProcessConfig(periodic=periodic),
        capacity=CapacityConfig(**{
            **dict(max_floes=cap, max_verts=16, max_neighbors=4,
                   n_mc_points=64, stress_window=10, max_ghosts=4),
            **capacity}),
        numerics=NumericsConfig(dt=10.0, dtype="float64"),
        domain=DomainConfig(lx=8e4, ly=8e4),
        modulus=1.5e3 * 2 * 2000.0,
        min_floe_size=1e4,
    )


def scenario(cfg, polys, steps, vel=None, forcing=None, mesh=None,
             modulus=None, kind="1d", conc=0.5):
    """A scenario dict (torch_ranks) from a JAX config and polygons."""
    from subzero_tpu.state import state_from_polygons

    from test_torch_init import jax_numpy

    st = state_from_polygons(polys, conc, cfg, velocities=vel)
    # scenarios of one config on the default forcing share a JAX compile
    key = (cfg, "default" if forcing is None else id(forcing))
    fc = forcing if forcing is not None else f64_forcing(lx=4e5)
    return {"kind": kind, "mesh": mesh, "cfg": dataclasses.asdict(cfg),
            "state": jax_numpy(st), "forcing": jax_numpy(fc),
            "modulus": cfg.modulus if modulus is None else modulus,
            "steps": steps, "_jax": (cfg, st, fc, key)}


def f64_forcing(**kw):
    """A uniform forcing in float64 (the JAX default is float32, which its
    step samples in float32)."""
    import jax.numpy as jnp

    from subzero_tpu.forcing import uniform_forcing

    return uniform_forcing(dtype=jnp.float64, **kw)


def scenarios(s: int) -> dict:
    """The 1-D cases at ``s`` shards."""
    out = {}
    cfg = spatial_cfg()
    lx = cfg.domain.lx
    w = 2 * lx / s
    polys, vels = [], []
    for cx in np.linspace(-6e4, 6e4, 7):       # pairs across the stripes
        polys += [2000 * SQ + [cx - 2050, 0.0], 2000 * SQ + [cx + 2050, 0.0]]
        vels += [[0.05, 0.0], [-0.05, 0.0]]
    out["equivalence"] = scenario(cfg, polys, 20, np.array(vels))
    xb = -lx + w                               # stripe 0 | stripe 1
    out["cross_stripe"] = scenario(
        cfg, [2000 * SQ + [xb - 2050, 0.0], 2000 * SQ + [xb + 2050, 0.0]],
        150, np.array([[0.1, 0], [-0.1, 0]]))
    # 5 m/s for 100 steps of 10 s: crosses the stripe edge 2.5 km ahead
    out["migration"] = scenario(cfg, [2000 * SQ + [xb - 2500, 1e4]], 100,
                                np.array([[5.0, 0.0]]))
    # The periodic cases share one config and forcing (the wind has no
    # drag here: cd_atm = 0), so JAX compiles their step once.
    wind = f64_forcing(lx=4e5, ua=2.0)
    rng = np.random.default_rng(5)
    rpolys = [2400.0 * SQ + rng.uniform(-7e4, 7e4, 2) for _ in range(48)]
    base = spatial_cfg(periodic=True, cap=256)
    for ov in (False, True):
        c = base.replace(numerics=dataclasses.replace(base.numerics,
                                                      overlap_halo=ov))
        out[f"overlap_{ov}"] = scenario(c, rpolys, 6, forcing=wind,
                                        conc=1.0)
    out["periodic_seam"] = scenario(
        c, [2000 * SQ + [-(lx - 2050), 0.0], 2000 * SQ + [lx - 2050, 0.0]],
        150, np.array([[-0.1, 0], [0.1, 0]]), forcing=wind)
    if s == 2:
        # slab 0: one probe floe hugging the edge; slab 1: four floes just
        # across it, all in the probe's bounding circle
        polys = [3e3 * SQ + np.array([-3.2e3, 0.0])]
        polys += [3e3 * SQ + np.array([3.2e3, (k - 1.5) * 2e3])
                  for k in range(4)]
        for k_cap in (2, 8):
            c = spatial_cfg(periodic=True, cap=16, max_neighbors=k_cap,
                            max_ghosts=8)
            out[f"band_k{k_cap}"] = scenario(c, polys, 1, conc=1.0)
    if s == 4:
        out["dryrun"] = dryrun_scenario(s)
    for sc in out.values():
        sc["mesh"] = (s,)
    return out


def dryrun_scenario(s: int) -> dict:
    """``__graft_entry__.dryrun_multichip``'s pack in float64: 1,024 dense
    quads, doubly periodic, one column on every stripe edge, 5 steps."""
    from subzero_tpu import SimConfig
    from subzero_tpu.config import (
        CapacityConfig, DomainConfig, NumericsConfig, ProcessConfig,
    )
    n = 1024
    side = 32
    pitch = 4000.0
    lx = side * pitch / 2
    cap = -(-int(n * 1.25) // (8 * s)) * 8 * s
    cfg = SimConfig(
        capacity=CapacityConfig(
            max_floes=cap, max_verts=16, max_neighbors=8,
            n_mc_points=64, stress_window=16, max_ghosts=max(64, cap // 8)),
        numerics=NumericsConfig(dtype="float64"),
        domain=DomainConfig(lx=lx, ly=lx),
        processes=ProcessConfig(periodic=True))
    rng = np.random.default_rng(0)
    polys = []
    for k in range(n):
        i, j = divmod(k, side)
        c = np.array([-lx + j * pitch, -lx + (i + 0.5) * pitch])
        polys.append(0.5 * SQ * pitch * 0.97
                     + rng.uniform(-0.03, 0.03, (4, 2)) * pitch + c)
    vel = rng.uniform(-2.0, 2.0, size=(n, 2))
    return scenario(cfg, polys, 5, vel,
                    forcing=f64_forcing(lx=4 * lx, dx=lx / 8, uo=0.1),
                    modulus=1.6e8)


def run_jax(scs: dict) -> dict:
    """The JAX package's spatial step on as many CPU devices as each
    scenario's mesh has, one compiled step per config and mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from subzero_tpu.parallel import (
        make_spatial_step, make_spatial_step_2d, rebalance_slabs,
        rebalance_tiles, shard_state, shard_state_2d,
    )
    from torch_ranks import STEP_SCALARS

    from test_torch_init import jax_numpy

    steps, out = {}, {}
    for name, sc in scs.items():
        cfg, st, fc, key = sc["_jax"]
        shape = tuple(sc["mesh"])
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        if sc["kind"] == "2d":
            mesh = Mesh(devs, ("sx", "sy"))
            make = make_spatial_step_2d
            sN = shard_state_2d(rebalance_tiles(st, cfg, *shape), mesh)
        else:
            mesh = Mesh(devs, ("shards",))
            make = make_spatial_step
            sN = shard_state(rebalance_slabs(st, cfg, shape[0]), mesh)
        if (key, shape) not in steps:
            steps[key, shape] = make(cfg, fc, sc["modulus"], 0.0, mesh)
        scal = []
        for i in range(sc["steps"]):
            sN, aux = steps[key, shape](sN, jnp.asarray(i))
            scal.append([jax_scalar(aux, k) for k in STEP_SCALARS])
        out[name] = {"state": jax_numpy(sN), "scalars": np.array(scal),
                     "collision_force": np.asarray(aux.collision_force)}
    return out


def jax_scalar(aux, k: str) -> int:
    """A StepAux scalar of JAX's spatial step, as its driver reads it (for
    ``nbr_overflow``, shard 0's own flag: ROADMAP §C)."""
    return int(getattr(aux, k))


def run_both(script, scs: dict, tmp) -> dict:
    """{world: (port results, JAX results, scenarios)} for
    ``scs = {world: {name: scenario}}``: every rank group runs in the
    background while JAX runs here."""
    groups = {w: torch_ranks.Ranks(
        script, w, {k: {f: v for f, v in sc.items() if f != "_jax"}
                    for k, sc in scs[w].items()}, tmp)
        for w in scs}
    jax_out = {w: run_jax(scs[w]) for w in scs}
    return {w: (groups[w].result(), jax_out[w], scs[w]) for w in scs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(__file__, {s: scenarios(s) for s in (2, 4)},
                    tmp_path_factory.mktemp("spatial"))


def live_rows(st: dict) -> np.ndarray:
    """Sorted (x, y, u, v, ksi, h) rows of the live floes."""
    a = st["alive"]
    rows = np.stack([st[k][a] for k in ("x", "y", "u", "v", "ksi", "h")],
                    axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def assert_matches(port: dict, jax: dict, where: str):
    a, b = live_rows(port["state"]), live_rows(jax["state"])
    assert a.shape == b.shape, where
    dpos = np.max(np.abs(a[:, :2] - b[:, :2]), initial=0.0)
    dvel = np.max(np.abs(a[:, 2:5] - b[:, 2:5]), initial=0.0)
    assert dpos <= TOL_POS and dvel <= TOL_VEL, (where, dpos, dvel)
    np.testing.assert_array_equal(port["scalars"], jax["scalars"],
                                  err_msg=where)


WORLDS = (2, 4)


@pytest.mark.parametrize("s", WORLDS)
def test_matches_jax_spatial_step(runs, s):
    port, jax, _ = runs[s]
    assert_matches(port["equivalence"], jax["equivalence"], "equivalence")
    assert not port["equivalence"]["scalars"][:, 1].any()  # no overflow
    assert not port["equivalence"]["overflow"].any()       # on any rank


@pytest.mark.parametrize("s", WORLDS)
def test_cross_stripe_collision(runs, s):
    port, jax, _ = runs[s]
    assert_matches(port["cross_stripe"], jax["cross_stripe"], "cross")
    st = port["cross_stripe"]["state"]
    u = np.sort(st["u"][st["alive"]])
    assert len(u) == 2 and u[0] < 0 < u[1]   # bounced off each other


@pytest.mark.parametrize("s", WORLDS)
def test_migration(runs, s):
    port, jax, scs = runs[s]
    assert_matches(port["migration"], jax["migration"], "migration")
    st = port["migration"]["state"]
    alive = st["alive"]
    assert alive.sum() == 1
    slot = int(np.nonzero(alive)[0][0])
    cfg = scs["migration"]["_jax"][0]
    n_loc = cfg.capacity.max_floes // s
    w = 2 * cfg.domain.lx / s
    x = float(st["x"][slot])
    owner = slot // n_loc
    assert owner == 1                        # it crossed into stripe 1
    assert -cfg.domain.lx + owner * w <= x < -cfg.domain.lx + (owner + 1) * w


@pytest.mark.parametrize("s", WORLDS)
def test_periodic_seam(runs, s):
    port, jax, _ = runs[s]
    assert_matches(port["periodic_seam"], jax["periodic_seam"], "seam")
    st = port["periodic_seam"]["state"]
    u = np.sort(st["u"][st["alive"]])
    assert len(u) == 2 and u[0] < 0 < u[1]   # bounced back through the seam


@pytest.mark.parametrize("s", WORLDS)
def test_overlap_matches_serialized_exchange(runs, s):
    port, jax, _ = runs[s]
    for ov in (False, True):
        assert_matches(port[f"overlap_{ov}"], jax[f"overlap_{ov}"],
                       f"overlap_halo={ov}")
    a, b = port["overlap_False"], port["overlap_True"]
    np.testing.assert_allclose(live_rows(a["state"]), live_rows(b["state"]),
                               rtol=1e-9, atol=1e-9)
    assert a["scalars"][-1, 0] == b["scalars"][-1, 0] > 0


def test_band_ghost_overflow_is_flagged(runs):
    port, jax, _ = runs[2]
    small, big = port["band_k2"]["scalars"][0], port["band_k8"]["scalars"][0]
    np.testing.assert_array_equal(small, jax["band_k2"]["scalars"][0])
    np.testing.assert_array_equal(big, jax["band_k8"]["scalars"][0])
    assert small[1] and small[2] >= 4        # overflow, demand of the row
    assert not big[1] and big[0] >= 4        # K = 8 resolves it
    assert port["band_k2"]["overflow"][0]    # the mesh-wide flag too
    assert not port["band_k8"]["overflow"][0]


def test_dryrun_multichip_pack(runs):
    port, jax, scs = runs[4]
    assert_matches(port["dryrun"], jax["dryrun"], "dryrun")
    cfg = scs["dryrun"]["_jax"][0]
    st0, st = scs["dryrun"]["state"], port["dryrun"]["state"]
    alive, x = st["alive"], st["x"]
    assert int(alive.sum()) == 1024          # no floe lost to migration
    assert np.all(np.isfinite(x[alive]))
    assert not port["dryrun"]["scalars"][:, 1].any()
    assert not port["dryrun"]["overflow"].any()
    n_loc = cfg.capacity.max_floes // 4
    w = 2 * cfg.domain.lx / 4
    slots = np.nonzero(alive)[0]
    owners = slots // n_loc
    stripe = np.clip(((x[slots] + cfg.domain.lx) / w).astype(int), 0, 3)
    edge_lo = -cfg.domain.lx + owners * w
    on_edge = np.minimum(np.abs(x[slots] - edge_lo),
                         np.abs(x[slots] - (edge_lo + w))) < 1.0
    assert np.all((owners == stripe) | on_edge), "a floe is mis-owned"
    # the rebalanced start's slab counts against the end's
    x0 = st0["x"][st0["alive"]]
    c0 = np.bincount(np.clip(((x0 + cfg.domain.lx) // w).astype(int), 0, 3),
                     minlength=4)
    c1 = np.bincount(owners, minlength=4)
    assert int(np.abs(c1 - c0).sum()) // 2 > 0, "no floe migrated"


def test_mesh_on_one_rank(monkeypatch):
    """The mesh's collectives on a one-rank gloo group in this process: a
    self-ring shift, the reductions and the gather return their input; a
    tensor on another device raises rather than moving; ``initialize()``
    without a launcher's environment is a no-op and a mesh needs a group."""
    import torch
    import torch.distributed as dist

    from chip_smoke import free_port
    from subzero_tpu_torch.parallel.distributed import (
        Mesh, initialize, local_slab_bounds, spatial_mesh,
    )

    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize() is False
    with pytest.raises(RuntimeError, match="initialize"):
        spatial_mesh(device="cpu")
    assert initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                      device="cpu")
    try:
        mesh = spatial_mesh(device="cpu")
        assert (mesh.shape, mesh.coords, mesh.peer("shards", 1)) == \
            ((1,), (0,), 0)
        t = torch.arange(6, dtype=torch.float64).reshape(3, 2)
        assert torch.equal(mesh.shift(t, "shards", 1), t)
        assert torch.equal(mesh.psum(t), t) and torch.equal(mesh.pmax(t), t)
        assert torch.equal(mesh.all_gather(t), t)
        with pytest.raises(ValueError, match="cannot join"):
            mesh.psum(torch.empty(2, device="meta"))
        with pytest.raises(ValueError, match="needs 2 ranks"):
            Mesh((2, 1), ("sx", "sy"), device="cpu")
        cfg = spatial_cfg()
        assert local_slab_bounds(mesh, cfg) == [(-8e4, 8e4)]
    finally:
        dist.destroy_process_group()


def test_simulation_state_off_the_mesh_device_raises():
    """A state on another device than the mesh's raises rather than
    moving: a CPU state on a CUDA (NCCL) mesh, and a state on another
    device on a CPU (gloo) mesh.  Nothing runs on the CPU on its own."""
    import torch
    import torch.distributed as dist

    from chip_smoke import free_port
    from subzero_tpu_torch.parallel.distributed import Mesh, initialize
    from subzero_tpu_torch.sim import Simulation, out_of_box_sim
    from subzero_tpu_torch.state import FloeState

    cpu = out_of_box_sim(device="cpu", dtype="float64")
    kw = dict(cfg=cpu.cfg, forcing=cpu.forcing, modulus=cpu.modulus)
    # an NCCL mesh's device (built without a group: the check comes first)
    cuda_mesh = Mesh.__new__(Mesh)
    cuda_mesh.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="the state is on cpu"):
        Simulation(state=cpu.state, mesh=cuda_mesh, **kw)
    meta = FloeState(**{f.name: getattr(cpu.state, f.name).to("meta")
                        for f in dataclasses.fields(cpu.state)})
    assert initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        mesh = Mesh((1,), ("shards",), device="cpu")
        with pytest.raises(ValueError, match="the state is on meta"):
            Simulation(state=meta, mesh=mesh, **kw)
        sim = Simulation(state=cpu.state, mesh=mesh, **kw)
        assert sim.state.device == mesh.device
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch_ranks

    torch_ranks.rank_main()
