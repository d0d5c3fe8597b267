"""Gloo ranks for the port's spatial-decomposition tests.

A test file launches its ranks as subprocesses of itself
(``python tests/test_torch_spatial*.py --payload ... --out ...`` with
torchrun's environment, ``MASTER_ADDR=127.0.0.1`` and a free port): the
file's ``__main__`` block calls ``rank_main``, which joins a gloo group
through ``parallel.distributed.initialize()``, runs every scenario of the
payload with ``run_scenario`` and has rank 0 write the results.  The
ranks import torch and the port only.  ``Ranks`` runs one such group in
the background with its own timeout and kills every rank on an overrun,
so a deadlock fails a test instead of hanging the suite.

A scenario is a dict: ``kind`` ("1d" or "2d" for a spatial step run,
"sim" for a mesh ``Simulation``), ``mesh`` (the mesh shape), ``cfg``
(``dataclasses.asdict`` of a config), ``state`` and ``forcing`` (numpy
dicts), ``modulus``, ``steps`` and, for "sim", the driver's arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

STEP_SCALARS = ("n_collisions", "nbr_overflow", "nbr_demand",
                "region_overflow", "region_pool_need", "pair_pool_overflow",
                "pair_pool_need")


class Ranks:
    """One gloo group of ``world`` ranks of ``script`` running
    ``scenarios`` ({name: scenario}) in the background
    (``chip_smoke.RankGroup``); ``result()`` waits for it and returns
    {name: result} from rank 0.  The group fails on a rank's error, or when
    it outlives ``timeout`` seconds from its start, and then every rank is
    killed."""

    def __init__(self, script, world: int, scenarios: dict, tmp: Path,
                 timeout: float = 120.0):
        from chip_smoke import RankGroup

        tmp = Path(tmp)
        payload = tmp / f"payload_{world}.pkl"
        self.out = tmp / f"results_{world}.pkl"
        payload.write_bytes(pickle.dumps(scenarios))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env["PYTHONPATH"] = str(ROOT)
        env["OMP_NUM_THREADS"] = "1"
        self.group = RankGroup(
            [sys.executable, str(script), "--payload", str(payload), "--out",
             str(self.out)], world, timeout, env=env, cwd=str(ROOT))

    def result(self) -> dict:
        self.group.wait()
        return pickle.loads(self.out.read_bytes())


def port_cfg(d: dict):
    """The port's SimConfig from ``dataclasses.asdict`` of a config."""
    from subzero_tpu_torch import config as tcfg

    d = dict(d)
    sections = {"physics": "PhysicsConfig", "contact": "ContactConfig",
                "clamps": "ClampConfig", "processes": "ProcessConfig",
                "capacity": "CapacityConfig", "numerics": "NumericsConfig",
                "domain": "DomainConfig"}
    kw = {k: getattr(tcfg, cls)(**d.pop(k)) for k, cls in sections.items()}
    return tcfg.SimConfig(**kw, **d)


def _mesh(shape):
    from subzero_tpu_torch.parallel.distributed import Mesh

    names = ("shards",) if len(shape) == 1 else ("sx", "sy")
    return Mesh(shape, names, device="cpu")


def _run_steps(sc: dict, mesh) -> dict:
    """A spatial step run from the global state: rebalance, shard, step,
    gather.  Returns the final global state, per-step aux scalars, the
    step's mesh-wide overflow flag per step and the last step's gathered
    collision forces."""
    from subzero_tpu_torch.convert import (
        forcing_from_numpy, state_from_numpy, state_to_numpy,
    )
    from subzero_tpu_torch.parallel import gather_state, shard_state
    from subzero_tpu_torch.parallel.spatial2d import mesh_step

    cfg = port_cfg(sc["cfg"])
    dtype = cfg.numerics.dtype
    st = state_from_numpy(sc["state"], device="cpu", dtype=dtype)
    fc = forcing_from_numpy(sc["forcing"], device="cpu", dtype=dtype)
    step, rebalance = mesh_step(cfg, fc, sc["modulus"], 0.0, mesh)
    slab = shard_state(rebalance(st), mesh)
    scal, over = [], []
    for i in range(sc["steps"]):
        slab, aux = step(slab, i)
        scal.append([int(getattr(aux, k)) for k in STEP_SCALARS])
        over.append(bool(step.overflow))
    return {"state": state_to_numpy(gather_state(slab, mesh)),
            "scalars": np.array(scal),
            "overflow": np.array(over),
            "collision_force": mesh.all_gather(
                aux.collision_force).numpy()}


def _build_sim(sc: dict, mesh):
    """The port's Simulation of a "sim" scenario on ``mesh``."""
    from subzero_tpu_torch.convert import forcing_from_numpy, state_from_numpy
    from subzero_tpu_torch.sim import Simulation

    cfg = port_cfg(sc["starts"][0]["cfg"])
    dtype = cfg.numerics.dtype
    kw = dict(sc.get("sim_kw", {}))
    wall = kw.pop("wall", None)
    sim = Simulation(
        cfg=cfg, state=state_from_numpy(sc["starts"][0]["state"],
                                        device="cpu", dtype=dtype),
        forcing=forcing_from_numpy(sc["forcing"], device="cpu", dtype=dtype),
        modulus=sc["modulus"], mesh=mesh, **kw)
    if wall is not None:
        # ly shrinks by ``step`` metres every ``every`` steps to ``floor``
        step, every, floor = wall
        sim.wall_fn = (lambda i: (1e5, max(1e5 - step * (i // every),
                                            floor)))
    return sim


def _digest(sim, mesh) -> bool:
    """Whether every rank holds the same global state (byte for byte)."""
    import hashlib

    import torch

    from subzero_tpu_torch.convert import state_to_numpy

    h = hashlib.sha256()
    for k, v in sorted(state_to_numpy(sim.state).items()):
        h.update(np.ascontiguousarray(v).tobytes())
    d = torch.tensor(list(h.digest()), dtype=torch.uint8)[None]
    return bool((mesh.all_gather(d) == d).all())


def _run_sim(sc: dict, mesh) -> dict:
    """A mesh Simulation run chunk by chunk, each chunk from the JAX
    driver's chunk-start run state (``sc["starts"]``: step, state, config,
    dissolved grid, lifecycle RNG and ledgers, and the driver's run state
    under the port's names, ``run``).  The config is replaced (and the
    step rebuilt and the slabs rebalanced) only where JAX's changed, as
    JAX rebuilt there too.  Returns every chunk's
    end state and whether all ranks held the same global state."""
    from subzero_tpu_torch.convert import state_from_numpy, state_to_numpy

    sim = _build_sim(sc, mesh)
    out = []
    for k, start in enumerate(sc["starts"]):
        if k:
            cfg = port_cfg(start["cfg"])
            sim.state = state_from_numpy(start["state"], device="cpu",
                                         dtype=cfg.numerics.dtype)
            if cfg != sim.cfg:
                sim.cfg = cfg
                sim.__post_init__()
        sim.step_idx = start["step"]
        sim.dissolved = np.array(start["dissolved"])
        lc = sim.lifecycle
        lc.rng.bit_generator.state = start["rng"]
        for f in ("amax", "exported_mass", "last_birth_nv"):
            setattr(lc, f, start["lifecycle"][f])
        for k, v in start["run"].items():
            setattr(sim, k, v)
        sim.run(start["n"])
        out.append({"step": sim.step_idx,
                    "state": state_to_numpy(sim.state),
                    "cfg": dataclasses.asdict(sim.cfg),
                    "dissolved": np.array(sim.dissolved),
                    "wall": sim._wall_now,
                    "same_on_all_ranks": _digest(sim, mesh)})
    return {"chunks": out}


def run_scenario(sc: dict, mesh) -> dict:
    return _run_sim(sc, mesh) if sc["kind"] == "sim" else _run_steps(sc,
                                                                     mesh)


def rank_main() -> None:
    """Entry point of one rank (the test file's ``__main__`` block)."""
    import torch
    import torch.distributed as dist

    from subzero_tpu_torch.parallel.distributed import initialize

    ap = argparse.ArgumentParser()
    ap.add_argument("--payload", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    initialize(device="cpu")        # the launcher's environment, gloo
    try:
        scenarios = pickle.loads(Path(a.payload).read_bytes())
        results = {}
        for name, sc in scenarios.items():
            results[name] = run_scenario(sc, _mesh(tuple(sc["mesh"])))
        if dist.get_rank() == 0:
            Path(a.out).write_bytes(pickle.dumps(results))
    finally:
        dist.destroy_process_group()
