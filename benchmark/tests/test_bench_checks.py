"""What decides ``correct``, on the CPU at a size a test run holds: sound
runs pass the cells' limits, the control (the reference in bfloat16 in
the program's place) fails them, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have."""

import dataclasses

import pytest
import torch

from benchlib import runner
from benchlib.catalog import Catalog

torch.set_num_threads(1)

STATE_FIELDS = ("x", "y", "alpha", "u", "v", "ksi", "dx_p", "dy_p",
                "dalpha_p", "du_p", "dv_p", "dksi_p")


def _run(root, cell, seed, **kw):
    return runner.Run(cell, seed, 0.0, False, device="cpu",
                      catalog=Catalog(root), log=lambda m: None, **kw)


def _checked(r):
    r.setup()
    r.window()
    r.hooks.recorder.active = False
    return r.check()


@pytest.mark.parametrize("cell", ["uniaxial-tiny", "uniaxial-tiny64",
                                  "winter-tiny"])
def test_sound_run_passes_and_the_control_fails(tiny_root, cell):
    r = _run(tiny_root, cell, 21)
    try:
        checks = _checked(r)
        control = r.control()
    finally:
        r.hooks.uninstall()
    limited = {n: (v, lim) for n, (v, lim) in checks.items()
               if lim is not None}
    assert limited, "the cell has no limits"
    for n, (v, lim) in limited.items():
        assert v <= lim, (n, v, lim)
    assert any(control[n] > lim for n, (_, lim) in limited.items()), control


def _broken_step(kind):
    import subzero_tpu_torch.sim as simmod

    step0 = simmod.physics_step

    def step(state, forcing, step_idx, *a, **kw):
        out, aux = step0(state, forcing, step_idx, *a, **kw)
        if kind == "unchanged":
            return state, aux
        if kind == "half":
            # half of the floes (every other slot) left out: their rows
            # keep the old state
            keep = torch.arange(state.n, device=state.x.device) % 2 == 0
            upd = {f: torch.where(keep, getattr(out, f), getattr(state, f))
                   for f in STATE_FIELDS}
            return dataclasses.replace(out, **upd), aux
        if kind == "altered":
            # an answer altered where it is produced: the new velocities
            return dataclasses.replace(out, u=out.u * 1.1), aux
        raise ValueError(kind)

    return step


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, kind):
    import subzero_tpu_torch.sim as simmod

    monkeypatch.setattr(simmod, "physics_step", _broken_step(kind))
    res = runner.run("uniaxial-tiny", 22, 0.0, False, device="cpu",
                     catalog=Catalog(tiny_root), log=lambda m: None)
    assert res["correct"] is False, res["checks"]


def test_a_lifecycle_that_returns_its_input_is_not_correct(tiny_root,
                                                          monkeypatch):
    """A state left unchanged at the lifecycle's boundaries: the passes
    the reference fires find no trace in the program's state."""
    from subzero_tpu_torch.processes import lifecycle as lcmod

    def step(lc, state, aux, step_idx, dissolved, **kw):
        return state, dissolved, False

    monkeypatch.setattr(lcmod.Lifecycle, "step", step)
    res = runner.run("winter-tiny", 23, 0.0, False, device="cpu",
                     catalog=Catalog(tiny_root), log=lambda m: None)
    assert res["correct"] is False, res["checks"]
    miss = res["checks"]["life.slot_miss"]
    assert miss["value"] > miss["limit"], miss
