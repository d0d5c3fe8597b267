"""The per-layer metrics read from the program's own spans and counters
(``subzero_tpu_torch/trace.py``): finite in a traced CPU run of each tiny
cell, and silent, without raising, on a program that records no such
spans (a plain ``phase_times`` dict, no entry or edit counts)."""

import math
from types import SimpleNamespace

import pytest
import torch

from benchlib import runner
from benchlib.catalog import Catalog

torch.set_num_threads(1)

SPAN_METRICS = ("broadphase.host_ms_per_step", "contact.host_ms_per_step",
                "wall.host_ms_per_step", "trajectory.host_ms_per_step",
                "driver.sync_wait_ms_per_step", "clip.host_us_per_call",
                "lifecycle.slots_edited_per_step")


@pytest.mark.parametrize("cell", ["uniaxial-tiny", "winter-tiny"])
def test_span_metrics_are_finite_in_a_traced_run(tiny_root, cell):
    res = runner.run(cell, 2**31 + 77, 0.0, trace=True, device="cpu",
                     catalog=Catalog(tiny_root), log=lambda m: None)
    got = res["metrics"]
    for name in SPAN_METRICS:
        assert name in got, name
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    # the host spans lie inside the chunk's span
    parts = sum(got[n]["value"] for n in SPAN_METRICS[:4])
    assert parts <= got["driver.chunk_ms_per_step"]["value"]


def test_span_metrics_are_silent_without_the_program_spans():
    readers = Catalog().readers()
    end = SimpleNamespace(phase_times={"chunk": 1.0},
                          lifecycle=SimpleNamespace())
    ctx = dict(run=SimpleNamespace(end=end, n_seg=10), phase={"chunk": 1.0},
               passes={}, marks=None, profile=None, steps=10)
    for name in SPAN_METRICS:
        assert readers[name].read(ctx) is None, name


def test_tables_survive_share_copy_and_reset():
    """The replay's copy keeps the program's tables (a new object with
    the same seconds, entries and counts), and deleting them, as each
    segment does, starts empty ones."""
    from benchlib.replay import share_copy
    from subzero_tpu_torch import trace
    from subzero_tpu_torch.sim import out_of_box_sim

    sim = out_of_box_sim(device="cpu", dtype="float64")
    sim.run(10)
    pt, lt = sim.phase_times, sim.lifecycle.pass_times
    dup = share_copy(sim)
    assert isinstance(dup.phase_times, trace.Table)
    assert dup.phase_times is not pt
    assert dict(dup.phase_times) == dict(pt)
    assert dup.phase_times.entries == pt.entries
    assert dup.phase_times.counts == pt.counts
    assert dup.lifecycle.pass_times.counts == lt.counts
    dup.__dict__.pop("_phase_times")
    dup.lifecycle.__dict__.pop("pass_times")
    assert not dup.phase_times and not dup.lifecycle.pass_times
    dup.run(10)
    assert dup.phase_times.entries["chunk"] == 1
    assert pt.entries["chunk"] == 1
