"""The port's host spans and counters (``subzero_tpu_torch/trace.py``) and
where the program records them, on tiny CPU simulations: span nesting and
self time, the driver's six phases with the step's spans under "chunk",
the clip span against an independent count of the calls, the
lifecycle's ``apply_edits.slots`` against the edit applied, ``subzero.*``
ranges in ``Simulation.profile``'s trace (and, on a card, never on the
device's timeline), and the tables through a deep copy and a reset."""

from __future__ import annotations

import copy
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from subzero_tpu_torch import trace
from subzero_tpu_torch.dynamics import contact
from subzero_tpu_torch.processes import lifecycle as tlc
from subzero_tpu_torch.sim import out_of_box_sim

torch.set_num_threads(1)

TOP = {"chunk", "aux_fetch", "merge_fetch", "lifecycle", "rebuild",
       "output"}
STEP = {"broadphase", "contact", "wall", "trajectory"}


def small_sim(**kw):
    """Ten out-of-box floes in float64 on the CPU: walls, corners every 10
    steps (a lifecycle boundary every chunk)."""
    return out_of_box_sim(device="cpu", dtype="float64", **kw)


def test_spans_nest_and_give_self_time():
    table = trace.Table()
    with trace.recording(table):
        with trace.span("a"):
            time.sleep(0.02)
            for _ in range(3):
                with trace.span("b"):
                    time.sleep(0.005)
                    trace.count("n", 2)
            with trace.sync("copy"):
                pass
        with trace.span("c"):
            pass
    assert set(table) == {"a", "a/b", "a/sync.copy", "c"}
    assert table.entries == {"a": 1, "a/b": 3, "a/sync.copy": 1, "c": 1}
    assert table.counts == {"n": 6}
    assert table["a/b"] >= 0.015
    assert table["a"] >= table["a/b"] + table["a/sync.copy"]
    assert table.self_seconds("a") == pytest.approx(
        table["a"] - table["a/b"] - table["a/sync.copy"])
    assert table.self_seconds("a") >= 0.02
    assert table.top_seconds() == pytest.approx(table["a"] + table["c"])
    assert table["missing"] == 0.0
    report = table.report()
    assert report[0].split()[0] == "a" and report[1].split()[0] == "b"
    assert report[-1].strip() == "counts: n 6"


def test_outside_a_recording_nothing_is_recorded():
    outer = trace.Table()
    with trace.span("free"):
        trace.count("free.n")
    with trace.recording(outer):
        with trace.span("x"):
            inner = trace.Table()
            # a recording starts its paths afresh, and takes the counts
            with trace.recording(inner):
                with trace.span("y"):
                    trace.count("k")
    assert set(outer) == {"x"} and not outer.counts
    assert set(inner) == {"y"} and inner.counts == {"k": 1}


def test_driver_phases_hold_the_step_spans(tmp_path):
    sim = small_sim()
    sim.cfg = sim.cfg.replace(processes=dataclasses.replace(
        sim.cfg.processes, n_dt_out=20))
    sim.output_dir = tmp_path
    sim.run(40)
    pt = sim.phase_times
    assert sim.__dict__["_phase_times"] is pt
    assert {k for k in pt if "/" not in k} == TOP
    chunk = {k.split("/")[1] for k in pt if k.startswith("chunk/")}
    assert chunk == STEP | {"sync.summary"}
    for k in TOP:
        kids = sum(v for c, v in pt.items()
                   if c.startswith(k + "/") and c.count("/") == 1)
        assert pt[k] >= kids
    n_steps = pt.entries["chunk/broadphase"]
    assert n_steps >= 40
    for k in STEP:
        assert pt.entries["chunk/" + k] == n_steps
    assert pt.entries["chunk/sync.summary"] == pt.entries["chunk"] + (
        n_steps - 40) // sim._chunk
    # the out-of-box ocean: the thin-floe test waits on the steps between
    # ocean refreshes
    assert 0 < pt.entries["chunk/trajectory/sync.thin"] < n_steps
    assert "corners" in sim.lifecycle.pass_times
    assert "corners.slots" in sim.lifecycle.pass_times.counts
    lines = sim.phase_report().splitlines()
    assert any(line.split()[0] == "contact" for line in lines)
    assert "lifecycle passes:" in lines


def test_clip_span_and_rows_count_every_call(monkeypatch):
    calls = {"n": 0}

    def counted(fn):
        def clip(p, q):
            calls["n"] += 1
            return fn(p, q)
        return clip

    monkeypatch.setattr(contact, "overlap_stats",
                        counted(contact.overlap_stats))
    monkeypatch.setattr(contact, "difference_stats",
                        counted(contact.difference_stats))
    sim = small_sim()
    sim.run(20)
    pt = sim.phase_times
    assert set(k for k in pt if k.endswith("/clip")) == {
        "chunk/contact/clip", "chunk/wall/clip"}
    assert pt.entries["chunk/contact/clip"] + pt.entries[
        "chunk/wall/clip"] == calls["n"] > 0
    # the CPU route launches no kernel
    assert "clip.launches" not in pt.counts
    assert "clip_pallas.launches" not in pt.counts


def test_apply_edits_slots_count_the_edit_applied(monkeypatch):
    sim = small_sim()
    lc = sim.lifecycle
    # every flagged merge dissolves its floe (none is above the gate)
    lc.cfg = lc.cfg.replace(processes=dataclasses.replace(
        lc.cfg.processes, fuse_min_area=1e30))
    applied = []

    def apply_edits(state, edit, cfg, **kw):
        applied.append((set(edit.kills), set(edit.dissolve_kills),
                        len(edit.new_floes), set(edit.updates),
                        set(edit.reshapes)))
        return tlc_apply(state, edit, cfg, **kw)

    tlc_apply = tlc.apply_edits
    monkeypatch.setattr(tlc, "apply_edits", apply_edits)
    alive = sim.state.alive.clone()
    live = [int(i) for i in torch.nonzero(alive)[:, 0]]
    pairs = [(live[1], live[2]), (live[3], live[4]), (live[3], live[5])]
    state, _, changed = lc.step(sim.state, None, 1, sim.dissolved,
                                merge_pairs=pairs)
    assert changed and len(applied) == 1
    kills, dkills, births, updates, reshapes = applied[0]
    assert dkills == {live[1], live[3]} and not kills
    assert births == 0 and not updates and not reshapes
    flipped = int((alive & ~state.alive).sum())
    assert flipped == 2
    counts = lc.pass_times.counts
    assert counts["apply_edits.slots"] == counts["merges.slots"] == flipped
    assert lc.pass_times.entries["apply_edits"] == 1


def test_profile_trace_holds_the_spans(tmp_path):
    sim = small_sim()
    path = sim.profile(str(tmp_path / "trace.json"), n_steps=10)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        name = str(e.get("name", ""))
        if name.startswith("subzero.") and "dur" in e:
            ranges.setdefault(name, []).append(e)
    assert path == str(tmp_path / "trace.json")
    assert len(ranges["subzero.chunk/contact"]) == 10
    assert {"subzero.chunk", "subzero.chunk/broadphase",
            "subzero.chunk/contact/clip", "subzero.chunk/wall",
            "subzero.chunk/trajectory", "subzero.lifecycle",
            "subzero.corners"} <= set(ranges)
    # plain function ranges, never user annotations the profiler would
    # mirror onto the device's lanes
    assert {e["cat"] for es in ranges.values() for e in es} == {"cpu_op"}
    chunk = ranges["subzero.chunk"][0]
    inner = ranges["subzero.chunk/contact"][0]
    assert chunk["ts"] <= inner["ts"] and (
        inner["ts"] + inner["dur"] <= chunk["ts"] + chunk["dur"])


@pytest.mark.cuda
def test_span_ranges_stay_off_the_device_timeline_on_card():
    """A span's range lies on the host's lanes only; ``record_function``'s
    user annotation, which the spans do not use, is mirrored onto the
    device's, where a reader of device intervals would count it as
    device work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording(trace.Table()):
            with trace.span("probe"):
                x = x * 3
        with record_function("annotation.probe"):
            x = x * 2
        torch.cuda.synchronize()
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("subzero.probe", "annotation.probe"):
            seen.setdefault(e.name(), set()).add(e.device_type())
    assert seen["subzero.probe"] == {DeviceType.CPU}
    # the probe sees the mirroring it guards against
    assert DeviceType.CUDA in seen["annotation.probe"]


def test_no_profiler_range_while_no_profiler_records():
    with trace.recording(trace.Table()):
        with trace.span("x") as s:
            assert s._range is None


def test_tables_survive_a_replay_copy_and_reset_when_deleted():
    sim = small_sim()
    sim.run(10)
    pt, lt = sim.phase_times, sim.lifecycle.pass_times
    assert pt.entries["chunk/contact/clip"] > 0
    assert "corners.slots" in lt.counts
    dup = copy.deepcopy(sim)
    assert isinstance(dup.phase_times, trace.Table)
    assert dup.phase_times is not pt
    assert dict(dup.phase_times) == dict(pt)
    assert dup.phase_times.entries == pt.entries
    assert dup.phase_times.counts == pt.counts
    assert dup.lifecycle.pass_times.counts == lt.counts
    dup.__dict__.pop("_phase_times")
    dup.lifecycle.__dict__.pop("pass_times")
    assert not dup.phase_times and not dup.phase_times.counts
    assert not dup.lifecycle.pass_times
    dup.run(10)
    assert dup.phase_times.entries["chunk"] == 1
    assert dup.lifecycle.pass_times.entries["corners"] == 1
    # the original's tables are untouched by the copy's run
    assert pt.entries["chunk"] == 1
    assert np.isfinite(dup.phase_times["chunk"])
