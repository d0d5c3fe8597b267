"""The benchmark's harness on the CPU: discovery by name, the yardstick's
arithmetic on hand-counted cases, segment replay, the import rules and
the result line.  Tests that need the card carry the ``cuda`` marker."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO, make_root

from benchlib import check as chk
from benchlib import runner
from benchlib.catalog import Catalog
from benchlib.trace import (
    busy_us, clip_bound_ms, clip_work, gaps, gaps_by_phase, marks_ms,
    real_edges,
)

torch.set_num_threads(1)


# -- discovery ---------------------------------------------------------------


def test_benchmark_json_names_files_that_exist():
    """Every configuration, cell and metric BENCHMARK.json names has its
    file, and each metric's reader declares what BENCHMARK.json says."""
    cat = Catalog(BENCH)
    bench = cat.benchmark()
    for c in bench["configs"]:
        cfg = cat.config(c["name"])
        assert (REPO / c["file"]).resolve() == (
            BENCH / "configs" / f"{c['name']}.json").resolve()
        assert cfg["source"] == c["source"]
        assert hasattr(cat.builder(cfg), "build")
    for w in bench["workloads"]:
        cell = cat.cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
    readers = cat.readers()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            r = readers[m["name"]]
            assert r.KIND == kind
            assert r.UNIT == m["unit"] and r.SOURCE == m["source"]
            if kind == "per_layer":
                assert r.LAYER == m["layer"] and r.MOVES == m["moves"]


def test_a_new_cell_config_and_metric_are_found_from_new_files(tmp_path):
    """A throwaway configuration, cell and metric, added as new files in a
    copy of the folder, are found by name with no file edited."""
    root = make_root(tmp_path, cells={})
    (root / "configs").unlink()
    (root / "configs").mkdir()
    for p in (BENCH / "configs").iterdir():
        (root / "configs" / p.name).symlink_to(p)
    cfg = json.loads((BENCH / "configs" / "winter.json").read_text())
    cfg["name"] = "winter-windy"
    cfg["recipe"]["winds"] = 5.0
    (root / "configs" / "winter-windy.json").write_text(json.dumps(cfg))
    cell = {"name": "winter-windy-100", "config": "winter-windy", "chips": 1,
            "why": "t", "traffic": {"n_floes": 100, "segment_steps": 10},
            "limits": {}}
    (root / "workloads" / "winter-windy-100.json").write_text(
        json.dumps(cell))
    (root / "metrics").unlink()
    (root / "metrics").mkdir()
    for p in (BENCH / "metrics").glob("*.py"):
        (root / "metrics" / p.name).symlink_to(p)
    (root / "metrics" / "driver.steps_per_segment.py").write_text(
        'KIND = "per_layer"\nLAYER = "Driver (sim.py Simulation.run)"\n'
        'UNIT = "steps"\nSOURCE = "program_counter"\n'
        'MOVES = "floe_steps_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx["run"].n_seg\n')
    # the metric's entry in BENCHMARK.json, as a later PR adds it
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "driver.steps_per_segment", "unit": "steps",
        "better": "lower", "source": "program_counter",
        "layer": "Driver (sim.py Simulation.run)",
        "moves": "floe_steps_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = Catalog(root)
    assert "winter-windy-100" in cat.cells()
    got = cat.cell("winter-windy-100")
    conf = cat.config(got["config"])
    assert conf["recipe"]["winds"] == 5.0
    inp = cat.builder(conf).make_inputs(conf["recipe"], got["traffic"], 3)
    assert np.all(inp.grid["ua"] == 5.0)
    assert "driver.steps_per_segment" in cat.readers()
    assert "driver.steps_per_segment" in cat.metrics_for(trace=True)
    assert "driver.steps_per_segment" not in cat.metrics_for(trace=False)


def test_names_outside_the_rule_are_refused(tmp_path):
    cat = Catalog(BENCH)
    for bad in ("../winter", "a b", "", "x" * 65):
        with pytest.raises(ValueError):
            cat.cell(bad)


# -- yardstick arithmetic ----------------------------------------------------


def test_busy_us_is_the_union_of_intervals():
    assert busy_us([]) == 0.0
    assert busy_us([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert busy_us([(0, 10), (2, 3), (10, 12)]) == 12.0


def test_gaps_and_their_host_phase():
    idle = gaps([(2, 4), (6, 8)], 0, 10)
    assert idle == [(0, 2), (4, 6), (8, 10)]
    spans = [("chunk", 0, 5), ("lifecycle", 5, 10), ("weld", 7, 9)]
    got = dict(gaps_by_phase(idle, spans))
    assert got == {"chunk": 2.0, "lifecycle": 2.0, "weld": 2.0}


def test_marks_sum_each_phase_to_the_next_mark():
    marks = [("broadphase", 0.0), ("contact", 0.001), ("wall", 0.004),
             ("trajectory", 0.005), ("end", 0.007),
             ("broadphase", 0.010), ("contact", 0.012), ("wall", 0.013),
             ("trajectory", 0.0135), ("end", 0.0145)]
    got = marks_ms(marks)
    assert got["broadphase"] == pytest.approx(3.0)
    assert got["contact"] == pytest.approx(4.0)
    assert got["wall"] == pytest.approx(1.5)
    assert got["trajectory"] == pytest.approx(3.0)


def test_clip_bound_counts_real_edges_by_hand():
    # a triangle padded to 4 vertices (one zero-length edge) against a
    # square: 3 x 4 real edge pairs
    tri = torch.tensor([[[0., 0.], [1., 0.], [0., 1.], [0., 0.]]])
    sq = torch.tensor([[[0., 0.], [2., 0.], [2., 2.], [0., 2.]]])
    assert real_edges(tri).tolist() == [3]
    assert real_edges(sq).tolist() == [4]
    nbytes, pairs, size = clip_work(tri, sq)
    assert int(pairs) == 12 and size == 4
    # 16 input floats and 5 output floats at 4 bytes, one int32
    assert nbytes == 16 * 4 + 5 * 4 + 4
    ms, bound = clip_bound_ms(nbytes, int(pairs), size)
    t_ops = 2 * 90 * 12 / 67e12 * 1e3
    t_bytes = nbytes / 3.35e12 * 1e3
    assert ms == pytest.approx(max(t_ops, t_bytes))
    assert bound == ("bytes" if t_bytes >= t_ops else "operations")


def test_clip_bound_takes_the_float64_peak_for_float64_inputs():
    # 64 real edge pairs a side: operations bound at either peak
    sq = torch.tensor([[[0., 0.], [2., 0.], [2., 1.], [3., 1.], [3., 2.],
                        [1., 2.], [1., 1.], [0., 1.]]], dtype=torch.float64)
    nbytes, pairs, size = clip_work(sq, sq)
    assert int(pairs) == 64 and size == 8
    assert nbytes == 32 * 8 + 5 * 8 + 4
    ms, bound = clip_bound_ms(nbytes, int(pairs), size)
    assert bound == "operations"
    assert ms == pytest.approx(2 * 90 * 64 / 34e12 * 1e3)
    ms32, _ = clip_bound_ms(nbytes, int(pairs), 4)
    assert ms == pytest.approx(ms32 * 67 / 34)


def test_bf16_rounds_to_eight_significant_bits():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-9, 256.5, -3.14159])
    got = chk.bf16(x)
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2**-7 or got[1] == 1.0   # a tie, to even
    assert got[2] == 1.0 + 2**-7
    assert got[3] == 256.0
    assert got[4] == pytest.approx(-3.140625)


# -- imports -----------------------------------------------------------------


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        assert not _imports(p) & {"subzero_tpu_torch", "subzero_tpu", "jax",
                                  "jaxlib", "torch", "benchlib"}, p
    code = ("import sys; sys.path.insert(0, %r); import reference.oracle, "
            "reference.mass, reference.lifecycle; print(sorted("
            "{m.split('.')[0] for m in sys.modules}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & {"subzero_tpu_torch", "subzero_tpu", "jax", "torch"}


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.parts:
            continue
        assert not _imports(p) & {"jax", "jaxlib", "flax", "subzero_tpu"}, p


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "subzero_tpu_torch_x", object())
    assert "subzero_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "subzero_tpu.sim", object())
    assert "subzero_tpu" in runner.forbidden_modules()


def test_run_py_refuses_without_a_card_and_without_the_program(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ["--workload", "uniaxial-200", "--seed", "3", "--seconds", "1",
            "--trace", "0"]
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert res.returncode != 0
    assert not res.stdout.strip()
    # a directory with the benchmark alone: the program is missing
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "benchmark/run.py", *args],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert res.returncode != 0
    assert not res.stdout.strip()


# -- replay and the result line ----------------------------------------------


def test_two_replayed_segments_do_the_same_steps(tiny_root):
    """Two segments from one start state, float64 on the CPU: the same
    steps, the same live set, the same state."""
    r = runner.Run("uniaxial-tiny", 11, 0.0, False, device="cpu",
                   dtype="float64", catalog=Catalog(tiny_root),
                   log=lambda m: None)
    try:
        r.setup()
        a, _, bad_a, _ = r.segment()
        b, _, bad_b, _ = r.segment()
    finally:
        r.hooks.uninstall()
    assert a.step_idx == b.step_idx == r.start_step + r.n_seg
    assert r.start.step_idx == r.start_step
    assert torch.equal(a.state.alive, b.state.alive)
    for f in ("x", "y", "u", "v", "alpha", "ksi", "mass"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert bad_a == bad_b == 0


def test_the_result_line_has_the_contract_keys(tiny_root):
    res = runner.run("uniaxial-tiny", 12, 0.0, trace=True, device="cpu",
                     catalog=Catalog(tiny_root), log=lambda m: None)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] == 200 and res["failed"] == 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s", "platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert "contact.ms_per_step" in res["metrics"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["limit"] is not None
    json.dumps(res)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device, tiny_root):
    res = runner.run("uniaxial-tiny", 13, 1.0, trace=True,
                     device=cuda_device, catalog=Catalog(tiny_root),
                     log=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
