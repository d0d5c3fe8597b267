"""Puts the benchmark's folder and the repository root on the path, and
builds throwaway catalogs of tiny cells for the CPU tests."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a 40-floe uniaxial pack at the published floe size (2e8 m^2), in the
# float32 and the float64 configuration, and a 100-floe winter pack at the
# published size, for CPU runs in seconds
TINY = {
    "uniaxial-tiny": {
        "config": "uniaxial",
        "traffic": {"n_floes": 40, "lx": 44721.0, "ly": 44721.0,
                    "start_step": 0, "segment_steps": 200, "check_steps": 2,
                    "check_floes": 12},
        "limits_of": "uniaxial-200",
    },
    "uniaxial-tiny64": {
        "config": "uniaxial-f64",
        "traffic": {"n_floes": 40, "lx": 44721.0, "ly": 44721.0,
                    "start_step": 0, "segment_steps": 200, "check_steps": 2,
                    "check_floes": 12},
        "limits_of": "uniaxial-10k",
    },
    "winter-tiny": {
        "config": "winter",
        "traffic": {"n_floes": 100, "start_step": 60, "warm_steps": 10,
                    "segment_steps": 10, "check_steps": 2,
                    "check_floes": 24},
        "limits_of": "winter-10k",
    },
}


def make_root(tmp: Path, cells=TINY) -> Path:
    """A benchmark root in ``tmp``: links to the real folder's code and
    data, a copy of BENCHMARK.json beside it, plus the tiny cells (with the
    limits of the cells they stand for) as new files."""
    root = tmp / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for d in ("benchlib", "reference", "configs", "metrics"):
        (root / d).symlink_to(BENCH / d)
    (root / "workloads").mkdir()
    for p in (BENCH / "workloads").glob("*.json"):
        shutil.copy(p, root / "workloads" / p.name)
    for name, spec in cells.items():
        real = json.loads((BENCH / "workloads" /
                           f"{spec['limits_of']}.json").read_text())
        cell = {"name": name, "config": spec["config"], "chips": 1,
                "why": "CPU test", "traffic": spec["traffic"],
                "limits": real["limits"]}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the card")
    return torch.device("cuda")
