"""Finds configurations, cells and metric readers by name, from files
alone: ``configs/<name>.json`` (with the builder it names),
``workloads/<cell>.json`` and ``metrics/<metric>.py``, all under one
benchmark root.  A later cell, configuration or metric is a new file here,
never an edit."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


class Catalog:
    """The benchmark's files under ``root`` (the ``benchmark/`` folder)."""

    def __init__(self, root: "str | Path" = ROOT):
        self.root = Path(root)

    def cell(self, name: str) -> dict:
        path = self.root / "workloads" / f"{_checked(name)}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no cell {name!r}: {path} is missing")
        cell = json.loads(path.read_text())
        if cell.get("name") != name:
            raise ValueError(f"{path} names the cell {cell.get('name')!r}")
        return cell

    def cells(self) -> list[str]:
        return sorted(p.stem for p in (self.root / "workloads").glob("*.json"))

    def config(self, name: str) -> dict:
        path = self.root / "configs" / f"{_checked(name)}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no configuration {name!r}: {path}")
        return json.loads(path.read_text())

    def builder(self, config: dict):
        """The module that turns the configuration into a Simulation."""
        return self._load(self.root / config["builder"],
                          f"bench_config_{config['name']}")

    def readers(self) -> dict:
        """Every metric reader, by metric name (the file's stem)."""
        out = {}
        for p in sorted((self.root / "metrics").glob("*.py")):
            if p.name.startswith("_"):
                continue
            out[_checked(p.stem)] = self._load(
                p, "bench_metric_" + p.stem.replace(".", "_").replace("-", "_"))
        return out

    def benchmark(self) -> dict:
        """``BENCHMARK.json`` beside the benchmark's folder."""
        return json.loads((self.root.parent / "BENCHMARK.json").read_text())

    def metrics_for(self, trace: bool) -> list[str]:
        """The metrics a run reports: BENCHMARK.json's ``end_to_end`` ones
        untraced, its ``per_layer`` ones traced."""
        kind = "per_layer" if trace else "end_to_end"
        return [m["name"] for m in self.benchmark()[kind]]

    @staticmethod
    def _load(path: Path, modname: str):
        if modname in sys.modules:
            return sys.modules[modname]
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        return mod
