"""Host spans and counters: where the program's host time goes, by layer.

``span(name)`` times a block of host work with ``time.perf_counter_ns``
and adds its seconds and one entry under its path (``"chunk/contact"``:
the names of the open spans, outermost first) to the active :class:`Table`.
``sync(name)`` is a span around a device->host copy the program already
makes (``"sync.<name>"``): its time is the host waiting for the device.
``count(name, n)`` adds a host-known integer to the active table; it never
reads a device value, so it never syncs.

``recording(table)`` makes a table active, with the paths starting afresh
inside it: ``Simulation.run`` records into ``Simulation.phase_times`` and
``Lifecycle.step`` into ``Lifecycle.pass_times``.  Outside any recording
spans and counts record nothing.

Only while a ``torch.profiler`` is recording does a span also open a range
``"subzero." + path`` on the profiler's clock, so the spans show beside the
device's kernels in a Chrome trace.  The range is a plain function range
(``_RecordFunctionFast``), not ``record_function``'s user annotation,
which the profiler also mirrors onto the device's timeline, where a
reader of device intervals would count it as device work; and it costs a
small fraction of ``record_function``'s dispatch.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["Table", "span", "sync", "count", "recording"]

_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

# (table, path) of the innermost open span or recording; table is None
# outside any recording.  One stack a process: the driver runs in one
# thread.
_stack: list = []


class Table(dict):
    """Host seconds by span path, with each path's entries (``entries``)
    and the named counts (``counts``).  ``items()`` yields every path,
    nested ones included; a missing path reads 0.0."""

    def __init__(self):
        super().__init__()
        self.entries: dict[str, int] = {}
        self.counts: dict[str, int] = {}

    def __missing__(self, path):
        return 0.0

    def clear(self) -> None:
        super().clear()
        self.entries.clear()
        self.counts.clear()

    def add(self, path: str, ns: int) -> None:
        self[path] = self.get(path, 0.0) + ns * 1e-9
        self.entries[path] = self.entries.get(path, 0) + 1

    def self_seconds(self, path: str) -> float:
        """The path's seconds less those of its direct children."""
        pre = path + "/"
        return self[path] - sum(v for k, v in self.items()
                                if k.startswith(pre) and "/" not in
                                k[len(pre):])

    def top_seconds(self) -> float:
        """The sum over the top-level spans, which hold all the others."""
        return sum(v for k, v in self.items() if "/" not in k)

    def report(self, indent: str = "  ") -> list[str]:
        """The span tree, biggest first, one line a path: seconds, self
        seconds, share of the top-level total and entries; then the
        counts."""
        total = max(self.top_seconds(), 1e-12)
        lines = []

        def walk(prefix, depth):
            kids = [k for k in self if k.rpartition("/")[0] == prefix]
            for k in sorted(kids, key=lambda k: -self[k]):
                name = k.rpartition("/")[2]
                lines.append(
                    f"{indent * (depth + 1)}{name:{max(18 - 2 * depth, 1)}s}"
                    f" {self[k]:10.4f} s  self {self.self_seconds(k):10.4f} s"
                    f"  {100 * self[k] / total:5.1f}%  "
                    f"{self.entries.get(k, 0)}x")
                walk(k, depth + 1)

        walk("", 0)
        if self.counts:
            lines.append(f"{indent}counts: " + ", ".join(
                f"{k} {v}" for k, v in sorted(self.counts.items())))
        return lines


class span:
    """Context: the block's host seconds and one entry under its path in
    the active table (and a profiler range while a profiler records)."""

    __slots__ = ("name", "_table", "_path", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _stack:
            table, outer = _stack[-1]
            path = outer + "/" + self.name if outer else self.name
        else:
            table, path = None, self.name
        self._table, self._path = table, path
        _stack.append((table, path))
        if _profiling():
            self._range = _Range("subzero." + path)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        ns = _now() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _stack.pop()
        if self._table is not None:
            self._table.add(self._path, ns)
        return False


def sync(name: str) -> span:
    """A span around a device->host copy: the host waiting for the
    device (path component ``sync.<name>``)."""
    return span("sync." + name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the active table's count ``name``."""
    if _stack:
        table = _stack[-1][0]
        if table is not None:
            table.counts[name] = table.counts.get(name, 0) + n


@contextlib.contextmanager
def recording(table: Table):
    """Context: spans and counts go to ``table``, paths starting afresh."""
    _stack.append((table, ""))
    try:
        yield table
    finally:
        _stack.pop()
