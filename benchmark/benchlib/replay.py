"""Segment replay: a copy of a ``Simulation`` that shares its tensors.

The program never writes into a tensor it was given (``sim.py``'s module
docstring; ``processes/host.py:_set_rows`` writes into new tensors), so a
segment start state can be kept as the tensors themselves and every
Python-side part of the driver (configuration, capacity, lifecycle RNG and
ledgers, step index, demand window) deep-copied around them."""

from __future__ import annotations

import copy

import numpy as np
import torch


def _collect(obj, memo: dict, seen: set, depth: int = 0) -> None:
    if id(obj) in seen or depth > 12:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        memo[id(obj)] = obj
        return
    if isinstance(obj, (str, bytes, int, float, bool, type(None),
                        np.ndarray, np.generic)):
        return
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    else:
        items = list(getattr(obj, "__dict__", {}).values())
        for name in getattr(type(obj), "__slots__", ()):
            if hasattr(obj, name):
                items.append(getattr(obj, name))
    for v in items:
        _collect(v, memo, seen, depth + 1)


def share_copy(obj):
    """A deep copy of ``obj`` in which every reachable tensor is the
    original tensor, not a clone."""
    memo: dict = {}
    _collect(obj, memo, set())
    return copy.deepcopy(obj, memo)
