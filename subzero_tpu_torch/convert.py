"""Carrying state and forcing across packages as dicts of numpy arrays.

The port imports nothing of the JAX package, so a JAX ``FloeState`` or
``Forcing`` crosses over as ``{field name: numpy array}`` (for example
``{f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}``)
and comes back the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .forcing import Forcing
from .state import FloeState, torch_dtype

__all__ = ["state_from_numpy", "state_to_numpy", "forcing_from_numpy",
           "forcing_to_numpy"]

_INT_FIELDS = {"nv": torch.int32}
_BOOL_FIELDS = ("mc_in", "alive")


def _field_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    if name in _INT_FIELDS:
        return _INT_FIELDS[name]
    if name in _BOOL_FIELDS:
        return torch.bool
    return dtype


def state_from_numpy(d: dict, device=None, dtype="float64") -> FloeState:
    """FloeState from ``{field: numpy array}`` with all 29 fields; float
    fields in ``dtype``, ``nv`` int32, ``mc_in``/``alive`` bool."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    names = [f.name for f in dataclasses.fields(FloeState)]
    missing = [k for k in names if k not in d]
    if missing:
        raise KeyError(f"state dict lacks fields {missing}")
    return FloeState(**{
        k: torch.from_numpy(np.array(d[k])).to(
            device=dev, dtype=_field_dtype(k, dt))
        for k in names})


def state_to_numpy(st: FloeState) -> dict:
    """``{field: numpy array}`` of a FloeState (copied to the host)."""
    return {f.name: getattr(st, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(FloeState)}


def forcing_from_numpy(d: dict, device=None, dtype="float64") -> Forcing:
    """Forcing from ``{x0, y0, dx, uo, vo, ua, va}`` numpy arrays."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    return Forcing(**{
        f.name: torch.from_numpy(np.array(d[f.name])).to(device=dev, dtype=dt)
        for f in dataclasses.fields(Forcing)})


def forcing_to_numpy(fc: Forcing) -> dict:
    """``{field: numpy array}`` of a Forcing (copied to the host)."""
    return {f.name: getattr(fc, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(Forcing)}
