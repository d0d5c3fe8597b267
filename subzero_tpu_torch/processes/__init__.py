"""Floe life-cycle processes (L3 of the reference layer map).

Topology surgery — fracture, fusion, ridging, rafting, welding, corner
grinding, new-ice packing, simplification — runs host-side at process
cadence on the native polygon engine, then scatters slot edits back into the
fixed-capacity device state (SURVEY.md section 7, hard part #2).  The hot
per-step physics never leaves the device; these passes touch only the few
affected slots.
"""

from .host import HostView, NewFloe, StateEdit, apply_edits, extract_view
from .fuse import fuse_floes
from .fracture import fracture_pass
from .corners import corners_pass
from .ridge_raft import ridge_raft_pass
from .weld import weld_pass
from .simplify import simplify_pass
from .pack import pack_pass

__all__ = [
    "HostView", "NewFloe", "StateEdit", "apply_edits", "extract_view",
    "fuse_floes", "fracture_pass", "corners_pass", "ridge_raft_pass",
    "weld_pass", "simplify_pass", "pack_pass",
]
