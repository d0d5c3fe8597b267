"""Overlap statistics container (port of ``OverlapStats`` from
``subzero_tpu/geometry/clip.py``).  The segment-midpoint clip of that module
is not ported yet (ROADMAP A11)."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["OverlapStats"]


class OverlapStats(NamedTuple):
    """Statistics of a polygon boolean result for a batch of polygon pairs.

    Attributes (all ``[...]`` batched like the inputs):
      area:     area of the clip result (>= 0 for simple CCW inputs)
      centroid: ``[..., 2]`` area centroid of the result (0 where area ~ 0)
      chord_p:  ``[..., 2]`` Σ directed subsegments of dP in the result.  The
                overlap-reducing force direction on P is
                ``(-chord_y, chord_x)`` (CCW convention); its norm is the
                contact length `dl`.
      n_cross:  int32 number of proper dP×dQ edge crossings (InterX count
                analog, floe_interactions.m:70-71)
    """

    area: torch.Tensor
    centroid: torch.Tensor
    chord_p: torch.Tensor
    n_cross: torch.Tensor
