"""Host-side polygon measures.

The port's copy of ``cut_polygon`` from ``subzero_tpu/geometry/measures.py``
(the new-ice packing's topography splits need it).  The batched measures of
that module (``segment_intersections``, ``point_poly_dist``) are not ported
yet (ROADMAP A11).
"""

from __future__ import annotations

import numpy as np

__all__ = ["cut_polygon"]


def cut_polygon(poly: np.ndarray, line_p0, line_p1, side: int) -> np.ndarray:
    """Host-side: clip ``poly [n, 2]`` by the line through p0-p1, keeping
    side 1 (left of p0->p1) or side 2 (right) — cutpolygon.m semantics."""
    p0 = np.asarray(line_p0, dtype=np.float64)
    p1 = np.asarray(line_p1, dtype=np.float64)
    d = p1 - p0
    # left of the line: cross(d, x - p0) >= 0
    sign = 1.0 if side == 1 else -1.0
    out = []
    n = len(poly)
    sd = sign * (d[0] * (poly[:, 1] - p0[1]) - d[1] * (poly[:, 0] - p0[0]))
    for i in range(n):
        j = (i + 1) % n
        if sd[i] >= 0:
            out.append(poly[i])
            if sd[j] < 0:
                t = sd[i] / (sd[i] - sd[j])
                out.append(poly[i] + t * (poly[j] - poly[i]))
        elif sd[j] >= 0:
            t = sd[i] / (sd[i] - sd[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, 2))
