"""Reductions from the device trace and the timer marks to numbers: the
union of intervals, idle gaps by host phase, device operations by name,
and the clip kernels' bound.

``busy_us`` is a frozen copy of ``chip_step_trace.py:busy_us``, and
``real_edges`` / ``clip_bound_ms`` of ``chip_smoke.py``'s, at commit
61c7962."""

from __future__ import annotations

import re

CLIP_KERNEL = re.compile(r"\bclip(_pallas)?_kernel\b")

# H100 SXM published peaks (NVIDIA data sheet): float operations outside
# the tensor cores by element size (float32 67, float64 34 TFLOP/s), and
# HBM3 bandwidth
PEAK_FLOPS = {4: 67e12, 8: 34e12}
PEAK_BYTES_S = 3.35e12


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def real_edges(poly):
    """Edges of non-zero length per polygon, [B] (the kernel skips the
    zero-length padding edges)."""
    import torch

    d = torch.roll(poly, -1, dims=1) - poly
    return ((d[..., 0] != 0) | (d[..., 1] != 0)).sum(dim=1)


def clip_work(p, q):
    """(bytes, device scalar of real edge pairs, element size) of one clip
    call on ``p [B, Vp, 2]``, ``q [B, Vq, 2]``: each input read once, each
    output (area, centroid, chord: 5 floats, and an int32 crossing count)
    written once, the edge pairs the operations are counted over, and the
    size of the inputs' float type, which sets the peak."""
    b = p.shape[0]
    nbytes = (p.numel() + q.numel()) * p.element_size() + b * (
        5 * p.element_size() + 4)
    pairs = (real_edges(p) * real_edges(q)).sum()
    return nbytes, pairs, p.element_size()


def clip_bound_ms(nbytes: float, pairs: float, itemsize: int = 4):
    """Least time the card could take for a clip call: the larger of bytes
    over 3.35 TB/s and float operations over the peak of the inputs' type
    without tensor cores (:data:`PEAK_FLOPS`), counting 90 operations per
    (P edge, Q edge) pair per side, as the Pallas kernel's cost estimate
    does (clip_pallas.py:186-190), for the edges of non-zero length in this
    data."""
    flops = 2 * 90 * float(pairs)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def gaps(intervals, lo, hi):
    """The idle intervals of ``[lo, hi]`` outside the union of
    ``intervals``."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if b <= cur:
            continue
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def gaps_by_phase(idle, spans, top: int = 10):
    """Idle seconds by the innermost host span that holds each gap's
    midpoint (``spans``: (name, start, end)); 'driver' where none does."""
    import bisect

    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    by = {}
    for a, b in idle:
        mid = 0.5 * (a + b)
        name = "driver"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            if spans[i][2] >= mid:
                name = spans[i][0]
                break
            i -= 1
        by[name] = by.get(name, 0.0) + (b - a)
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def marks_ms(marks):
    """Sum of each phase's intervals, ms: ``marks`` is the ordered list of
    (name, seconds-or-event) the step's timer recorded; a phase runs from
    its mark to the next, and "end" closes the step."""
    out = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name == "end":
            continue
        dt = a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3
        out[name] = out.get(name, 0.0) + dt
    return out
