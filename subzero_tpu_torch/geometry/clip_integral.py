"""Closed-form parity-integral overlap statistics — plain PyTorch version.

Port of ``subzero_tpu/geometry/clip_integral.py`` (see its docstring for the
derivation).  For each pair of padded CCW polygons P ``[B, Vp, 2]`` and Q
``[B, Vq, 2]`` it gives area, centroid, contact chord and proper crossing
count of P ∩ Q (or P \\ Q) by Green's theorem over both boundaries, each
edge weighted by the inside-the-other indicator integrals

    I0 = ∫ ind(t) dt          I1 = ∫ t ind(t) dt

evaluated on two carrier lines offset by ±eps along the edge's outward
normal and averaged (the degeneracy rule for collinear shared edges).

This is the CPU path of the port and the reference the CUDA kernel
(``kernels/clip.py``, ``csrc/clip.cu``) is held against on the card.  Its
arithmetic is written operation for operation as the kernel does it: the
crossing parameters are products and differences of separately rounded
terms (no fused multiply-add), ``1/x`` and ``1/sqrt(x)`` are IEEE division
and square root, so the proper-crossing count of the two agrees exactly.
The layout is batch-minor (``[V, B]``, ``[Vp, Vq, B]``) as in the JAX
version.
"""

from __future__ import annotations

import functools

import torch

from .clip import OverlapStats

__all__ = [
    "eps_scale",
    "overlap_stats_int",
    "difference_stats_int",
    "indicator_integrals_bm",
    "clip_integral_bm",
]


@functools.lru_cache(maxsize=None)
def eps_scale(dtype: torch.dtype) -> float:
    """(machine eps of ``dtype``)^(2/3), rounded to ``dtype``: the per-pair
    nudge is ``max(max|coords|, 1) * eps_scale``."""
    e = torch.tensor(torch.finfo(dtype).eps, dtype=dtype) ** (2.0 / 3.0)
    return float(e)


def _inv_len(elen2: torch.Tensor) -> torch.Tensor:
    """1/sqrt(elen2) where elen2 > 0, else 0 (IEEE sqrt and division)."""
    pos = elen2 > 0
    one = torch.ones_like(elen2)
    return torch.where(pos, one / torch.sqrt(torch.where(pos, elen2, one)),
                       torch.zeros_like(elen2))


def indicator_integrals_bm(px0, py0, dx, dy, qx0, qy0, dqx, dqy, eps):
    """Per-edge inside-Q indicator integrals (I0, I1), each ``[Vp, B]``.

    P edges as start ``(px0, py0)`` + direction ``(dx, dy)``, all ``[Vp, B]``;
    Q edges likewise ``[Vq, B]``; eps ``[B]`` (or scalar) nudge magnitude.
    Padded zero-length edges (d == 0 or dq == 0) contribute nothing.

    Standalone single-side variant kept for tests and as a reference; the
    fused two-side path used by ``clip_integral_bm`` is
    ``_both_side_integrals``.
    """
    denom = dx[:, None] * dqy[None] - dy[:, None] * dqx[None]   # [Vp, Vq, B]
    live = torch.abs(denom) > 0
    one = torch.ones_like(denom)
    inv_denom = one / torch.where(live, denom, one)
    delta = -torch.sign(denom)

    elen2 = dx * dx + dy * dy                                   # [Vp, B]
    inv_len = _inv_len(elen2)

    relx = qx0[None] - px0[:, None]                             # [Vp, Vq, B]
    rely = qy0[None] - py0[:, None]
    t0 = (relx * dqy[None] - rely * dqx[None]) * inv_denom
    s0 = (relx * dy[:, None] - rely * dx[:, None]) * inv_denom
    # exact offset corrections (linear in the carrier-line offset)
    ddq = dx[:, None] * dqx[None] + dy[:, None] * dqy[None]     # dot(d, dq)
    ct = ddq * (eps * inv_len)[:, None] * inv_denom
    cs = (eps * elen2 * inv_len)[:, None] * inv_denom

    zero = torch.zeros_like(denom)
    i0 = i1 = 0.0
    for sgn in (1.0, -1.0):
        t = t0 - sgn * ct
        s = s0 - sgn * cs
        # Half-open [0, 1) on s: a carrier line through a Q vertex flips
        # parity exactly once (on the succeeding Q edge).
        valid = live & (s >= 0) & (s < 1)
        tc = torch.clamp(t, 0.0, 1.0)
        w = torch.where(valid, delta, zero)
        i0 = i0 + torch.sum(w * (1.0 - tc), dim=1)              # [Vp, B]
        i1 = i1 + torch.sum(w * (1.0 - tc * tc), dim=1)
    # Parity guards: exact values satisfy 0 <= I1 <= 1/2, I0 in [0, 1]; a
    # roundoff-corrupted parity chain lands outside, and the clamp bounds
    # its damage.
    i0 = torch.clamp(0.5 * i0, 0.0, 1.0)
    i1 = torch.clamp(0.25 * i1, 0.0, 0.5)
    return i0, i1


def _both_side_integrals(px0, py0, dx, dy, qx0, qy0, dqx, dqy, eps):
    """Fused crossing geometry for BOTH indicator directions + count.

    Returns ``(i0_p, i1_p, i0_q, i1_q, n_cross)``: P-edge inside-Q integrals
    ``[Vp, B]``, Q-edge inside-P integrals ``[Vq, B]``, proper crossing count
    ``[B]`` int32.  The [Vp, Vq, B] crossing geometry is evaluated once; the
    ±eps carrier-line offsets of each side are exact linear corrections.
    """
    denom = dx[:, None] * dqy[None] - dy[:, None] * dqx[None]   # [Vp, Vq, B]
    live = torch.abs(denom) > 0
    one = torch.ones_like(denom)
    inv_denom = one / torch.where(live, denom, one)
    delta = -torch.sign(denom)           # +1 P enters CCW Q, -1 leaves

    relx = qx0[None] - px0[:, None]                             # [Vp, Vq, B]
    rely = qy0[None] - py0[:, None]
    # t0: parameter along the P edge; s0: along the Q edge.
    t0 = (relx * dqy[None] - rely * dqx[None]) * inv_denom
    s0 = (relx * dy[:, None] - rely * dx[:, None]) * inv_denom

    ddq = dx[:, None] * dqx[None] + dy[:, None] * dqy[None]     # dot(d, dq)

    elen2_p = dx * dx + dy * dy                                 # [Vp, B]
    inv_len_p = _inv_len(elen2_p)
    elen2_q = dqx * dqx + dqy * dqy                             # [Vq, B]
    inv_len_q = _inv_len(elen2_q)

    # P side: carrier line through p0 + sgn eps n̂_p.
    ct_p = ddq * (eps * inv_len_p)[:, None] * inv_denom
    cs_p = (eps * elen2_p * inv_len_p)[:, None] * inv_denom
    # Q side: uncorrected parameters are (s0, t0); denominator flips sign, so
    # delta_q = -delta and the corrections pick up a sign through inv_denom.
    ct_q = ddq * (eps * inv_len_q)[None] * (-inv_denom)
    cs_q = (eps * elen2_q * inv_len_q)[None] * (-inv_denom)

    zero = torch.zeros_like(denom)
    i0_p = i1_p = i0_q = i1_q = 0.0
    for sgn in (1.0, -1.0):
        # ---- P edges against Q ------------------------------------------
        t = t0 - sgn * ct_p
        s = s0 - sgn * cs_p
        # Half-open [0, 1) on the crossed-boundary parameter: a carrier line
        # through a vertex flips parity exactly once.
        valid = live & (s >= 0) & (s < 1)
        tc = torch.clamp(t, 0.0, 1.0)
        w = torch.where(valid, delta, zero)
        i0_p = i0_p + torch.sum(w * (1.0 - tc), dim=1)          # [Vp, B]
        i1_p = i1_p + torch.sum(w * (1.0 - tc * tc), dim=1)
        # ---- Q edges against P ------------------------------------------
        tq = s0 - sgn * ct_q
        sq = t0 - sgn * cs_q
        valid_q = live & (sq >= 0) & (sq < 1)
        tqc = torch.clamp(tq, 0.0, 1.0)
        wq = torch.where(valid_q, -delta, zero)
        i0_q = i0_q + torch.sum(wq * (1.0 - tqc), dim=0)        # [Vq, B]
        i1_q = i1_q + torch.sum(wq * (1.0 - tqc * tqc), dim=0)

    # Parity guards (exact values satisfy I0 in [0,1], I1 in [0,1/2]).
    i0_p = torch.clamp(0.5 * i0_p, 0.0, 1.0)
    i1_p = torch.clamp(0.25 * i1_p, 0.0, 0.5)
    i0_q = torch.clamp(0.5 * i0_q, 0.0, 1.0)
    i1_q = torch.clamp(0.25 * i1_q, 0.0, 0.5)

    # Proper segment-segment crossing count (InterX analog), un-nudged.
    cross0 = live & (t0 >= 0) & (t0 < 1) & (s0 >= 0) & (s0 < 1)
    n_cross = torch.sum(cross0.to(torch.int32), dim=(0, 1), dtype=torch.int32)
    return i0_p, i1_p, i0_q, i1_q, n_cross


def _green_sums(px0, py0, dx, dy, i0, i1, want_inside: bool):
    """Green's-theorem sums of a boundary weighted by an indicator's
    (I0, I1).  Returns (area, mx, my, chx, chy), each ``[B]``."""
    if not want_inside:
        i0 = 1.0 - i0
        i1 = 0.5 - i1
    c = px0 * dy - py0 * dx                                     # cross(p0, d)
    area = 0.5 * torch.sum(c * i0, dim=0)
    mx = torch.sum(c * (px0 * i0 + dx * i1), dim=0) / 3.0
    my = torch.sum(c * (py0 * i0 + dy * i1), dim=0) / 3.0
    chx = torch.sum(dx * i0, dim=0)
    chy = torch.sum(dy * i0, dim=0)
    return area, mx, my, chx, chy


def _planes(p: torch.Tensor):
    """[B, V, 2] -> batch-minor start points and edge vectors, [V, B] x4."""
    x0 = p[:, :, 0].T
    y0 = p[:, :, 1].T
    p1 = torch.roll(p, -1, dims=1)
    return x0, y0, p1[:, :, 0].T - x0, p1[:, :, 1].T - y0


def clip_integral_bm(p: torch.Tensor, q: torch.Tensor,
                     difference: bool) -> OverlapStats:
    """P ∩ Q (or P \\ Q) statistics for ``[B, Vp, 2] × [B, Vq, 2]`` pairs."""
    one = torch.ones((), dtype=p.dtype, device=p.device)
    eps = torch.maximum(
        torch.maximum(torch.amax(torch.abs(p), dim=(1, 2)),
                      torch.amax(torch.abs(q), dim=(1, 2))), one
    ) * eps_scale(p.dtype)                                      # [B]

    px0, py0, dx, dy = _planes(p)
    qx0, qy0, dqx, dqy = _planes(q)

    i0_p, i1_p, i0_q, i1_q, n_cross = _both_side_integrals(
        px0, py0, dx, dy, qx0, qy0, dqx, dqy, eps)

    a_p, mx_p, my_p, chx, chy = _green_sums(
        px0, py0, dx, dy, i0_p, i1_p, not difference)
    a_q, mx_q, my_q, _, _ = _green_sums(
        qx0, qy0, dqx, dqy, i0_q, i1_q, True)

    if difference:
        area = a_p - a_q
        mx = mx_p - mx_q
        my = my_p - my_q
    else:
        area = a_p + a_q
        mx = mx_p + mx_q
        my = my_p + my_q

    ok = torch.abs(area) > 1e-9
    safe_area = torch.where(ok, area, torch.ones_like(area))
    zero = torch.zeros_like(area)
    centroid = torch.stack(
        [torch.where(ok, mx / safe_area, zero),
         torch.where(ok, my / safe_area, zero)], dim=-1)
    chord = torch.stack([chx, chy], dim=-1)
    return OverlapStats(area=area, centroid=centroid, chord_p=chord,
                        n_cross=n_cross)


def overlap_stats_int(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Closed-form P ∩ Q statistics for ``[B, V, 2]`` polygon pairs."""
    return clip_integral_bm(p, q, difference=False)


def difference_stats_int(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """Closed-form P \\ Q statistics for ``[B, V, 2]`` polygon pairs."""
    return clip_integral_bm(p, q, difference=True)
