"""The Pallas kernel's parity-integral clip — plain PyTorch version.

Port of ``subzero_tpu/geometry/clip_pallas.py``, name for name: the math of
the fused Pallas TPU kernel ``_clip_kernel``, written as plain tensor code on
batch-minor ``[V, B]`` float32 planes.  It is the CPU path of
``contact_impl="pallas"`` and the reference that the Hopper kernel
(``kernels/clip_pallas.py``, ``csrc/clip_pallas.cu``) is held against on the
card.

It is not the same function as the XLA twin ``clip_integral_bm``, which
evaluates each crossing once and applies the ±eps carrier-line offsets as
linear corrections.  This one follows the Pallas kernel operation for
operation, in float32 whatever the input dtype:

* each P edge's two carrier lines start from an offset origin
  ``o = p0 ± eps n̂``, and every crossing with Q is recomputed from it
  (``relx = qx0 - ox``, then ``t`` and ``s`` times ``1/denom``);
* the Q side is a second pass with the roles swapped (Q's edges nudged along
  Q's normals, with their own denominators);
* the crossing count is a third, un-nudged pass;
* eps is ``max(max|coords|, 1)`` taken in the input's dtype, cast to
  float32, times float32 ``eps32 ** (2/3)`` formed in float32.

The indicator sums over the other polygon's edges run in the kernel's order
(all Q edges for +eps, then all for -eps).  Two roundings differ from XLA's
on the CPU: ``rsqrt`` is IEEE ``1/sqrt`` here (XLA's CPU rsqrt is an
approximation within one ulp of it), and the Green's sums over a polygon's
edges may add in another order.

``block`` and ``interpret`` of the JAX functions are knobs of the TPU grid
and of Pallas' interpreter; they have no counterpart here.
"""

from __future__ import annotations

import torch

from .clip import OverlapStats

__all__ = ["overlap_stats_pallas", "difference_stats_pallas", "EPS_SCALE"]

_OUT_ROWS = 8  # area, mx, my, chx, chy, n_cross, pad, pad

# float32(eps32) ** float32(2/3), in float32, as the JAX kernel's wrapper
# forms it (one ulp below the float64 power rounded to float32).
EPS_SCALE = float(torch.tensor(torch.finfo(torch.float32).eps)
                  ** torch.tensor(2.0 / 3.0, dtype=torch.float32))


def _indicator_integrals(px0, py0, dx, dy, eps, q_rows, vq):
    """(I0, I1) ``[Vp, B]``: inside-Q indicator integrals along P's edges,
    on the two carrier lines offset by ±eps along P's normals.

    q_rows: (qx0, qy0, qx1, qy1), each ``[Vq, B]``.
    """
    qx0, qy0, qx1, qy1 = q_rows
    elen2 = dx * dx + dy * dy
    pos = elen2 > 0
    one = torch.ones_like(elen2)
    inv_len = torch.where(pos, one / torch.sqrt(torch.where(pos, elen2, one)),
                          torch.zeros_like(elen2))
    nx = dy * inv_len
    ny = -dx * inv_len

    dqx = qx1 - qx0                                             # [Vq, B]
    dqy = qy1 - qy0
    denom = dx[:, None] * dqy[None] - dy[:, None] * dqx[None]   # [Vp, Vq, B]
    live = torch.abs(denom) > 0
    ones = torch.ones_like(denom)
    inv = ones / torch.where(live, denom, ones)
    sign = -torch.sign(denom)
    zero = torch.zeros_like(denom)

    i0 = torch.zeros_like(px0)
    i1 = torch.zeros_like(px0)
    for sgn in (1.0, -1.0):
        ox = px0 + sgn * eps * nx
        oy = py0 + sgn * eps * ny
        relx = qx0[None] - ox[:, None]
        rely = qy0[None] - oy[:, None]
        t = (relx * dqy[None] - rely * dqx[None]) * inv
        s = (relx * dy[:, None] - rely * dx[:, None]) * inv
        w = torch.where(live & (s >= 0) & (s < 1), sign, zero)
        tc = torch.clamp(t, 0.0, 1.0)
        a0 = w * (1.0 - tc)
        a1 = w * (1.0 - tc * tc)
        for j in range(vq):                 # the kernel's order of the sums
            i0 = i0 + a0[:, j]
            i1 = i1 + a1[:, j]
    i0 = torch.clamp(0.5 * i0, 0.0, 1.0)
    i1 = torch.clamp(0.25 * i1, 0.0, 0.5)
    return i0, i1


def _side_sums(p_rows, q_rows, want_inside, eps, vq):
    """Green's-theorem sums over P's boundary: (area, mx, my, chx, chy),
    each ``[B]``."""
    px0, py0, px1, py1 = p_rows
    dx = px1 - px0
    dy = py1 - py0
    i0, i1 = _indicator_integrals(px0, py0, dx, dy, eps, q_rows, vq)
    if not want_inside:
        i0 = 1.0 - i0
        i1 = 0.5 - i1
    c = px0 * dy - py0 * dx
    area = 0.5 * torch.sum(c * i0, dim=0)
    mx = torch.sum(c * (px0 * i0 + dx * i1), dim=0) / 3.0
    my = torch.sum(c * (py0 * i0 + dy * i1), dim=0) / 3.0
    chx = torch.sum(dx * i0, dim=0)
    chy = torch.sum(dy * i0, dim=0)
    return area, mx, my, chx, chy


def _n_cross(p_rows, q_rows, vq):
    """Un-nudged proper crossing count, ``[B]`` float32."""
    px0, py0, px1, py1 = p_rows
    qx0, qy0, qx1, qy1 = q_rows
    dx = (px1 - px0)[:, None]
    dy = (py1 - py0)[:, None]
    dqx = (qx1 - qx0)[None]
    dqy = (qy1 - qy0)[None]
    denom = dx * dqy - dy * dqx                                 # [Vp, Vq, B]
    live = torch.abs(denom) > 0
    ones = torch.ones_like(denom)
    inv = ones / torch.where(live, denom, ones)
    relx = qx0[None] - px0[:, None]
    rely = qy0[None] - py0[:, None]
    t = (relx * dqy - rely * dqx) * inv
    s = (relx * dy - rely * dx) * inv
    valid = live & (t >= 0) & (t < 1) & (s >= 0) & (s < 1)
    return torch.sum(valid, dim=(0, 1)).to(px0.dtype)


def _clip_kernel(p_rows, q_rows, eps, *, difference: bool, vp: int,
                 vq: int) -> torch.Tensor:
    """The kernel's body on whole planes: ``[8, B]`` float32 rows (area,
    mx, my, chx, chy, n_cross, 0, 0)."""
    a_p, mx_p, my_p, chx, chy = _side_sums(
        p_rows, q_rows, not difference, eps, vq)
    a_q, mx_q, my_q, _, _ = _side_sums(q_rows, p_rows, True, eps, vp)
    ncr = _n_cross(p_rows, q_rows, vq)

    sgn = -1.0 if difference else 1.0
    area = a_p + sgn * a_q
    mx = mx_p + sgn * mx_q
    my = my_p + sgn * my_q
    zero = torch.zeros_like(area)
    return torch.stack([area, mx, my, chx, chy, ncr, zero, zero])


def _planes(p: torch.Tensor):
    """[B, V, 2] -> batch-minor coordinate planes ([V, B] x4), float32."""
    p = p.to(torch.float32)
    p1 = torch.roll(p, -1, dims=1)
    return (p[:, :, 0].T, p[:, :, 1].T, p1[:, :, 0].T, p1[:, :, 1].T)


def pair_eps(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's per-pair nudge ``[B]`` float32: the largest |coordinate|
    of the pair (at least 1) in the input's dtype, cast to float32, times
    ``EPS_SCALE``."""
    m = torch.maximum(torch.amax(torch.abs(p), dim=(1, 2)),
                      torch.amax(torch.abs(q), dim=(1, 2)))
    m = torch.clamp(m, min=1.0).to(torch.float32)
    return m * torch.tensor(EPS_SCALE, dtype=torch.float32, device=m.device)


def _clip_pallas(p: torch.Tensor, q: torch.Tensor,
                 difference: bool) -> OverlapStats:
    """p: [B, Vp, 2], q: [B, Vq, 2] -> OverlapStats [B] (float32)."""
    vp, vq = p.shape[1], q.shape[1]
    eps = pair_eps(p, q)
    out = _clip_kernel(_planes(p), _planes(q), eps, difference=difference,
                       vp=vp, vq=vq)
    area = out[0]
    ok = torch.abs(area) > 1e-9
    safe_area = torch.where(ok, area, torch.ones_like(area))
    zero = torch.zeros_like(area)
    centroid = torch.stack(
        [torch.where(ok, out[1] / safe_area, zero),
         torch.where(ok, out[2] / safe_area, zero)], dim=-1)
    chord = torch.stack([out[3], out[4]], dim=-1)
    return OverlapStats(area=area, centroid=centroid, chord_p=chord,
                        n_cross=out[5].to(torch.int32))


def overlap_stats_pallas(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """P ∩ Q statistics of the Pallas kernel's math for ``[B, V, 2]`` pairs
    (float32)."""
    return _clip_pallas(p, q, difference=False)


def difference_stats_pallas(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """P \\ Q statistics of the Pallas kernel's math for ``[B, V, 2]`` pairs
    (float32)."""
    return _clip_pallas(p, q, difference=True)
