"""Per-region overlap decomposition — port of ``subzero_tpu/geometry/regions.py``.

The reference applies ONE contact force per disjoint overlap region
(``collisions/floe_interactions.m:92-190``), with the small-region cull per
region (:79-83).  ``region_stats`` decomposes P ∩ Q (or P \\ Q via a
reversed Q) into its disjoint regions and returns per-region area, centroid
and contact chord in fixed ``[B, C]`` buffers (C = crossing capacity):

1. proper P-edge × Q-edge crossings (the aggregate clip's half-open rules),
   compacted to the ``C`` smallest P-boundary parameters;
2. the Weiler–Atherton walk as a permutation of the crossings: at an
   entering crossing the region boundary follows P to the next crossing in
   P-order, at a leaving one it follows Q to the next in Q-order;
3. orbit labels of that permutation by pointer-doubling min-propagation;
4. closed-form Green integrals of each arc (prefix sums of the per-edge
   shoelace and first-moment terms plus fractional end pieces);
5. a per-region reduction of the arcs by orbit label.

Degenerate configurations (collinear shared edges, odd crossing counts,
non-alternating parities, > C crossings) set ``consistent = False``; the
caller keeps the aggregate contact for those pairs.  For P \\ Q pass
``reverse_polygons(q, nv_q)``: ∂(P \\ Q) traverses Q backward.

Every tie is broken as in the JAX function, so ``valid``, ``consistent``
and ``n_cross`` are identical to it: the crossing compaction is a stable
descending sort (``lax.top_k`` puts the lower flat index first on ties) and
the Q-order sort is stable, as ``jnp.argsort`` is.  The one-hot region
reductions are masked sums over the slot axis, so no batched matrix product
(and so no TF32) is involved.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["RegionStats", "region_stats", "reverse_polygons"]

_BIG = 1e30


class RegionStats(NamedTuple):
    """Disjoint-region statistics of a polygon boolean, shapes ``[B, C]``.

    Regions are keyed by their root crossing slot (the orbit's minimum
    label); non-root slots have ``valid = False`` and zero stats.

    area, centroid [B, C, 2], chord [B, C, 2] (sum of the region's P-arc
    vectors), valid, consistent [B] (decomposition trustworthy), n_cross [B]
    int32 (proper crossing count, uncapped), p_len (arc length of the region
    on P's boundary), p_cnt (count of its non-zero P-boundary segments:
    p_len / p_cnt is the reference's dl, floe_interactions.m:131), bbox
    [B, C, 4] (minx, miny, maxx, maxy; +-1e30 where invalid) or None unless
    ``with_bbox``.
    """

    area: torch.Tensor
    centroid: torch.Tensor
    chord: torch.Tensor
    valid: torch.Tensor
    consistent: torch.Tensor
    n_cross: torch.Tensor
    p_len: torch.Tensor
    p_cnt: torch.Tensor
    bbox: torch.Tensor | None


def reverse_polygons(verts: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """Reverse the vertex order of padded polygons (CCW <-> CW).

    ``verts [..., V, 2]`` padded with vertex 0, ``nv [...]`` real counts.
    Vertex 0 stays first, so the padding convention holds:
    ``new[k] = old[(nv - k) mod nv]`` for ``k < nv``.
    """
    v = verts.shape[-2]
    k = torch.arange(v, device=verts.device)
    nv_ = nv[..., None].long()
    idx = torch.where(k == 0, 0, nv_ - k)
    idx = torch.where((k < nv_) & (idx >= 0), idx, 0)
    idx = idx.expand(verts.shape[:-1])
    return torch.gather(verts, -2, idx[..., None].expand(verts.shape))


def _mseg(ax, ay, bx, by):
    """First-moment line-integral terms of segment a->b: ``Cx A = Σ (x_a +
    x_b) cross(a, b) / 6`` (and y alike) and the shoelace term — additive
    along a straight boundary, so partial edges compose exactly."""
    cr = ax * by - ay * bx
    return (ax + bx) * cr / 6.0, (ay + by) * cr / 6.0, cr


def _pad0(a: torch.Tensor) -> torch.Tensor:
    """``[B, n] -> [B, n + 1]`` with a leading zero column."""
    return torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)


def region_stats(p: torch.Tensor, q: torch.Tensor, c_cap: int,
                 with_bbox: bool = False) -> RegionStats:
    """Disjoint regions of P ∩ Q for ``[B, Vp, 2] × [B, Vq, 2]`` CCW pairs.

    ``c_cap``: crossing capacity C (pairs with more crossings get
    ``consistent = False``).  For P \\ Q pass ``reverse_polygons(q, nv_q)``.
    """
    b, vp, _ = p.shape
    vq = q.shape[1]
    c = c_cap
    if c > vp * vq:
        raise ValueError(f"c_cap {c} > Vp*Vq {vp * vq}")
    dev = p.device
    fdt = p.dtype

    p0 = p
    p1 = torch.roll(p, -1, dims=1)
    d = p1 - p0                                       # [B, Vp, 2]
    q0 = q
    q1 = torch.roll(q, -1, dims=1)
    dq = q1 - q0                                      # [B, Vq, 2]

    # ---- crossing detection (same half-open rules as the clip) ------------
    dxe = d[:, :, None, 0]
    dye = d[:, :, None, 1]
    dqx = dq[:, None, :, 0]
    dqy = dq[:, None, :, 1]
    denom = dxe * dqy - dye * dqx                     # [B, Vp, Vq]
    live = torch.abs(denom) > 0
    inv = 1.0 / torch.where(live, denom, torch.ones_like(denom))
    relx = q0[:, None, :, 0] - p0[:, :, None, 0]
    rely = q0[:, None, :, 1] - p0[:, :, None, 1]
    t = (relx * dqy - rely * dqx) * inv               # param along P edge
    s = (relx * dye - rely * dxe) * inv               # param along Q edge
    hit = live & (t >= 0) & (t < 1) & (s >= 0) & (s < 1)
    n_cross = torch.sum(hit, dim=(1, 2)).to(torch.int32)    # [B]

    iota_p = torch.arange(vp, device=dev, dtype=fdt)[None, :, None]
    u = iota_p + t                                    # P-boundary parameter
    key = torch.where(hit, -u, torch.full_like(u, -_BIG)).reshape(b, vp * vq)
    # the C largest keys (ascending u), lower flat index first on ties
    vals, flat = torch.sort(key, dim=1, descending=True, stable=True)
    vals, flat = vals[:, :c], flat[:, :c]
    sel = vals > -_BIG / 2                            # [B, C] slot occupied
    i_c = torch.div(flat, vq, rounding_mode="floor")
    j_c = flat - i_c * vq

    def g2(arr, idx):                                 # [B, V, 2] by [B, C]
        return torch.gather(arr, 1, idx[:, :, None].expand(-1, -1, 2))

    def g1(arr3, flat_idx):                           # [B, Vp, Vq] by flat
        return torch.gather(arr3.reshape(b, vp * vq), 1, flat_idx)

    def at(a, idx):
        return torch.gather(a, 1, idx)

    t_c = g1(t, flat)
    s_c = g1(s, flat)
    delta = -torch.sign(g1(denom, flat))              # +1 P enters CCW Q
    pe0 = g2(p0, i_c)                                 # [B, C, 2]
    de = g2(d, i_c)
    qe0 = g2(q0, j_c)
    pos = pe0 + t_c[:, :, None] * de                  # crossing position
    u_c = i_c.to(fdt) + t_c
    w_c = j_c.to(fdt) + s_c                           # Q-boundary parameter

    m = torch.sum(sel, dim=1)                         # [B] selected count
    slot = torch.arange(c, device=dev)[None]          # [1, C]

    # ---- successors --------------------------------------------------------
    nxt_p = torch.where(slot + 1 < m[:, None], slot + 1, 0)
    wkey = torch.where(sel, w_c, torch.full_like(w_c, _BIG))
    qperm = torch.argsort(wkey, dim=1, stable=True)   # Q-order -> slot
    qrank = torch.argsort(qperm, dim=1, stable=True)  # slot -> Q-order
    nxt_rank = torch.where(qrank + 1 < m[:, None], qrank + 1, 0)
    nxt_q = at(qperm, nxt_rank)
    succ = torch.where(sel, torch.where(delta > 0, nxt_p, nxt_q), slot)

    # ---- consistency -------------------------------------------------------
    alt_p = ~sel | (at(delta, nxt_p) == -delta)
    alt_q = ~sel | (at(delta, nxt_q) == -delta)
    consistent = ((m >= 2) & (m % 2 == 0) & (n_cross <= c)
                  & torch.all(alt_p, dim=1) & torch.all(alt_q, dim=1))

    # ---- orbit labels (pointer doubling) -----------------------------------
    lab = slot.expand(b, c)
    sc = succ
    for _ in range(max(1, math.ceil(math.log2(c)))):
        lab = torch.minimum(lab, at(lab, sc))
        sc = at(sc, sc)

    # ---- per-edge prefix sums ----------------------------------------------
    def prefixes(v0, v1):
        mx_e, my_e, sh_e = _mseg(v0[..., 0], v0[..., 1],
                                 v1[..., 0], v1[..., 1])
        return (_pad0(torch.cumsum(sh_e, dim=1)),
                _pad0(torch.cumsum(mx_e, dim=1)),
                _pad0(torch.cumsum(my_e, dim=1)))

    shp, mxp, myp = prefixes(p0, p1)                  # [B, Vp+1]
    shq, mxq, myq = prefixes(q0, q1)                  # [B, Vq+1]

    def cum_at(pref_sh, pref_mx, pref_my, e0, idx, pt):
        """Boundary-integral potentials F(u) at a crossing: full edges up to
        the crossing's edge + the fractional piece from the edge start."""
        fmx, fmy, fsh = _mseg(e0[..., 0], e0[..., 1], pt[..., 0], pt[..., 1])
        return (at(pref_sh, idx) + fsh, at(pref_mx, idx) + fmx,
                at(pref_my, idx) + fmy)

    f_sh, f_mx, f_my = cum_at(shp, mxp, myp, pe0, i_c, pos)
    g_sh, g_mx, g_my = cum_at(shq, mxq, myq, qe0, j_c, pos)

    # ---- arc integrals (outgoing arc of each crossing) ---------------------
    # P-arc (delta = +1): u_c -> u at the next-P crossing; wraps past vertex
    # 0 only from the largest u to the smallest (slots are u-sorted).
    u2 = at(u_c, nxt_p)
    wrap_p = (u2 <= u_c).to(fdt)
    arc_sh_p = at(f_sh, nxt_p) - f_sh + wrap_p * shp[:, -1:]
    arc_mx_p = at(f_mx, nxt_p) - f_mx + wrap_p * mxp[:, -1:]
    arc_my_p = at(f_my, nxt_p) - f_my + wrap_p * myp[:, -1:]
    chord_p = g2(pos, nxt_p) - pos                    # [B, C, 2]

    # P-arc length + non-zero-segment count (the reference's dl = mean
    # on-boundary edge length, floe_interactions.m:126-131).  Padded
    # (zero-length) edges never carry crossings and are not counted.
    len_e = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)    # [B, Vp]
    nz_e = (len_e > 0).to(fdt)
    lp = _pad0(torch.cumsum(len_e, dim=1))
    np_ = _pad0(torch.cumsum(nz_e, dim=1))
    len_at = at(lp, i_c) + t_c * at(len_e, i_c)
    arc_len_p = at(len_at, nxt_p) - len_at + wrap_p * lp[:, -1:]
    # segments: partial end of the start edge + full edges between + the
    # partial start of the end edge (present only when its t > 0)
    nz_c = at(nz_e, i_c)                              # [B, C]
    full_between = (at(at(np_, i_c), nxt_p) - at(np_, i_c + 1)
                    + wrap_p * np_[:, -1:])
    end_piece = at(nz_c * (t_c > 0).to(fdt), nxt_p)
    arc_cnt_p = nz_c + full_between + end_piece

    # Q-arc (delta = -1): w_c -> w at the next-Q crossing.
    w2 = at(w_c, nxt_q)
    wrap_q = (w2 <= w_c).to(fdt)
    arc_sh_q = at(g_sh, nxt_q) - g_sh + wrap_q * shq[:, -1:]
    arc_mx_q = at(g_mx, nxt_q) - g_mx + wrap_q * mxq[:, -1:]
    arc_my_q = at(g_my, nxt_q) - g_my + wrap_q * myq[:, -1:]

    inp = sel & (delta > 0)
    zero = torch.zeros((), dtype=fdt, device=dev)

    if with_bbox:
        # ---- per-arc bounding boxes (reclip probe only) --------------------
        # Arc extent = its two crossing endpoints + the polygon vertices
        # whose boundary parameter lies strictly inside the arc's (lo, hi)
        # interval (wrapping past parameter 0 when hi <= lo).  Padded
        # vertices repeat vertex 0, which a wrapping arc passes through.
        end_p = pos + chord_p
        end_q = g2(pos, nxt_q)
        endp = torch.where(inp[:, :, None], end_p, end_q)  # [B, C, 2]
        kp = torch.arange(vp, device=dev, dtype=fdt)
        lo_p, hi_p = u_c[:, :, None], u2[:, :, None]
        in_arc_p = torch.where(hi_p <= lo_p, (kp > lo_p) | (kp < hi_p),
                               (kp > lo_p) & (kp < hi_p)) & inp[:, :, None]
        kq = torch.arange(vq, device=dev, dtype=fdt)
        lo_q, hi_q = w_c[:, :, None], w2[:, :, None]
        in_arc_q = torch.where(hi_q <= lo_q, (kq > lo_q) | (kq < hi_q),
                               (kq > lo_q) & (kq < hi_q)) \
            & (sel & ~inp)[:, :, None]
        big = torch.full((), _BIG, dtype=fdt, device=dev)

        def _vmin(coords, mask):                           # -> [B, C]
            return torch.amin(torch.where(mask, coords[:, None, :], big),
                              dim=2)

        def _vmax(coords, mask):
            return torch.amax(torch.where(mask, coords[:, None, :], -big),
                              dim=2)

        e_ok = sel[:, :, None]
        ex = torch.stack([pos[..., 0], endp[..., 0]], -1)
        ey = torch.stack([pos[..., 1], endp[..., 1]], -1)
        sminx = torch.minimum(
            torch.amin(torch.where(e_ok, ex, big), -1),
            torch.minimum(_vmin(p0[..., 0], in_arc_p),
                          _vmin(q0[..., 0], in_arc_q)))
        sminy = torch.minimum(
            torch.amin(torch.where(e_ok, ey, big), -1),
            torch.minimum(_vmin(p0[..., 1], in_arc_p),
                          _vmin(q0[..., 1], in_arc_q)))
        smaxx = torch.maximum(
            torch.amax(torch.where(e_ok, ex, -big), -1),
            torch.maximum(_vmax(p0[..., 0], in_arc_p),
                          _vmax(q0[..., 0], in_arc_q)))
        smaxy = torch.maximum(
            torch.amax(torch.where(e_ok, ey, -big), -1),
            torch.maximum(_vmax(p0[..., 1], in_arc_p),
                          _vmax(q0[..., 1], in_arc_q)))

    contrib_sh = torch.where(inp, arc_sh_p, torch.where(sel, arc_sh_q, zero))
    contrib_mx = torch.where(inp, arc_mx_p, torch.where(sel, arc_mx_q, zero))
    contrib_my = torch.where(inp, arc_my_p, torch.where(sel, arc_my_q, zero))
    contrib_ch = torch.where(inp[:, :, None], chord_p, zero)
    contrib_len = torch.where(inp, arc_len_p, zero)
    contrib_cnt = torch.where(inp, arc_cnt_p, zero)

    # ---- reduce arcs into regions by orbit label ---------------------------
    # ob[b, s, r]: arc slot s belongs to the region rooted at slot r; the
    # reductions are masked sums over s.
    ob = (lab[:, :, None] == slot[:, None, :]) & sel[:, :, None]

    def seg_sum(v):                                   # [B, C] -> [B, C]
        return torch.sum(torch.where(ob, v[:, :, None], zero), dim=1)

    area_r = 0.5 * seg_sum(contrib_sh)
    mx_r = seg_sum(contrib_mx)
    my_r = seg_sum(contrib_my)
    ch_r = torch.stack([seg_sum(contrib_ch[..., 0]),
                        seg_sum(contrib_ch[..., 1])], dim=-1)
    len_r = seg_sum(contrib_len)
    cnt_r = seg_sum(contrib_cnt)

    root = (lab == slot) & sel
    valid = root & consistent[:, None] & (area_r > 0)
    safe = torch.where(area_r > 0, area_r, torch.ones_like(area_r))
    centroid = torch.stack([mx_r / safe, my_r / safe], dim=-1)
    bbox = None
    if with_bbox:
        def seg_ext(v, fill, red):
            return red(torch.where(ob, v[:, :, None], fill), dim=1)

        bbox = torch.stack([
            torch.where(valid, seg_ext(sminx, big, torch.amin), big),
            torch.where(valid, seg_ext(sminy, big, torch.amin), big),
            torch.where(valid, seg_ext(smaxx, -big, torch.amax), -big),
            torch.where(valid, seg_ext(smaxy, -big, torch.amax), -big),
        ], dim=-1)
    return RegionStats(
        area=torch.where(valid, area_r, zero),
        centroid=torch.where(valid[:, :, None], centroid, zero),
        chord=torch.where(valid[:, :, None], ch_r, zero),
        valid=valid,
        consistent=consistent,
        n_cross=n_cross,
        p_len=torch.where(valid, len_r, zero),
        p_cnt=torch.where(valid, cnt_r, zero),
        bbox=bbox,
    )
