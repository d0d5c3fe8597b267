"""The port's per-region decomposition (``subzero_tpu_torch.geometry.regions``)
against the JAX package's, float64 on the CPU, from the same numpy inputs.

Shapes of tests/test_regions.py (offset squares, the U-shape with two
regions, a difference via ``reverse_polygons``, a degenerate shared edge,
seeded concave stars), with and without bounding boxes and with Vp != Vq,
plus an input whose crossings tie exactly on their P-boundary parameter.
``valid``, ``consistent``, ``n_cross`` and ``reverse_polygons`` must be
identical; the float statistics agree within 1e-12 of each field's scale.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.geometry.polygon import pad_polygon
from subzero_tpu.geometry.regions import region_stats, reverse_polygons

from subzero_tpu_torch.geometry import regions as tregions

torch.set_num_threads(1)

SQ = np.array([[0.0, 0.0], [4.0, 0.0], [4.0, 4.0], [0.0, 4.0]])
U_SHAPE = np.array([[0, 0], [6, 0], [6, 5], [4, 5], [4, 2], [2, 2], [2, 5],
                    [0, 5]], float)
BAR = np.array([[-1, 4], [7, 4], [7, 6], [-1, 6]], float)
DOM = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], float)
FLOE = np.array([[-2, 4], [12, 4], [12, 6], [-2, 6]], float)
# Q passes through X = (2, 0) twice, on P=SQ's bottom edge: the edges
# leaving X both cross that edge at t = 0.5, so two crossings have exactly
# the same P-boundary parameter (and key).
PINCHED = np.array([[0.5, -1.0], [2.0, 0.0], [1.5, 2.0], [2.5, 2.0],
                    [2.0, 0.0], [3.5, -1.0]])


def _stars(n, seed, spread=4.0):
    """Seeded pairs of concave stars with 4-5 arms (8-10 vertices), radii
    alternating about 3 +- 1.35, the second one offset: many overlaps split
    into several regions."""
    rng = np.random.default_rng(seed)

    def star(cx, cy):
        nv = 2 * int(rng.integers(4, 6))
        th = np.linspace(0, 2 * np.pi, nv + 1)[:-1] + rng.uniform(0, np.pi)
        r = 3.0 * (1 + 0.45 * np.where(np.arange(nv) % 2 == 0, 1.0, -1.0)
                   + rng.uniform(-0.1, 0.1, nv))
        return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=-1)

    return [(star(0.0, 0.0), star(*rng.uniform(-spread, spread, 2)))
            for _ in range(n)]


def _batch(pairs, vp, vq):
    p = np.stack([pad_polygon(a, vp)[0] for a, _ in pairs])
    q = np.stack([pad_polygon(b, vq)[0] for _, b in pairs])
    return p, q


def _compare(p, q, c_cap, with_bbox):
    # (eagerly, as tests/test_regions.py runs it: under jit XLA reorders
    # the sums, and a sliver region's centroid moves by 4e-12 relative)
    want = region_stats(jnp.asarray(p), jnp.asarray(q), c_cap,
                        with_bbox=with_bbox)
    got = tregions.region_stats(torch.tensor(p), torch.tensor(q),
                                c_cap, with_bbox=with_bbox)
    for f in ("valid", "consistent", "n_cross"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.n_cross.dtype == torch.int32
    fields = ["area", "centroid", "chord", "p_len", "p_cnt"]
    if with_bbox:
        fields.append("bbox")
    else:
        assert got.bbox is None and want.bbox is None
    for f in fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape, f
        if f == "bbox":
            # +-1e30 sentinels of invalid slots must match exactly; the
            # scale of the real extents is that of the coordinates
            w_big = np.abs(w) >= 1e29
            np.testing.assert_array_equal(g[w_big], w[w_big], err_msg=f)
            w, g = w[~w_big], g[~w_big]
        scale = max(1.0, float(np.max(np.abs(w)))) if w.size else 1.0
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * scale,
                                   err_msg=f)
    return got


SHAPES = {
    "square_offset": [(SQ, SQ + [3.0, 1.5]), (SQ, SQ + [3.0, 0.5])],
    "u_shape": [(U_SHAPE, BAR)],
    "shared_edge": [(SQ, SQ + [4.0, 0.0]), (SQ, SQ + [0.0, 4.0]),
                    (SQ, SQ)],
    "pinched_tie": [(SQ, PINCHED), (PINCHED, SQ)],
}


@pytest.mark.parametrize("with_bbox", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_region_stats_shapes(name, with_bbox):
    # every case padded to three pairs, so that the eager JAX reference
    # compiles its primitives once for all of them
    pairs = SHAPES[name]
    p, q = _batch((pairs * 3)[:3], 16, 16)
    got = _compare(p, q, 8, with_bbox)
    if name == "u_shape":
        assert int(got.valid[0].sum()) == 2
    if name == "pinched_tie":
        # the tie is real: two crossings share their P-boundary parameter
        u = _crossing_params(p[0], q[0])
        assert len(u) == int(got.n_cross[0]) and len(set(u)) < len(u)


def _crossing_params(p, q):
    """P-boundary parameters i + t of the proper crossings of one pair."""
    out = []
    for i in range(len(p)):
        d = p[(i + 1) % len(p)] - p[i]
        for j in range(len(q)):
            dq = q[(j + 1) % len(q)] - q[j]
            den = d[0] * dq[1] - d[1] * dq[0]
            if den == 0:
                continue
            rel = q[j] - p[i]
            t = (rel[0] * dq[1] - rel[1] * dq[0]) * (1.0 / den)
            s = (rel[0] * d[1] - rel[1] * d[0]) * (1.0 / den)
            if 0 <= t < 1 and 0 <= s < 1:
                out.append(i + t)
    return out


def test_difference_via_reversal():
    a1, _ = pad_polygon(FLOE, 16)
    a2, nv2 = pad_polygon(DOM, 8)
    q = a2[None]
    want_rev = np.asarray(reverse_polygons(jnp.asarray(q),
                                           jnp.asarray([nv2])))
    got_rev = tregions.reverse_polygons(torch.from_numpy(q),
                                        torch.tensor([nv2])).numpy()
    np.testing.assert_array_equal(got_rev, want_rev)
    for with_bbox in (False, True):
        got = _compare(a1[None], want_rev, 8, with_bbox)
        assert bool(got.consistent[0]) and int(got.valid.sum()) == 2


def test_reverse_polygons_batch():
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(2, 5, 12, 2))
    nv = rng.integers(3, 13, size=(2, 5))
    want = np.asarray(reverse_polygons(jnp.asarray(verts), jnp.asarray(nv)))
    got = tregions.reverse_polygons(torch.from_numpy(verts),
                                    torch.from_numpy(nv)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vp,vq,c_cap,with_bbox", [
    (16, 16, 16, False), (16, 16, 16, True), (10, 20, 16, True),
    (10, 16, 8, False)])
def test_region_stats_star_ensemble(vp, vq, c_cap, with_bbox):
    pairs = _stars(60, seed=7 + vp + vq)
    p, q = _batch(pairs, vp, vq)
    got = _compare(p, q, c_cap, with_bbox)
    # the decomposition handles the generic case and finds multi-region
    # overlaps (concave stars)
    assert int(got.consistent.sum()) >= 40
    assert int((got.valid.sum(dim=1) >= 2).sum()) >= 3
