"""The port's plain parity-integral clip against the JAX package's.

* float64: ``subzero_tpu_torch.geometry.clip_integral`` against
  ``overlap_stats_int`` / ``difference_stats_int`` at 1e-12 on area and
  chord, n_cross exactly equal, on random convex batches, the degenerate
  battery of test_clip_integral.py and mixed vertex capacities (Vp != Vq);
* float32 at 1000 m scale: the same plain clip against the Pallas kernel in
  interpret mode, with the Pallas tolerances of test_clip_integral.py
  (area within 1e-5 max|area|, chord within 1e-2, n_cross exactly equal);
* the invariance the CUDA kernel's compacted edge lists rest on: inserting
  duplicate vertices mid-polygon, or widening the padding (V 16 -> 24 -> 64),
  leaves area, centroid and chord equal within 1e-12 relative and n_cross
  exactly equal, in the port and in the JAX package;
* the dispatching wrapper (``kernels/clip.py``) on CPU tensors is the plain
  version.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.geometry.clip_integral import (
    difference_stats_int, overlap_stats_int,
)
from subzero_tpu.geometry.clip_pallas import (
    difference_stats_pallas, overlap_stats_pallas,
)
from oracles import random_convex

from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
from subzero_tpu_torch.geometry.polygon import pad_polygon, pad_polygons
from subzero_tpu_torch import trace
from subzero_tpu_torch.kernels import clip as kclip

from chip_smoke import with_duplicates

torch.set_num_threads(1)

SQUARE = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
ELL = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], dtype=float)
STAR = np.array([[np.cos(t) * r, np.sin(t) * r] for t, r in zip(
    np.linspace(0, 2 * np.pi, 10, endpoint=False),
    [1.0, 0.45] * 5)])


def random_batch(n, seed, scale=1.0, vp=16, vq=16):
    rng = np.random.default_rng(seed)
    ps, qs = [], []
    for _ in range(n):
        ps.append(scale * random_convex(rng, center=(0, 0)))
        qs.append(scale * random_convex(
            rng, center=(rng.uniform(0, 1.5), rng.uniform(-0.5, 0.5))))
    return pad_polygons(ps, vp)[0], pad_polygons(qs, vq)[0]


def concave_batch(n, seed, scale=1.0, v=16):
    """Random rotations/offsets of an L and a 5-armed star: multi-crossing
    concave pairs."""
    rng = np.random.default_rng(seed)
    ps, qs = [], []
    for _ in range(n):
        a, b = rng.uniform(0, 2 * np.pi, 2)
        ra = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        rb = np.array([[np.cos(b), -np.sin(b)], [np.sin(b), np.cos(b)]])
        ps.append(scale * (ELL - 1.0) @ ra.T)
        qs.append(scale * (1.5 * STAR @ rb.T + rng.uniform(-0.7, 0.7, 2)))
    return pad_polygons(ps, v)[0], pad_polygons(qs, v)[0]


def degenerate_battery():
    cases = [
        (SQUARE, SQUARE.copy()),             # identical
        (SQUARE, SQUARE + [1.5, 0.0]),       # collinear rails
        (SQUARE, SQUARE + [2.0, 0.0]),       # shared edge
        (SQUARE, 0.25 * SQUARE),             # contained
        (SQUARE, SQUARE + [1.0, 1.0]),       # corner overlap
        (SQUARE, SQUARE + [5.0, 0.0]),       # disjoint
    ]
    p = np.stack([pad_polygon(c[0], 16)[0] for c in cases])
    q = np.stack([pad_polygon(c[1], 16)[0] for c in cases])
    return p, q


def batches():
    return {
        "convex": random_batch(60, seed=2),
        "concave": concave_batch(60, seed=3),
        "degenerate": degenerate_battery(),
        "vp16_vq8": random_batch(40, seed=4, vp=16, vq=8),
        "vp8_vq24": random_batch(40, seed=5, vp=8, vq=24),
    }


def widen(poly, v_out):
    """Rows of ``poly`` re-padded to ``v_out`` slots with vertex 0."""
    out = np.repeat(poly[:, :1], v_out, axis=1)
    out[:, :poly.shape[1]] = poly
    return out


def _close(jax_st, torch_st, atol_area, atol_chord):
    np.testing.assert_allclose(torch_st.area.numpy(),
                               np.asarray(jax_st.area), rtol=0,
                               atol=atol_area)
    np.testing.assert_allclose(torch_st.chord_p.numpy(),
                               np.asarray(jax_st.chord_p), rtol=0,
                               atol=atol_chord)
    np.testing.assert_array_equal(torch_st.n_cross.numpy(),
                                  np.asarray(jax_st.n_cross))
    assert torch_st.n_cross.dtype == torch.int32


@pytest.mark.parametrize("difference", [False, True])
@pytest.mark.parametrize("name", ["convex", "concave", "degenerate",
                                  "vp16_vq8", "vp8_vq24"])
def test_plain_clip_matches_jax_f64(name, difference):
    p, q = batches()[name]
    jfn = difference_stats_int if difference else overlap_stats_int
    want = jfn(jnp.asarray(p), jnp.asarray(q))
    got = clip_integral_bm(torch.from_numpy(p), torch.from_numpy(q),
                           difference)
    _close(want, got, 1e-12, 1e-12)
    # centroids: relative to the pair's scale (mx/area amplifies roundoff
    # where the overlap is a sliver)
    np.testing.assert_allclose(got.centroid.numpy(),
                               np.asarray(want.centroid), rtol=0, atol=1e-9)


@pytest.mark.parametrize("name,difference", [
    ("mixed", False), ("mixed", True),
    ("vp16_vq8", True),                  # the wall-contact shape
])
def test_plain_clip_matches_pallas_f32(name, difference):
    # (each Pallas interpret-mode shape costs seconds to trace, so the
    # convex and concave pairs share one batch)
    if name == "mixed":
        pc, qc = random_batch(30, seed=6)
        pk, qk = concave_batch(30, seed=7)
        p, q = np.concatenate([pc, pk]), np.concatenate([qc, qk])
    else:
        p, q = batches()[name]
    p32 = (1000.0 * p).astype(np.float32)
    q32 = (1000.0 * q).astype(np.float32)
    jfn = difference_stats_pallas if difference else overlap_stats_pallas
    want = jfn(jnp.asarray(p32), jnp.asarray(q32), interpret=True)
    got = clip_integral_bm(torch.from_numpy(p32), torch.from_numpy(q32),
                           difference)
    scale = float(np.max(np.abs(np.asarray(want.area))))
    _close(want, got, 1e-5 * scale, 1e-2)


def test_wrapper_uses_plain_version_on_cpu():
    p, q = batches()["convex"]
    with trace.recording(trace.Table()) as table:
        for difference in (False, True):
            fn = (kclip.difference_stats if difference
                  else kclip.overlap_stats)
            a = fn(torch.from_numpy(p), torch.from_numpy(q))
            b = clip_integral_bm(torch.from_numpy(p), torch.from_numpy(q),
                                 difference)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    assert "clip.launches" not in table.counts
    with pytest.raises(TypeError):
        kclip.overlap_stats(torch.from_numpy(p).float(), torch.from_numpy(q))
    with pytest.raises(ValueError):
        kclip.overlap_stats(torch.from_numpy(p)[:3], torch.from_numpy(q))


@pytest.mark.parametrize("difference", [False, True])
@pytest.mark.parametrize("how,v_out", [("pad", 24), ("pad", 64),
                                       ("dup", 24), ("dup", 64)])
def test_zero_length_edges_change_nothing(how, v_out, difference):
    pc, qc = random_batch(30, seed=8)
    pk, qk = concave_batch(30, seed=9)
    p, q = np.concatenate([pc, pk]), np.concatenate([qc, qk])
    if how == "pad":
        pw, qw = widen(p, v_out), widen(q, v_out)
    else:                  # duplicates inside, not only longer padding
        pw = with_duplicates(p, v_out, 10 + v_out)
        qw = with_duplicates(q, v_out, 20 + v_out)
        assert (pw != widen(p, v_out)).any() and (qw != widen(q, v_out)).any()
    base = clip_integral_bm(torch.from_numpy(p), torch.from_numpy(q),
                            difference)
    got = clip_integral_bm(torch.from_numpy(pw), torch.from_numpy(qw),
                           difference)
    jfn = difference_stats_int if difference else overlap_stats_int
    want = jfn(jnp.asarray(pw), jnp.asarray(qw))
    for other in (base, want):
        for name in ("area", "centroid", "chord_p"):
            a = getattr(got, name).numpy()
            b = np.asarray(getattr(other, name))
            scale = max(float(np.max(np.abs(b))), 1.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale,
                                       err_msg=name)
        np.testing.assert_array_equal(got.n_cross.numpy(),
                                      np.asarray(other.n_cross))
