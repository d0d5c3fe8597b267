"""The port's geometry surface against the JAX package's, on the CPU.

* The segment-midpoint clip: ``overlap_stats``, ``difference_stats``,
  ``intersection_area`` (the vmapped form) and ``overlap_stats_bm`` /
  ``difference_stats_bm`` (the batch-minor form, ``contact_impl="xla"``) on
  random convex and concave pairs, Vp != Vq, and test_torch_clip.py's
  degenerate battery: float64 within 1e-12 of each field's scale with
  n_cross exactly equal; float32 at 1000 m scale within test_torch_clip.py's
  float32 bounds (area 1e-5 max|area|, chord 1e-2, n_cross exact).  The
  port's two forms agree with each other, and chunking a batch changes no
  pair's result.
* ``indicator_integrals_bm``, ``segment_intersections`` (points, mask and
  count), ``point_poly_dist`` and the polygon helpers ``apply_padding``,
  ``poly_inertia_z``, ``poly_rmax`` and ``poly_angles`` at 1e-12.
* Every name of ``subzero_tpu.geometry.__all__`` exists in the port.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.geometry as jgeo
from subzero_tpu.geometry import clip as jclip
from subzero_tpu.geometry import clip_batched as jbm
from subzero_tpu.geometry import clip_integral as jint
from subzero_tpu.geometry import measures as jmeas
from subzero_tpu.geometry import polygon as jpoly

import subzero_tpu_torch.geometry as tgeo
from subzero_tpu_torch.geometry import clip as tclip
from subzero_tpu_torch.geometry import clip_batched as tbm
from subzero_tpu_torch.geometry import clip_integral as tint
from subzero_tpu_torch.geometry import measures as tmeas
from subzero_tpu_torch.geometry import polygon as tpoly
from test_torch_clip import ELL, STAR, concave_batch, degenerate_battery, \
    random_batch

torch.set_num_threads(1)

FIELDS = ("area", "centroid", "chord_p")


def mixed_batch():
    """30 random convex pairs, 30 concave pairs (an L against a 5-armed
    star) and the degenerate battery, Vp = Vq = 16, in one batch (one JAX
    compile per function)."""
    parts = [random_batch(30, seed=2), concave_batch(30, seed=3),
             degenerate_battery()]
    return (np.concatenate([a for a, _ in parts]),
            np.concatenate([b for _, b in parts]))


SHAPES = {"16x16": (16, 16), "16x8": (16, 8), "8x24": (8, 24)}


def batch(shape):
    vp, vq = SHAPES[shape]
    if vp == vq:
        return mixed_batch()
    # concave polygons need all 10 star slots: random convex pairs here
    return random_batch(40, seed=4 + vp, vp=vp, vq=vq)


def assert_stats(got, want, rel, nc_exact=True):
    """Each field within ``rel`` of its scale (max |want|, at least 1)."""
    for name in FIELDS:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        scale = max(float(np.max(np.abs(b))), 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale,
                                   err_msg=name)
    if nc_exact:
        np.testing.assert_array_equal(got.n_cross.numpy(),
                                      np.asarray(want.n_cross))
    assert got.n_cross.dtype == torch.int32


CLIPS = {
    "overlap_stats": (jclip.overlap_stats, tclip.overlap_stats),
    "difference_stats": (jclip.difference_stats, tclip.difference_stats),
    "overlap_stats_bm": (jbm.overlap_stats_bm, tbm.overlap_stats_bm),
    "difference_stats_bm": (jbm.difference_stats_bm,
                            tbm.difference_stats_bm),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("fn", sorted(CLIPS))
def test_midpoint_clip_matches_jax_f64(fn, shape):
    p, q = batch(shape)
    jfn, tfn = CLIPS[fn]
    want = jfn(jnp.asarray(p), jnp.asarray(q))
    got = tfn(torch.from_numpy(p), torch.from_numpy(q))
    assert_stats(got, want, 1e-12)


@pytest.mark.parametrize("fn", sorted(CLIPS))
def test_midpoint_clip_matches_jax_f32(fn):
    p, q = (1000.0 * x for x in mixed_batch())
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    jfn, tfn = CLIPS[fn]
    want = jfn(jnp.asarray(p32), jnp.asarray(q32))
    got = tfn(torch.from_numpy(p32), torch.from_numpy(q32))
    scale = float(np.max(np.abs(np.asarray(want.area))))
    np.testing.assert_allclose(got.area.numpy(), np.asarray(want.area),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.chord_p.numpy(), np.asarray(want.chord_p),
                               rtol=0, atol=1e-2)
    np.testing.assert_array_equal(got.n_cross.numpy(),
                                  np.asarray(want.n_cross))


@pytest.mark.parametrize("difference", [False, True])
def test_vmapped_and_batch_minor_forms_agree(difference, monkeypatch):
    p, q = (torch.from_numpy(x) for x in mixed_batch())
    if difference:
        one, bm = tclip.difference_stats, tbm.difference_stats_bm
    else:
        one, bm = tclip.overlap_stats, tbm.overlap_stats_bm
    a, b = one(p, q), bm(p, q)
    assert_stats(a, b, 1e-12)
    # one pair per chunk: every pair's result is unchanged
    monkeypatch.setitem(tclip.CHUNK_ELEMS, "cpu", 1)
    for whole, split in ((a, one(p, q)), (b, bm(p, q))):
        for x, y in zip(whole, split):
            assert torch.equal(x, y)


def test_intersection_area_matches_jax():
    p, q = mixed_batch()
    got = tclip.intersection_area(torch.from_numpy(p), torch.from_numpy(q))
    want = jclip.intersection_area(jnp.asarray(p), jnp.asarray(q))
    scale = float(np.max(np.abs(np.asarray(want))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 * scale)
    for k in (0, 35, len(p) - 3):          # one pair, no batch axis
        got = tclip.intersection_area(torch.from_numpy(p[k]),
                                      torch.from_numpy(q[k]))
        want = jclip.intersection_area(jnp.asarray(p[k]), jnp.asarray(q[k]))
        assert abs(float(got) - float(want)) <= 1e-12 * max(scale, 1.0)


def test_collinear_edge_area_loss_is_the_reference_s():
    # A fault of the reference kept for parity (ROADMAP §C): two steps into
    # the out-of-box recipe (seed 1, corners off) the wall floes lie almost
    # on the Eulerian cell edges, and the segment-midpoint clip misses
    # millions of m^2 of some floe x cell overlaps.  The port's clip misses
    # the same areas as the JAX package's; the native engine's exact
    # intersection shows the loss.
    from subzero_tpu_torch.config import ProcessConfig
    from subzero_tpu_torch.diagnostics import cell_grid
    from subzero_tpu_torch.native import poly_area, poly_boolean
    from subzero_tpu_torch.sim import out_of_box_sim

    sim = out_of_box_sim(seed=1, device="cpu", dtype="float64")
    sim.cfg = sim.cfg.replace(processes=ProcessConfig(corners=False))
    sim.run(2)
    cells, _, _ = cell_grid(sim.cfg, 10, 10)
    alive = np.nonzero(sim.state.alive.numpy())[0]
    vw = sim.state.verts_world().numpy()[alive]
    nv = sim.state.nv.numpy()[alive]
    p = np.repeat(vw, len(cells), axis=0)
    q = np.tile(cells, (len(alive), 1, 1))
    got = tclip.overlap_stats(torch.from_numpy(p), torch.from_numpy(q))
    want = jclip.overlap_stats(jnp.asarray(p), jnp.asarray(q))
    assert_stats(got, want, 1e-12)
    exact = np.array([sum(poly_area(r) for r in poly_boolean(
        vw[i, :nv[i]], c, "int")) for i in range(len(alive)) for c in cells])
    assert np.max(np.abs(got.area.numpy() - exact)) > 1e6


def test_indicator_integrals_match_jax():
    p, q = mixed_batch()
    planes = []
    for a in (p, q):
        a1 = np.roll(a, -1, axis=1)
        planes += [a[:, :, 0].T, a[:, :, 1].T, (a1 - a)[:, :, 0].T,
                   (a1 - a)[:, :, 1].T]
    eps = np.maximum(np.maximum(np.abs(p).max(axis=(1, 2)),
                                np.abs(q).max(axis=(1, 2))), 1.0) * 1e-10
    want = jint.indicator_integrals_bm(*(jnp.asarray(x) for x in planes),
                                       jnp.asarray(eps))
    got = tint.indicator_integrals_bm(*(torch.from_numpy(x) for x in planes),
                                      torch.from_numpy(eps))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    assert float(got[0].max()) > 0.5                  # edges inside Q occur


@pytest.mark.parametrize("k", range(6))
def test_segment_intersections_match_jax(k):
    p, q = mixed_batch()
    pick = [0, 7, 33, 41, 60, 64][k]              # convex, concave, degenerate
    for max_points in (4, 40):
        want = jmeas.segment_intersections(jnp.asarray(p[pick]),
                                           jnp.asarray(q[pick]), max_points)
        got = tmeas.segment_intersections(torch.from_numpy(p[pick]),
                                          torch.from_numpy(q[pick]),
                                          max_points)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[2]) == int(want[2])


def test_point_poly_dist_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-2.5, 2.5, size=(300, 2))
    for poly in (ELL, 1.5 * STAR):
        verts = tpoly.pad_polygon(poly, 16)[0]
        want = jmeas.point_poly_dist(jnp.asarray(pts), jnp.asarray(verts))
        got = tmeas.point_poly_dist(torch.from_numpy(pts),
                                    torch.from_numpy(verts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
        assert (got < 0).any() and (got > 0).any()


def test_polygon_helpers_match_jax():
    rng = np.random.default_rng(6)
    p, _ = mixed_batch()
    nv = rng.integers(3, 17, size=len(p)).astype(np.int32)
    h = rng.uniform(0.2, 2.0, size=len(p))
    center = rng.uniform(-0.3, 0.3, size=(len(p), 2))
    tp, tnv = torch.from_numpy(p), torch.from_numpy(nv)
    jp, jnv = jnp.asarray(p), jnp.asarray(nv)
    pairs = [
        (tpoly.apply_padding(tp, tnv), jpoly.apply_padding(jp, jnv)),
        (tpoly.poly_inertia_z(tp, torch.from_numpy(h)),
         jpoly.poly_inertia_z(jp, jnp.asarray(h))),
        (tpoly.poly_rmax(tp), jpoly.poly_rmax(jp)),
        (tpoly.poly_rmax(tp, torch.from_numpy(center)),
         jpoly.poly_rmax(jp, jnp.asarray(center))),
        # the padded polygons' own counts, and random ones
        (tpoly.poly_angles(tp, torch.full_like(tnv, 16)),
         jpoly.poly_angles(jp, jnp.full_like(jnv, 16))),
        (tpoly.poly_angles(tp, tnv), jpoly.poly_angles(jp, jnv)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        scale = max(float(np.max(np.abs(want))), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * scale)
    ell = torch.from_numpy(tpoly.pad_polygon(ELL, 8)[0])
    ang = tpoly.poly_angles(ell, torch.tensor(6))
    np.testing.assert_allclose(ang[:6].numpy(), [90, 90, 90, 270, 90, 90],
                               atol=1e-12)


def test_geometry_surface_covers_jax():
    missing = [n for n in jgeo.__all__ if not hasattr(tgeo, n)]
    assert not missing
    assert set(jgeo.__all__) <= set(tgeo.__all__)
