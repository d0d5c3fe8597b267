"""The port's native polygon engine, host geometry and ``cut_polygon``
against the JAX package's, on the CPU.

The port builds its own copy of ``polyboolean.cpp`` into
``subzero_tpu_torch/_build/``; for the same inputs its results must be
identical to the JAX package's library (same source, same flags): the
contours of every boolean op on seeded concave pairs, areas and the left
fold of ``union_all``, compared with ``np.array_equal``.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import pytest
import torch

import subzero_tpu.hostgeom as jhg
import subzero_tpu.native as jnative
from subzero_tpu.geometry.measures import cut_polygon as jcut

import subzero_tpu_torch.hostgeom as thg
import subzero_tpu_torch.native as tnative
from subzero_tpu_torch.geometry.measures import cut_polygon as tcut

torch.set_num_threads(1)


def star(rng, n_arms, r_mean, c):
    """A concave star of 2*n_arms vertices (CCW) around ``c``."""
    n = 2 * n_arms
    th = np.linspace(0, 2 * np.pi, n + 1)[:-1] + rng.uniform(0, np.pi / n)
    r = r_mean * (1 + 0.45 * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
                  + rng.uniform(-0.1, 0.1, n))
    return np.stack([c[0] + r * np.cos(th), c[1] + r * np.sin(th)], axis=1)


def concave_pairs(n_pairs=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_pairs):
        p = star(rng, int(rng.integers(4, 9)), 1e4, (0.0, 0.0))
        q = star(rng, int(rng.integers(4, 9)), 1e4,
                 rng.uniform(-1.2e4, 1.2e4, 2))
        out.append((p, q))
    return out


def assert_contours_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("op", ["int", "uni", "dif", "xor"])
def test_poly_boolean_matches_jax(op):
    n_nonempty = 0
    for p, q in concave_pairs():
        got = tnative.poly_boolean(p, q, op)
        assert_contours_equal(got, jnative.poly_boolean(p, q, op))
        n_nonempty += bool(got)
    assert n_nonempty > 10


def test_poly_boolean_multi_contour_inputs_match_jax():
    # a contour list in (outer CCW + hole CW): the engine's multi-contour
    # path, and the same squares touching along an edge (collinear edges)
    sq = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    outer, hole = 3e4 * sq, (1e4 * sq)[::-1]
    for q in (2e4 * sq + [1e4, 0.0], 3e4 * sq + [6e4, 0.0],
              3e4 * sq + [3e4, 1e4]):
        for op in ("int", "uni", "dif", "xor"):
            assert_contours_equal(
                tnative.poly_boolean([outer, hole], q, op),
                jnative.poly_boolean([outer, hole], q, op))


def test_poly_area_and_union_all_match_jax():
    pairs = concave_pairs(seed=1)
    for p, _ in pairs:
        assert tnative.poly_area(p) == jnative.poly_area(p)
    polys = [p for pq in pairs[:12] for p in pq]
    assert_contours_equal(tnative.union_all(polys), jnative.union_all(polys))
    assert tnative.union_all([]) == jnative.union_all([]) == []


def test_hostgeom_and_cut_polygon_match_jax():
    rng = np.random.default_rng(2)
    for p, _ in concave_pairs(n_pairs=10, seed=2):
        assert thg.area(p) == jhg.area(p)
        assert np.array_equal(thg.centroid(p), jhg.centroid(p))
        assert thg.inertia_z(p, 0.7) == jhg.inertia_z(p, 0.7)
        assert thg.rmax_of(p) == jhg.rmax_of(p)
        assert np.array_equal(thg.angles_deg(p), jhg.angles_deg(p))
        a, b = rng.uniform(-1e4, 1e4, (2, 2))
        for side in (1, 2):
            assert np.array_equal(tcut(p, a, b, side), jcut(p, a, b, side))


def test_library_builds_into_the_build_dir():
    tnative.poly_area(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]))
    lib = tnative._LIB
    assert lib.parent == tnative.BUILD_DIR
    assert lib.parent.name == "_build"
    assert lib.exists()
    assert not list(tnative._SRC.parent.glob("*.so"))
    assert lib.resolve() != (jnative._HERE / "libpolyboolean.so").resolve()


def test_loader_rebuilds_a_stale_library_and_raises_on_failure(
        tmp_path, monkeypatch):
    src = tmp_path / "polyboolean.cpp"
    shutil.copy(tnative._SRC, src)
    lib = tmp_path / "_build" / "libpolyboolean.so"
    monkeypatch.setattr(tnative, "_SRC", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", lib.parent)
    monkeypatch.setattr(tnative, "_LIB", lib)
    monkeypatch.setattr(tnative, "_lib", None)
    tri = np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 2.0]])
    assert tnative.poly_area(tri) == 2.0
    built = lib.stat().st_mtime_ns
    # a source newer than the library is rebuilt at the next load
    future = time.time() + 10
    os.utime(src, (future, future))
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.poly_area(tri) == 2.0
    assert lib.stat().st_mtime_ns != built
    # a failed build raises, with the compiler's message
    src.write_text("this is not C++\n")
    os.utime(src, (future + 10, future + 10))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        tnative.poly_area(tri)
