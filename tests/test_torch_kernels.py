"""The Hopper clip kernels and their wrappers: ``csrc/clip.cu`` (the XLA
twin's clip) and ``csrc/clip_pallas.cu`` (the Pallas kernel's).  This file
imports no JAX, so the card tests run on a machine without it:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

On a machine without CUDA the card test skips; the others check that the
kernel module imports and serves CPU tensors without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from subzero_tpu_torch import trace
from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
from subzero_tpu_torch.geometry.clip_pallas import _clip_pallas
from subzero_tpu_torch.geometry.polygon import pad_polygons
from subzero_tpu_torch.kernels import clip as kclip
from subzero_tpu_torch.kernels import clip_pallas as kpallas

from chip_smoke import (
    coastline_pair, degenerate_pairs, one_past_tile, random_pairs,
    with_duplicates,
)

torch.set_num_threads(1)


def pairs(n, seed, vp=16, vq=16, scale=1000.0):
    """Seeded random convex and concave (star) pairs at ``scale`` meters."""
    rng = np.random.default_rng(seed)

    def poly(nv_max, center):
        k = int(rng.integers(3, nv_max + 1))
        th = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.5, 1.0, k)
        if k >= 6 and rng.random() < 0.5:       # concave: alternate radii
            r = np.where(np.arange(k) % 2 == 0, r, 0.4 * r)
        return scale * (np.stack([r * np.cos(th), r * np.sin(th)], 1)
                        + center)

    ps = [poly(vp, (0.0, 0.0)) for _ in range(n)]
    qs = [poly(vq, rng.uniform(-1.2, 1.2, 2)) for _ in range(n)]
    return pad_polygons(ps, vp)[0], pad_polygons(qs, vq)[0]


def card_case(name):
    if name == "duplicates":
        p, q = pairs(300, seed=21, vp=16, vq=16)
        return with_duplicates(p, 24, 22), with_duplicates(q, 24, 23)
    if name == "degenerate":
        return degenerate_pairs()
    if name == "b1":
        return pairs(1, seed=8)                 # 10 crossings
    b, vp, vq = {"vp64_vq8": (700, 64, 8), "vp8_vq64": (700, 8, 64),
                 "triangles": (500, 3, 3),
                 "one_past_tile": (one_past_tile(16, 16), 16, 16)}[name]
    return pairs(b, seed=b + vp + 3 * vq, vp=vp, vq=vq)


def test_lane_group_is_a_power_of_two_that_fits():
    for b in (1, 2, 7, 13, 64, 129, 1000, 10240, 81920, 163840, 10 ** 7):
        for vp in (1, 3, 4, 8, 16, 24, 64, 100, 300):
            for vq in (1, 3, 8, 16, 64, 300):
                g = kclip.lane_group(b, vp, vq)
                assert g in (1, 2, 4, 8, 16, 32), (b, vp, vq, g)
                assert kclip.tile_bytes(g, vp, vq, 8) <= kclip.SMEM_LIMIT
    # few lanes at the quad lattice, more for small B or wide polygons
    assert kclip.lane_group(81920, 16, 16) <= 4
    assert kclip.lane_group(1, 16, 16) >= 8
    assert kclip.lane_group(163840, 64, 64) >= 8
    # a tile that cannot fit even at 32 lanes
    assert kclip.tile_bytes(32, 1000, 1000, 8) > kclip.SMEM_LIMIT


@pytest.mark.parametrize("name", ["duplicates", "degenerate", "vp64_vq8",
                                  "vp8_vq64", "b1", "one_past_tile",
                                  "triangles"])
def test_card_cases_are_valid_polygon_pairs(name):
    """The card cases on the CPU: the plain version gives finite areas and
    some overlap, and the widened (duplicate-vertex) pairs the same
    statistics as the originals."""
    p, q = card_case(name)
    got = clip_integral_bm(torch.from_numpy(p), torch.from_numpy(q), False)
    assert bool(torch.isfinite(got.area).all())
    assert float(got.area.abs().max()) > 0
    if name == "duplicates":
        p0, q0 = pairs(300, seed=21, vp=16, vq=16)
        want = clip_integral_bm(torch.from_numpy(p0), torch.from_numpy(q0),
                                False)
        scale = float(want.area.abs().max())
        assert float((got.area - want.area).abs().max()) <= 1e-12 * scale
        assert torch.equal(got.n_cross, want.n_cross)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,vp,vq", [(13, 16, 16), (4096, 16, 16),
                                      (1000, 16, 8), (512, 64, 64)])
def test_kernel_matches_plain_on_card(dtype, b, vp, vq):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _hold_on_card(*pairs(b, seed=b + vp, vp=vp, vq=vq), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["duplicates", "degenerate", "vp64_vq8",
                                  "vp8_vq64", "b1", "one_past_tile",
                                  "triangles"])
def test_kernel_matches_plain_on_card_edge_cases(dtype, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _hold_on_card(*card_case(name), dtype)


def test_module_serves_cpu_without_building(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(kclip, "build", no_build)
    p, q = pairs(13, seed=0)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    with trace.recording(trace.Table()) as table:
        got = kclip.overlap_stats(pt, qt)
    want = clip_integral_bm(pt, qt, False)
    assert torch.equal(got.area, want.area)
    assert torch.equal(got.n_cross, want.n_cross)
    assert "clip.launches" not in table.counts


def test_kernel_entry_refuses_cpu_tensors():
    p, q = pairs(4, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        kclip.clip_stats_cuda(torch.from_numpy(p), torch.from_numpy(q), False)


def _hold_on_card(p, q, dtype):
    pt = torch.from_numpy(p).to("cuda", dtype)
    qt = torch.from_numpy(q).to("cuda", dtype)
    for difference in (False, True):
        got = kclip.clip_stats_cuda(pt, qt, difference)
        want = clip_integral_bm(pt, qt, difference)
        torch.cuda.synchronize()
        scale = float(want.area.abs().max())
        tol_area = 1e-5 * scale if dtype == torch.float32 else 1e-9 * scale
        tol_chord = 1e-2 if dtype == torch.float32 else 1e-9 * 1000.0
        assert float((got.area - want.area).abs().max()) <= tol_area
        assert float((got.chord_p - want.chord_p).abs().max()) <= tol_chord
        assert torch.equal(got.n_cross, want.n_cross)


@pytest.mark.cuda
@pytest.mark.parametrize("b,vp,vq,nv", [(4096, 16, 16, None),
                                        (1000, 16, 8, None),
                                        (4099, 64, 64, (10, 30)),
                                        (1001, 16, 16, (3, 16))])
def test_pallas_kernel_matches_plain_on_card(b, vp, vq, nv):
    """At the main path's slot counts, and at the default capacity's 64
    slots with 10-30 real vertices; B = 4,099 and 1,001 are not multiples of
    the kernel's tile, so the last tile copied behind the math is short."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    made = (pairs(b, seed=b + vp + 1, vp=vp, vq=vq) if nv is None
            else random_pairs(b, vp, vq, seed=b + vp, nv_range=nv))
    pt, qt = (torch.from_numpy(x).to("cuda", torch.float32) for x in made)
    for difference in (False, True):
        got = kpallas.clip_pallas_cuda(pt, qt, difference)
        want = _clip_pallas(pt, qt, difference)
        torch.cuda.synchronize()
        scale = float(want.area.abs().max())
        assert float((got.area - want.area).abs().max()) <= 1e-5 * scale
        assert float((got.chord_p - want.chord_p).abs().max()) <= 1e-2
        assert torch.equal(got.n_cross, want.n_cross)


def tiny_edge_pairs(b=256, v=16):
    """P: the square [0, 1000 m]² with a 1e-18 m edge at its first corner
    (a component below 2^-51, so the kernel takes 1.0f / x for the pair);
    Q: seeded random polygons over it."""
    sq = np.array([[0.0, 0.0], [1e-18, 0.0], [1000.0, 0.0],
                   [1000.0, 1000.0], [0.0, 1000.0]])
    p = np.concatenate([sq, np.repeat(sq[:1], v - len(sq), 0)])
    _, q = random_pairs(b, v, v, seed=77)
    return np.repeat(p[None], b, axis=0), 0.5 * q + 500.0


def test_tiny_edge_pairs_keep_their_tiny_edge():
    p, q = tiny_edge_pairs()
    p32 = torch.from_numpy(p).float()
    dx = (torch.roll(p32, -1, dims=1) - p32)[:, 0, 0]
    assert bool((dx > 0).all()) and float(dx.max()) < 2.0 ** -51
    got = _clip_pallas(p32, torch.from_numpy(q).float(), False)
    assert float(got.area.max()) > 0


@pytest.mark.cuda
def test_pallas_kernel_ieee_path_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    pt, qt = (torch.from_numpy(x).to("cuda", torch.float32)
              for x in tiny_edge_pairs())
    for difference in (False, True):
        got = kpallas.clip_pallas_cuda(pt, qt, difference)
        want = _clip_pallas(pt, qt, difference)
        torch.cuda.synchronize()
        scale = float(want.area.abs().max())
        assert float((got.area - want.area).abs().max()) <= 1e-5 * scale
        assert float((got.chord_p - want.chord_p).abs().max()) <= 1e-2
        assert torch.equal(got.n_cross, want.n_cross)


@pytest.mark.cuda
def test_pallas_kernel_on_coastline_pair():
    """The float32 nares_export floe and coastline: no overlap, as the JAX
    kernel reports, where clip.cu's XLA twin reports 9.31e8 m²."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    p, q = (torch.from_numpy(x).to("cuda") for x in coastline_pair())
    got = kpallas.overlap_stats_pallas(p, q)             # float64 in
    assert got.area.dtype == torch.float32
    assert float(got.area[0]) == 0.0
    twin = kclip.clip_stats_cuda(p.float(), q.float(), False)
    assert float(twin.area[0]) > 9e8


@pytest.mark.cuda
def test_each_kernel_counts_its_launches_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    pt, qt = (torch.from_numpy(x).to("cuda") for x in pairs(13, seed=2))
    with trace.recording(trace.Table()) as table:
        kclip.overlap_stats(pt, qt)
        kclip.difference_stats(pt, qt)
        kpallas.overlap_stats_pallas(pt, qt)
    assert table.counts == {"clip.launches": 2, "clip_pallas.launches": 1}


def test_pallas_module_serves_cpu_without_building(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(kpallas, "build", no_build)
    p, q = pairs(13, seed=0)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    with trace.recording(trace.Table()) as table:
        got = kpallas.overlap_stats_pallas(pt, qt)
    want = _clip_pallas(pt, qt, False)
    assert got.area.dtype == torch.float32
    assert torch.equal(got.area, want.area)
    assert torch.equal(got.n_cross, want.n_cross)
    assert "clip_pallas.launches" not in table.counts
    with pytest.raises(ValueError, match="CUDA"):
        kpallas.clip_pallas_cuda(pt.float(), qt.float(), False)


EXHAUSTIVE_CU = """// {digest}: the kernel's source, for the build cache
#include "{source}"

// Every float32 bit pattern: rcp_in_range against 1.0f / x where the
// exponent field is in [1, 252] (|x| in [2^-126, 2^126)) and NaN at ±0,
// clamp_nan against the plain clamp everywhere (NaN kept; -0 and +0
// alike).
__global__ void exhaustive(unsigned long long* out) {{
  unsigned long long bad_rcp = 0, bad_clamp = 0, tested = 0;
  const unsigned long long step =
      (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += step) {{
    const float x = __uint_as_float((unsigned)i);
    const unsigned ef = ((unsigned)i >> 23) & 0xff;
    if (ef >= 1 && ef <= 252) {{
      ++tested;
      if (__float_as_uint(rcp_in_range(x)) != __float_as_uint(1.0f / x))
        ++bad_rcp;
    }}
    const float c = clamp_nan(x);
    const float want = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    if (!((isnan(c) && isnan(want)) || c == want)) ++bad_clamp;
  }}
  // a parallel pair's denominator gives NaN, which fails every test
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      !(isnan(rcp_in_range(0.0f)) && isnan(rcp_in_range(-0.0f))))
    ++bad_rcp;
  atomicAdd(out, bad_rcp);
  atomicAdd(out + 1, bad_clamp);
  atomicAdd(out + 2, tested);
}}

extern "C" int clip_pallas_exhaustive(unsigned long long* out) {{
  exhaustive<<<132 * 16, 256>>>(out);
  return (int)cudaDeviceSynchronize();
}}
"""


@pytest.mark.cuda
def test_pallas_fast_reciprocal_is_ieee(tmp_path):
    """clip_pallas.cu's reciprocal without its range test equals 1.0f / x
    for every float32 of magnitude in [2^-126, 2^126), and its two-
    instruction clamp the plain clamp for every float32: the grounds on
    which the kernel stays bit for bit the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import ctypes
    import hashlib

    src = kpallas.SOURCE
    cu = tmp_path / "clip_pallas_exhaustive.cu"
    cu.write_text(EXHAUSTIVE_CU.format(
        digest=hashlib.sha256(src.read_bytes()).hexdigest(), source=src))
    so, _, _ = kclip.compile_source(cu)
    fn = ctypes.CDLL(str(so)).clip_pallas_exhaustive
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    assert fn(out.data_ptr()) == 0
    bad_rcp, bad_clamp, tested = out.tolist()
    assert tested == 252 * 2 * 2 ** 23
    assert bad_rcp == 0 and bad_clamp == 0
