"""The births' Monte-Carlo mask kernel (``csrc/mc_mask.cu``, wrapper
``kernels/mc_mask.py``) against its plain version, the host's numpy
broadcast (``state.py:mc_inside``, the JAX package's ``make_floe_arrays``
test): the mask bit for bit on the card, from ``make_floe_arrays``' own
geometry and points, and the states it builds and edits equal to the CPU
route's field for field.  This file imports no JAX, so the card tests run on
a machine without it:

    python -m pytest tests/test_torch_mc_mask_kernel.py -q --noconftest

On a machine without CUDA the card tests skip; the others check that CPU
tensors keep the host's mask, and that the real edges alone give the padded
broadcast's parity, which the kernel's loop over ``nv`` edges relies on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from subzero_tpu_torch import trace
from subzero_tpu_torch.config import CapacityConfig, NumericsConfig, SimConfig
from subzero_tpu_torch.kernels.mc_mask import mc_mask_cuda
from subzero_tpu_torch.processes.host import NewFloe, StateEdit, apply_edits
from subzero_tpu_torch.state import (
    FloeState, make_floe_arrays, mc_inside, state_from_polygons,
)

torch.set_num_threads(1)

RUNGS = (8, 16, 32, 64)      # vertex rungs the driver grows through


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def star(nv, rng, r=1000.0):
    """A star-shaped simple polygon of ``nv`` vertices around the origin."""
    ang = (np.arange(nv) + rng.uniform(0.1, 0.9, nv)) * (2 * np.pi / nv)
    rad = r * rng.uniform(0.4, 1.0, nv)
    return np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)


def staircase(steps, pitch=150.0):
    """A rectilinear staircase of ``2 steps + 2`` vertices: every other
    edge horizontal, with vertices level with each other."""
    pts = [(0.0, 0.0), (steps, 0.0)]
    for i in range(steps):
        pts += [(steps - i, i + 1.0), (steps - i - 1.0, i + 1.0)]
    return pitch * np.array(pts)


def polygons(v, seed):
    """Floes of every vertex count from 3 up to the rung ``v`` (``nv == v``
    unpadded), stars and staircases, moved off the origin."""
    rng = np.random.default_rng(seed)
    polys = [star(nv, rng) for nv in range(3, v + 1)]
    polys += [staircase(k) for k in range(1, (v - 2) // 2 + 1)]
    return [p + rng.uniform(-5e4, 5e4, 2) for p in polys]


def config(n_floes, p, dtype="float64"):
    return SimConfig(
        numerics=NumericsConfig(dtype=dtype),
        capacity=CapacityConfig(max_floes=n_floes, max_verts=64,
                                n_mc_points=p, stress_window=8))


def crossing_parity(verts, nv, pts):
    """The crossing-number test over the first ``nv`` edges only, a point
    at a time: the kernel's loop, in Python."""
    out = np.zeros(len(pts), bool)
    v = len(verts)
    for i, (px, py) in enumerate(pts):
        inside = False
        for e in range(nv):
            x0, y0 = verts[e]
            x1, y1 = verts[(e + 1) % v]
            if (y0 > py) != (y1 > py):
                t = (py - y0) / (y1 - y0)
                inside ^= bool(px < x0 + t * (x1 - x0))
        out[i] = inside
    return out


def level_points(verts, nv):
    """Points level with every vertex: on it, just left and right of it,
    at the body-frame origin's x and beyond the floe."""
    vx, vy = verts[:nv, 0], verts[:nv, 1]
    xs = [vx, np.nextafter(vx, -np.inf), np.nextafter(vx, np.inf),
          np.zeros(nv), np.full(nv, 2 * np.abs(verts).max())]
    return np.concatenate([np.stack([x, vy], 1) for x in xs])


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("v", RUNGS)
def test_cpu_device_keeps_the_host_mask(v):
    polys = polygons(v, seed=v)
    cfg = config(len(polys), 400)
    heights = np.ones(len(polys))
    want = make_floe_arrays(polys, heights, cfg, seed=7, v_cap=v)
    with trace.recording(trace.Table()) as table:
        got = make_floe_arrays(polys, heights, cfg, seed=7, v_cap=v,
                               device="cpu")
    assert not table.counts
    assert want.keys() == got.keys()
    for k in want:
        assert isinstance(got[k], np.ndarray), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["mc_in"],
                                  mc_inside(got["verts_body"], got["mc_xy"]))


@pytest.mark.parametrize("v", RUNGS)
def test_real_edges_give_the_padded_parity(v):
    # the padding repeats vertex 0, so the edges past nv - 1 never cross:
    # a loop over the nv real edges (the kernel's) gives the broadcast's
    # parity over all v, on the random points and on points level with the
    # vertices (horizontal edges included)
    polys = polygons(v, seed=100 + v)[::3] + [staircase((v - 2) // 2)]
    cfg = config(len(polys), 64)
    arrs = make_floe_arrays(polys, np.ones(len(polys)), cfg, seed=3, v_cap=v)
    verts, nv = arrs["verts_body"], arrs["nv"]
    assert int(nv.max()) == v
    for b in range(len(polys)):
        for pts in (arrs["mc_xy"][b], level_points(verts[b], nv[b])):
            want = mc_inside(verts[b:b + 1], pts[None])[0]
            np.testing.assert_array_equal(
                crossing_parity(verts[b], nv[b], pts), want)


# -- the card ----------------------------------------------------------------

def mc_arrays(polys, cfg, v, device, seed=11):
    with trace.recording(trace.Table()) as table:
        arrs = make_floe_arrays(polys, np.ones(len(polys)), cfg, seed=seed,
                                v_cap=v, device=device)
    return arrs, table.counts


@pytest.mark.cuda
@pytest.mark.parametrize("p", [400, 1000])
@pytest.mark.parametrize("v", RUNGS)
def test_kernel_mask_equals_host_on_card(v, p):
    need_card()
    polys = polygons(v, seed=v + p)
    cfg = config(len(polys), p)
    want, none = mc_arrays(polys, cfg, v, "cpu")
    got, counts = mc_arrays(polys, cfg, v, "cuda")
    torch.cuda.synchronize()
    assert not none
    assert counts == {"mc_mask.launches": 1, "mc_mask.floes": len(polys)}
    assert got["mc_in"].is_cuda and got["mc_in"].dtype == torch.bool
    assert got["mc_xy"].is_cuda and got["mc_xy"].dtype == torch.float64
    for k in want:
        g = got[k].cpu().numpy() if torch.is_tensor(got[k]) else got[k]
        np.testing.assert_array_equal(g, want[k], err_msg=k)
    assert 0 < int(want["mc_in"].sum()) < want["mc_in"].size


@pytest.mark.cuda
@pytest.mark.parametrize("v", RUNGS)
def test_kernel_on_points_level_with_vertices_on_card(v):
    need_card()
    polys = polygons(v, seed=200 + v)
    cfg = config(len(polys), 16)
    arrs = make_floe_arrays(polys, np.ones(len(polys)), cfg, seed=5, v_cap=v)
    verts, nv = arrs["verts_body"], arrs["nv"]
    per = [level_points(verts[b], nv[b]) for b in range(len(polys))]
    p = max(len(q) for q in per)
    # pad each floe's points with its first to one [B, P, 2] block
    pts = np.stack([np.concatenate([q, np.repeat(q[:1], p - len(q), 0)])
                    for q in per])
    want = mc_inside(verts, pts)
    got = mc_mask_cuda(torch.from_numpy(verts).cuda(),
                       torch.from_numpy(nv).cuda(),
                       torch.from_numpy(pts).cuda())
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.cuda
def test_float32_state_equals_the_cpu_route_on_card():
    need_card()
    polys = polygons(64, seed=9)
    cfg = config(2 * len(polys), 400, dtype="float32")
    heights = np.linspace(0.5, 2.0, len(polys))
    want = state_from_polygons(polys, heights, cfg, seed=21, device="cpu")
    with trace.recording(trace.Table()) as table:
        got = state_from_polygons(polys, heights, cfg, seed=21,
                                  device="cuda")
    assert table.counts["mc_mask.launches"] == 1
    for f in dataclasses.fields(FloeState):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.is_cuda and g.dtype == w.dtype, f.name
        assert torch.equal(g.cpu(), w), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_apply_edits_on_card_equals_cpu(dtype):
    # kills, births and reshapes (births into the same slot) at rung 64
    need_card()
    polys = polygons(64, seed=13)
    n = len(polys)
    cfg = config(2 * n, 400, dtype=dtype)
    rng = np.random.default_rng(17)
    born = [star(nv, rng) + 2e5 for nv in (5, 17, 40, 64)]
    edit = StateEdit(
        kills={3, 8},
        new_floes=[NewFloe(poly=p, h=1.5, u=0.1 * i, strain=np.ones(3),
                           stress_blend=[(i, 1.0)])
                   for i, p in enumerate(born)],
        reshapes={10: (0.8 * polys[10], 7.0e5), n - 1: (polys[n - 1], 9e5)})
    out = {}
    for dev in ("cpu", "cuda"):
        st = state_from_polygons(polys, np.ones(n), cfg, seed=2, device=dev)
        with trace.recording(trace.Table()) as table:
            out[dev] = apply_edits(st, edit, cfg, seed=29)
        if dev == "cuda":
            assert table.counts == {"mc_mask.launches": 1,
                                    "mc_mask.floes": len(born) + 2}
    for f in dataclasses.fields(FloeState):
        g, w = getattr(out["cuda"], f.name), getattr(out["cpu"], f.name)
        assert g.is_cuda and g.dtype == w.dtype, f.name
        assert torch.equal(g.cpu(), w), f.name
