"""contact_impl="pallas": the port's clip of the Pallas kernel against the
JAX package's, float32 on the CPU.

The JAX kernel (``subzero_tpu/geometry/clip_pallas.py``) runs as its own
tests run it, in Pallas' interpreter (``interpret=True``).  Under ``jit``,
XLA on the CPU fuses the kernel's body and contracts products into
multiply-adds, so its float32 values move by ulps from the kernel's written
operations, which the port follows one by one (as the Hopper kernel does,
built with ``--fmad=false``).  Hence:

* the per-edge indicator integrals and the crossing count equal the JAX
  kernel's own helpers run op by op (eagerly), bit for bit;
* the whole clip equals the interpreted kernel within the float32 rounding
  of those contractions: area within 1e-6·max|area| (ten times tighter than
  the 1e-5 that held the XLA twin against the kernel), chord within 1e-6 of
  the P polygon's perimeter per pair, n_cross exactly equal;
* on the float32 nares_export floe and coastline (``coastline_pair``) the
  port reports JAX's 0.0 where the XLA twin, in both packages, reports
  9.3e8 m²;
* float64 inputs give float32 stats in both packages;
* the dispatching wrapper (``kernels/clip_pallas.py``) on CPU tensors is the
  plain version and launches nothing;
* the port's CPU step under ``"pallas"`` against the JAX step (its kernel
  interpreted), between walls under the gyre, aggregate and per-region, in
  a float64 configuration (float32 stats, as in JAX);
* the float32 identities on which the Hopper kernel shares one reciprocal
  between P's and Q's crossings of an edge pair, and the kernel's lane-group
  rule (both without a card).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.geometry.clip_pallas as jpallas
from subzero_tpu.forcing import gyre_ocean
from subzero_tpu.geometry.clip_integral import overlap_stats_int
from subzero_tpu.dynamics.step import make_step_fn
from subzero_tpu.state import state_from_polygons

import subzero_tpu_torch.geometry.clip_pallas as tpallas
from subzero_tpu_torch import trace
from subzero_tpu_torch.convert import (
    forcing_from_numpy, state_from_numpy, state_to_numpy,
)
from subzero_tpu_torch.dynamics.step import make_step_fn as torch_step_fn
from subzero_tpu_torch.geometry.clip_integral import clip_integral_bm
from subzero_tpu_torch.kernels import clip_pallas as kpallas

from chip_smoke import coastline_pair, random_pairs
from test_torch_clip import batches, concave_batch, random_batch
from test_torch_step import MODULUS, configs, lattice, to_numpy

torch.set_num_threads(1)


def shared_batch(name):
    """float32 pairs at 1000 m scale: test_torch_clip's mixed convex and
    concave batch (60 x 16 x 16) or its 16 x 8 wall-contact shape."""
    if name == "mixed":
        pc, qc = random_batch(30, seed=6)
        pk, qk = concave_batch(30, seed=7)
        p, q = np.concatenate([pc, pk]), np.concatenate([qc, qk])
    else:
        p, q = batches()["vp16_vq8"]
    return (1000.0 * p).astype(np.float32), (1000.0 * q).astype(np.float32)


def perimeter(p):
    d = np.roll(p, -1, axis=1) - p
    return np.sum(np.hypot(d[..., 0], d[..., 1]), axis=1)


def test_coastline_pair_f32():
    p, q = (a.astype(np.float32) for a in coastline_pair())
    want = jpallas.overlap_stats_pallas(jnp.asarray(p), jnp.asarray(q),
                                        interpret=True)
    got = tpallas.overlap_stats_pallas(torch.from_numpy(p),
                                       torch.from_numpy(q))
    assert float(want.area[0]) == 0.0
    assert float(got.area[0]) == float(want.area[0])
    assert int(got.n_cross[0]) == int(want.n_cross[0])
    # the XLA twin: 9.31e8 m² in both packages (ROADMAP §C)
    twin_j = float(overlap_stats_int(jnp.asarray(p), jnp.asarray(q)).area[0])
    twin_t = float(clip_integral_bm(torch.from_numpy(p), torch.from_numpy(q),
                                    False).area[0])
    assert twin_j == pytest.approx(9.3138106e8, rel=1e-7)
    assert twin_t == pytest.approx(twin_j, rel=1e-6)


@pytest.mark.parametrize("difference", [False, True])
@pytest.mark.parametrize("name", ["mixed", "wall"])
def test_clip_matches_jax_kernel(name, difference):
    p, q = shared_batch(name)
    jfn = (jpallas.difference_stats_pallas if difference
           else jpallas.overlap_stats_pallas)
    tfn = (tpallas.difference_stats_pallas if difference
           else tpallas.overlap_stats_pallas)
    want = jfn(jnp.asarray(p), jnp.asarray(q), interpret=True)
    got = tfn(torch.from_numpy(p), torch.from_numpy(q))
    assert got.area.dtype == torch.float32
    scale = float(np.max(np.abs(np.asarray(want.area))))
    np.testing.assert_allclose(got.area.numpy(), np.asarray(want.area),
                               rtol=0, atol=1e-6 * scale)
    d_chord = np.max(np.abs(got.chord_p.numpy() - np.asarray(want.chord_p)),
                     axis=1)
    assert np.all(d_chord <= 1e-6 * perimeter(p)), d_chord.max()
    np.testing.assert_array_equal(got.n_cross.numpy(),
                                  np.asarray(want.n_cross))


@pytest.mark.parametrize("side", ["p", "q"])
@pytest.mark.parametrize("name", ["mixed", "wall"])
def test_edge_integrals_equal_jax_op_by_op(name, side):
    """The kernel's helpers, JAX's run eagerly (no fusion) against the
    port's, bit for bit: P's edges against Q, or Q's against P."""
    p, q = shared_batch(name)
    if side == "q":
        p, q = q, p
    eps = tpallas.pair_eps(torch.from_numpy(p), torch.from_numpy(q))
    jp, jq = jpallas._planes(jnp.asarray(p)), jpallas._planes(jnp.asarray(q))
    tp, tq = tpallas._planes(torch.from_numpy(p)), \
        tpallas._planes(torch.from_numpy(q))
    vq = q.shape[1]
    with jax.disable_jit():
        want = jpallas._indicator_integrals(
            jp[0], jp[1], jp[2] - jp[0], jp[3] - jp[1],
            jnp.asarray(eps.numpy())[None], jq, vq)
        want_n = jpallas._n_cross(jp, jq, vq)
    got = tpallas._indicator_integrals(
        tp[0], tp[1], tp[2] - tp[0], tp[3] - tp[1], eps, tq, vq)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tpallas._n_cross(tp, tq, vq).numpy(),
                                  np.asarray(want_n)[0])


def test_eps_is_formed_in_float32_as_jax_forms_it():
    want = jnp.float32(jnp.finfo(jnp.float32).eps) ** (2.0 / 3.0)
    assert np.float32(tpallas.EPS_SCALE) == np.asarray(want)
    p, q = coastline_pair()
    eps = tpallas.pair_eps(torch.from_numpy(p), torch.from_numpy(q))
    assert eps.dtype == torch.float32
    assert float(eps[0]) == float(np.float32(273057.47) * np.asarray(want))


def test_float64_inputs_give_float32_stats():
    p, q = coastline_pair()                       # float64
    want = jpallas.overlap_stats_pallas(jnp.asarray(p), jnp.asarray(q),
                                        interpret=True)
    assert want.area.dtype == jnp.float32
    assert want.centroid.dtype == jnp.float32
    for got in (tpallas.overlap_stats_pallas(torch.from_numpy(p),
                                             torch.from_numpy(q)),
                kpallas.overlap_stats_pallas(torch.from_numpy(p),
                                             torch.from_numpy(q))):
        assert got.area.dtype == torch.float32
        assert got.centroid.dtype == torch.float32
        assert got.chord_p.dtype == torch.float32
        assert got.n_cross.dtype == torch.int32
        assert float(got.area[0]) == float(want.area[0]) == 0.0


def test_cpu_wrapper_is_the_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(kpallas, "build", no_build)
    p, q = shared_batch("mixed")
    with trace.recording(trace.Table()) as table:
        for difference in (False, True):
            for dtype in (torch.float32, torch.float64):
                pt = torch.from_numpy(p).to(dtype)
                qt = torch.from_numpy(q).to(dtype)
                fn = (kpallas.difference_stats_pallas if difference
                      else kpallas.overlap_stats_pallas)
                got = fn(pt, qt)
                want = tpallas._clip_pallas(pt, qt, difference)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
    assert "clip_pallas.launches" not in table.counts
    with pytest.raises(ValueError, match="CUDA"):
        kpallas.clip_pallas_cuda(torch.from_numpy(p), torch.from_numpy(q),
                                 False)
    with pytest.raises(ValueError):
        kpallas.overlap_stats_pallas(torch.from_numpy(p)[:3],
                                     torch.from_numpy(q))
    with pytest.raises(TypeError):
        kpallas.overlap_stats_pallas(torch.from_numpy(p).to(torch.int32),
                                     torch.from_numpy(q).to(torch.int32))


def identity_pairs():
    """float32 polygon pairs for the shared-reciprocal identities: seeded
    random pairs at 1000 m, the same at ~1e6 m from the origin, the same
    scaled to 1e-3 m edges, and near-parallel edges (each Q edge P's edge
    turned by ~1e-7 rad)."""
    p, q = random_pairs(64, 16, 16, seed=90)
    sets = [(p, q), (p + 1.0e6, q + 1.0e6),
            (1e-6 * p + 1.0e3, 1e-6 * q + 1.0e3)]
    rng = np.random.default_rng(91)
    th = 1e-7 * rng.uniform(-1.0, 1.0, size=(64, 1))
    turn = np.stack([np.cos(th) * p[..., 0] - np.sin(th) * p[..., 1],
                     np.sin(th) * p[..., 0] + np.cos(th) * p[..., 1]], -1)
    sets.append((p, turn + rng.uniform(-5.0, 5.0, size=(64, 1, 2))))
    return [(torch.from_numpy(a.astype(np.float32)),
             torch.from_numpy(b.astype(np.float32))) for a, b in sets]


def bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", ["1e3 m", "1e6 m", "1e-3 m edges",
                                  "near-parallel"])
def test_shared_reciprocal_identities_f32(case):
    """The Hopper kernel evaluates both sides' crossings of an edge pair
    from one reciprocal: Q's denominator o.dx·e.dy − o.dy·e.dx is bit for
    bit −(e.dx·o.dy − e.dy·o.dx), its reciprocal −(1/denom), and Q's
    numerators times its reciprocal −(x · (1/denom)); so its live, window
    and weight decisions are the plain version's.  float32 on the CPU,
    every (P edge, Q edge) pair of each polygon pair, Q's origins nudged
    as the plain version nudges them."""
    p, q = identity_pairs()[["1e3 m", "1e6 m", "1e-3 m edges",
                             "near-parallel"].index(case)]
    px0, py0, px1, py1 = tpallas._planes(p)        # [V, B]
    qx0, qy0, qx1, qy1 = tpallas._planes(q)
    dx, dy = (px1 - px0)[:, None], (py1 - py0)[:, None]     # [Vp, 1, B]
    dqx, dqy = (qx1 - qx0)[None], (qy1 - qy0)[None]         # [1, Vq, B]
    denom = dx * dqy - dy * dqx
    denom_q = dqx * dy - dqy * dx                 # Q's own, as the plain
    live = torch.abs(denom) > 0                   # version forms it
    assert torch.equal(live, torch.abs(denom_q) > 0)
    assert int(live.sum()) > 1000             # padding edges are dead
    assert torch.equal(bits(denom_q[live]), bits(-denom[live]))
    inv = 1.0 / denom[live]
    inv_q = 1.0 / denom_q[live]
    assert torch.equal(bits(inv_q), bits(-inv))
    assert torch.equal(torch.sign(denom_q[live]), -torch.sign(denom[live]))
    eps = tpallas.pair_eps(p, q)
    elen2 = dqx * dqx + dqy * dqy
    inv_len = torch.where(elen2 > 0, 1.0 / torch.sqrt(elen2),
                          torch.zeros_like(elen2))
    for sgn in (1.0, -1.0):
        ox = qx0[None] + sgn * eps * (dqy * inv_len)
        oy = qy0[None] + sgn * eps * (-dqx * inv_len)
        relx, rely = px0[:, None] - ox, py0[:, None] - oy
        for num in (relx * dqy - rely * dqx, relx * dy - rely * dx):
            x = num[live]
            assert torch.equal(bits(x * inv_q), bits(-(x * inv)))
            assert torch.equal(bits(x * inv_q), bits(x * -inv))


# kernels/clip.py:lane_group, the rule of clip.cu's launches, which the
# Pallas kernel's own rule leaves as it was: {(B, Vp, Vq): G}
CLIP_CU_LANES = {
    (1, 3, 3): 4, (1, 16, 8): 16, (1, 16, 16): 16, (1, 64, 64): 32,
    (13, 16, 16): 16, (1000, 16, 8): 16, (1000, 24, 24): 32,
    (10240, 16, 8): 8, (10240, 16, 16): 8, (10240, 24, 24): 16,
    (53120, 3, 3): 2, (53120, 16, 16): 4, (81920, 3, 3): 1,
    (81920, 16, 16): 4, (81920, 64, 8): 32, (163840, 16, 8): 4,
    (163840, 64, 64): 32, (163840, 100, 100): 32,
}
PALLAS_SHAPES = [(81920, 16, 16), (10240, 16, 8), (53120, 16, 16),
                 (4096, 64, 64), (163840, 64, 64)]


def test_lane_group_rule():
    """The Pallas kernel's lane groups: a power of two whose tile fits in
    shared memory, at phase 2b's five shapes and over a grid of shapes;
    clip.cu's rule unchanged."""
    from subzero_tpu_torch.kernels import clip as kclip

    grid = [(b, vp, vq) for b in (1, 13, 1000, 10240, 53120, 163840)
            for vp in (1, 3, 8, 16, 24, 64, 100) for vq in (1, 3, 8, 16, 64)]
    for b, vp, vq in PALLAS_SHAPES + grid:
        g = kpallas.lane_group(b, vp, vq)
        assert g in (1, 2, 4, 8, 16, 32), (b, vp, vq, g)
        assert kclip.tile_bytes(g, vp, vq, 4) <= kclip.SMEM_LIMIT
    assert {s: kclip.lane_group(*s) for s in CLIP_CU_LANES} == CLIP_CU_LANES


# The step lockstep's bounds.  The stats are float32 at the floes' scale, and
# the JAX kernel's float32 values move by ulps under XLA's contractions.  The
# wall difference sums the domain polygon's edges, whose Green's terms are
# ~2.4e8 m² in the floe's frame (one float32 ulp: 16 m²), so a wall contact's
# force differs by up to ~1e-4 m/s of a 7e9 kg floe's velocity in one 10 s
# step.  Free-running, the pack compounds that, and by step 19 two of floe
# 19's candidates, at equal distance to within the drift, trade places in its
# neighbour table; so every two-step chunk starts both steps from the JAX
# step's state.  A step advances positions with its incoming velocities, so
# positions differ from the chunk's second step on.  Neighbour tables,
# collision counts and pool counters must be equal every step, and the
# deltas stay under these bounds (measured: 1.03e-3 m, 1.19e-4 m/s).
STEP_TOL_POS = 5e-3       # m
STEP_TOL_VEL = 5e-4       # m/s


@pytest.mark.parametrize("contact", ["aggregate", "per-region"])
def test_pallas_step_matches_jax(contact, monkeypatch):
    for name in ("overlap_stats_pallas", "difference_stats_pallas"):
        monkeypatch.setattr(jpallas, name, functools.partial(
            getattr(jpallas, name), interpret=True))
    polys, vel, lx = lattice(6, seed=1)
    jcfg, pcfg = configs(40, lx, periodic=False,
                         contact=None if contact == "aggregate" else {},
                         numerics=dict(contact_impl="pallas"))
    jforcing = gyre_ocean(lx=4 * lx, dx=lx / 8, transport=2e3, wind_u=8.0,
                          wind_v=-4.0, dtype=jnp.float64)
    jstate = state_from_polygons(polys, 0.5, jcfg, velocities=vel)
    jstep = make_step_fn(jcfg, jforcing, MODULUS)
    pstep = torch_step_fn(pcfg, forcing_from_numpy(to_numpy(jforcing),
                                                   device="cpu"),
                          MODULUS, device="cpu")
    dpos = dvel = 0.0
    walls = collisions = need = 0
    for i in range(20):
        if i % 2 == 0:
            pstate = state_from_numpy(to_numpy(jstate), device="cpu",
                                      dtype=torch.float64)
        jstate, jaux = jstep(jstate, jnp.asarray(i))
        pstate, paux = pstep(pstate, i)
        a, b = to_numpy(jstate), state_to_numpy(pstate)
        assert b["x"].dtype == np.float64
        dpos = max(dpos, *(np.max(np.abs(a[k] - b[k])) for k in "xy"))
        dvel = max(dvel, *(np.max(np.abs(a[k] - b[k]))
                           for k in ("u", "v", "ksi")))
        for f in ("n_collisions", "region_pool_need", "region_overflow",
                  "pair_pool_need", "pair_pool_overflow", "nbr_overflow",
                  "nbr_demand"):
            assert int(getattr(jaux, f)) == int(getattr(paux, f)), \
                f"step {i}: {f}"
        np.testing.assert_array_equal(np.asarray(jaux.nbr_idx),
                                      paux.nbr_idx.numpy())
        np.testing.assert_array_equal(a["alive"], b["alive"])
        walls += int(paux.boundary_contact.sum())
        collisions += int(paux.n_collisions)
        need += int(paux.region_pool_need)
    assert collisions > 0 and walls > 0
    assert (need > 0) == (contact == "per-region")
    assert dpos < STEP_TOL_POS, dpos
    assert dvel < STEP_TOL_VEL, dvel
