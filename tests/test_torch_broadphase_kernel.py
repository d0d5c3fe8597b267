"""The dense broad phase's Hopper kernel (``csrc/broadphase.cu``) against its
plain PyTorch version (``dynamics/broadphase.py:neighbor_candidates_plain``):
the whole neighbour table, bit for bit, on the card.  This file imports no
JAX, so the card tests run on a machine without it:

    python -m pytest tests/test_torch_broadphase_kernel.py -q --noconftest

On a machine without CUDA the card tests skip; the others check that CPU
tensors take the plain version without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from subzero_tpu_torch import trace
from subzero_tpu_torch.dynamics import broadphase as bp
from subzero_tpu_torch.kernels import broadphase as kbp

torch.set_num_threads(1)

FIELDS = ("idx", "valid", "shift", "overflow", "demand")
# max_neighbors' growth ladder (sim.py:_ladder_k)
LADDER = (8, 13, 20, 31, 47, 71, 107, 161, 242, 364, 547)


def field(n, seed, pitch=1000.0, r_lo=0.6, r_hi=1.1, dead=0.1):
    """A Voronoi-like field: ``n`` centroids jittered off a square grid of
    ``pitch``, radii uniform in [r_lo, r_hi] pitches, a share ``dead`` of
    the slots dead; returns (x, y, rmax, alive, half-width)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    lx = side * pitch / 2
    k = np.arange(n)
    gx, gy = k % side, k // side
    x = -lx + (gx + 0.5 + rng.uniform(-0.35, 0.35, n)) * pitch
    y = -lx + (gy + 0.5 + rng.uniform(-0.35, 0.35, n)) * pitch
    r = rng.uniform(r_lo, r_hi, n) * pitch
    alive = rng.random(n) >= dead
    return x, y, r, alive, lx


def tensors(device, dtype, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(
        device, torch.bool if a.dtype == bool else dtype) for a in arrays]


def hold(args, k, periodic, lx, src=None, n_skip=0):
    """The kernel's table against the plain version's, field by field, both
    on the card; returns the plain table."""
    want = bp.neighbor_candidates_plain(*args, k, periodic, lx, lx, src=src,
                                        n_skip_rows=n_skip)
    with trace.recording(trace.Table()) as table:
        got = bp.neighbor_candidates(*args, k, periodic, lx, lx, src=src,
                                     n_skip_rows=n_skip)
    torch.cuda.synchronize()
    assert table.counts == {"broadphase.launches": 1}
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=f)
    return want


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n_skip", [0, 4])
def test_kernel_table_equals_plain_on_card(dtype, periodic, n_skip):
    need_card()
    x, y, r, alive, lx = field(700, seed=3)
    args = tensors("cuda", dtype, x, y, r, alive)
    for k in (8, 47):
        want = hold(args, k, periodic, lx, n_skip=n_skip)
        assert bool(want.valid.any()) and not bool(want.valid[:n_skip].any())
        assert not bool(want.valid[~args[3]].any())      # dead floes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [False, True])
def test_kernel_src_form_equals_plain_on_card(dtype, periodic):
    # the spatial steps' call: queries in the first n_self < M source slots
    # (self pairs excluded only there), then ghosts; and queries against
    # ghosts alone (n_self = 0)
    need_card()
    x, y, r, alive, lx = field(1500, seed=4)
    xs, ys, rs, als = tensors("cuda", dtype, x, y, r, alive)
    n = 1100
    q = (xs[:n], ys[:n], rs[:n], als[:n])
    hold(q, 13, periodic, lx, src=(xs, ys, rs, als, n - 60))
    hold(q, 8, periodic, lx, src=(xs[n:], ys[n:], rs[n:], als[n:], 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_ties_and_overflow_on_card(dtype):
    # a regular lattice has exact distance ties; K=3 < the 8 neighbours of
    # an interior floe (24 with the larger radius) overflows every row
    need_card()
    side, pitch = 40, 1000.0
    g = (np.arange(side) - (side - 1) / 2) * pitch
    x, y = [a.ravel() for a in np.meshgrid(g, g)]
    alive = np.ones(x.shape, bool)
    lx = side * pitch / 2
    for scale in (0.75, 1.3):
        args = tensors("cuda", dtype, x, y, np.full(x.shape, scale * pitch),
                       alive)
        for periodic in (False, True):
            want = hold(args, 3, periodic, lx)
            assert bool(want.overflow) and int(want.demand) > 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_half_period_offsets_on_card(dtype):
    # floes a quarter period apart on a torus whose period 2 lx no float
    # holds exactly: dx / (2 lx) sits on +-0.5, where the last bit of the
    # reciprocal decides the image, in the circle test and in the shifts
    need_card()
    lx = 1234.5678
    g = np.arange(-4, 4) * (lx / 4)
    x, y = [a.ravel() for a in np.meshgrid(g, g)]
    args = tensors("cuda", dtype, x, y, np.full(x.shape, 0.55 * lx),
                   np.ones(x.shape, bool))
    for k in (8, 31, 64):
        hold(args, k, True, lx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_k_at_and_above_m_on_card(dtype):
    # every ladder rung up to N, and K >= M (a row's buffers then hold
    # every source slot)
    need_card()
    x, y, r, alive, lx = field(300, seed=5, r_lo=1.5, r_hi=4.0)
    args = tensors("cuda", dtype, x, y, r, alive)
    for k in [k for k in LADDER if k < 300] + [300, 333]:
        for periodic in (False, True):
            hold(args, k, periodic, lx)
    small = [a[:20] for a in args]
    hold(small, 31, True, lx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [False, True])
def test_kernel_at_ten_thousand_floes_on_card(dtype, periodic):
    # the cells' size and K; radii set so that some rows hold more than K
    # candidates.  The kernel allocates nothing of [N, N]: its peak over
    # its outputs stays below one [N, N] byte mask.
    need_card()
    n = 10240
    x, y, r, alive, lx = field(n, seed=6, pitch=20000.0, r_lo=1.4,
                               r_hi=2.2, dead=0.05)
    args = tensors("cuda", dtype, x, y, r, alive)
    want = hold(args, 47, periodic, lx, n_skip=4)
    assert bool(want.overflow)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bp.neighbor_candidates(*args, 47, periodic, lx, lx, n_skip_rows=4)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < n * n // 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_divides_by_the_reciprocal_on_card(dtype):
    # The kernel's minimum image multiplies by 1 / (2 lx), taken in double
    # and rounded to the tensor's type, because PyTorch on CUDA computes a
    # tensor divided by a Python scalar that way (the CPU divides; at this lx
    # neither the division nor the reciprocal taken in float32 agrees).
    # Where this fails, the kernel has to follow PyTorch's new rule.
    need_card()
    rng = np.random.default_rng(7)
    for lx in (1234.5678, 707000.0, 1e6):
        d = torch.from_numpy(rng.uniform(-5 * lx, 5 * lx, 1 << 20)).to(
            "cuda", dtype)
        inv = torch.tensor(1.0 / (2.0 * lx), dtype=dtype, device="cuda")
        assert torch.equal(d / (2.0 * lx), d * inv)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(kbp, "build", no_build)
    x, y, r, alive, lx = field(60, seed=8)
    args = tensors("cpu", torch.float64, x, y, r, alive)
    for periodic in (False, True):
        with trace.recording(trace.Table()) as table:
            got = bp.neighbor_candidates(*args, 8, periodic, lx, lx,
                                         n_skip_rows=2)
        want = bp.neighbor_candidates_plain(*args, 8, periodic, lx, lx,
                                            n_skip_rows=2)
        assert "broadphase.launches" not in table.counts
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_kernel_entry_refuses_cpu_tensors():
    x, y, r, alive, lx = field(10, seed=9)
    args = tensors("cpu", torch.float64, x, y, r, alive)
    with pytest.raises(ValueError, match="CUDA"):
        kbp.neighbor_table_cuda(*args, 8, True, lx, lx)


def test_buffers_fit_a_chunk_and_shared_memory_at_the_cells_k():
    # A row's buffer holds the K kept slots and one more chunk of 32
    # appends, at every K.  The buffers live in the wrapper's scratch array
    # at every K; shared memory holds only the staged tile, fixed when the
    # kernel is built.
    for k in (1, 2, *LADDER, 10_000):
        cap = kbp.capacity(k)
        assert cap % 32 == 0 and cap >= k + 32 and cap >= 2 * k
    assert kbp.capacity(47) == 96
