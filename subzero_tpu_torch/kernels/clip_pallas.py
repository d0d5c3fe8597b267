"""The Pallas kernel's clip: its Hopper CUDA kernel and dispatching wrapper.

``overlap_stats_pallas(p, q)`` / ``difference_stats_pallas(p, q)`` take
``[B, Vp, 2]`` and ``[B, Vq, 2]`` polygon pairs of any float dtype, cast them
to float32 as the JAX kernel's wrapper does, and return float32
``OverlapStats``:

* on CUDA tensors they launch the kernel of ``csrc/clip_pallas.cu``
  (replacing the Pallas TPU kernel
  ``subzero_tpu/geometry/clip_pallas.py:_clip_kernel``), or raise — there is
  no fallback;
* on CPU tensors they run the plain PyTorch version,
  ``geometry/clip_pallas._clip_pallas``.

The kernel is built like ``csrc/clip.cu`` (``kernels/clip.py``): ``nvcc`` at
first use, the same flags, a plain C interface loaded with ``ctypes``,
cached under ``subzero_tpu_torch/_build/``.  It shares clip.cu's tile and
real-edge compaction (``csrc/clip_tile.cuh``), so ``kernels/clip.py:
tile_bytes`` holds for it at float32, but it has its own lane groups
(``lane_group``): a pair's G lanes share out both polygons' real edges.

Each launch adds 1 to the count ``clip_pallas.launches`` of the active
``trace.Table``, so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..geometry.clip import OverlapStats
from ..geometry.clip_pallas import EPS_SCALE, _clip_pallas
from ..trace import count
from .clip import FILL_THREADS, SMEM_LIMIT, _PKG, load_library, tile_bytes

__all__ = [
    "overlap_stats_pallas",
    "difference_stats_pallas",
    "clip_pallas_stats",
    "clip_pallas_cuda",
    "build",
    "lane_group",
]

SOURCE = _PKG / "csrc" / "clip_pallas.cu"


@functools.lru_cache(maxsize=256)
def lane_group(b: int, vp: int, vq: int) -> int:
    """Lanes per pair, G in {1, 2, 4, 8, 16, 32}, for B pairs of Vp x Vq
    slots.

    The kernel shares out both polygons' real edges, one list, to a pair's
    G lanes.  About one lane per four slots of the wider polygon (two edges
    of the list per lane when a quarter of 16 slots or a third of 64 are
    real: the quad lattice's 4 of 16, the default capacity's 10-30 of 64);
    more while the B·G threads would not fill the card; at least the
    smallest G whose tile fits in shared memory; at most the list's slots.
    Fitted to a sweep of G on an H100 (chip_clip_pallas_bench.py --sweep,
    PERF.md); ``kernels/clip.py:lane_group`` stays clip.cu's rule."""
    vmax = max(vp, vq)
    g = 1
    while g < 32 and tile_bytes(g, vp, vq, 4) > SMEM_LIMIT:
        g *= 2
    cap = 1
    while cap < min(vp + vq, 32):
        cap *= 2
    while g < cap and (g < vmax // 4 or b * g < FILL_THREADS):
        g *= 2
    return g


_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; fills
    ``build_info`` (``kernels.clip.load_library``)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(SOURCE, {"clip_pallas_stats_f32": [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]}, build_info)
        return _lib


def _check(p: torch.Tensor, q: torch.Tensor):
    if p.device != q.device:
        raise ValueError(f"p on {p.device} but q on {q.device}")
    if not (p.is_floating_point() and q.is_floating_point()):
        raise TypeError(f"clip needs float pairs, got {p.dtype} and {q.dtype}")
    if (p.ndim != 3 or q.ndim != 3 or p.shape[2] != 2 or q.shape[2] != 2
            or p.shape[0] != q.shape[0] or p.shape[1] < 1 or q.shape[1] < 1):
        raise ValueError(f"expected [B, Vp, 2] and [B, Vq, 2], got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")


def clip_pallas_cuda(p: torch.Tensor, q: torch.Tensor,
                     difference: bool) -> OverlapStats:
    """Launch the CUDA kernel on contiguous float32 CUDA tensors
    ``p [B, Vp, 2]``, ``q [B, Vq, 2]``; raises otherwise."""
    _check(p, q)
    if p.device.type != "cuda":
        raise ValueError(f"clip_pallas_cuda needs CUDA tensors, got "
                         f"{p.device}")
    if p.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"clip_pallas_cuda needs float32, got {p.dtype} and "
                        f"{q.dtype}")
    if not (p.is_contiguous() and q.is_contiguous()):
        raise ValueError("clip_pallas_cuda needs contiguous inputs")
    b, vp, vq = p.shape[0], p.shape[1], q.shape[1]
    g = lane_group(b, vp, vq)
    if tile_bytes(g, vp, vq, 4) > SMEM_LIMIT:
        raise ValueError(f"clip kernel: Vp={vp}, Vq={vq} need "
                         f"{tile_bytes(g, vp, vq, 4)} B of shared memory "
                         f"per block, more than {SMEM_LIMIT}")
    kw = dict(dtype=torch.float32, device=p.device)
    area = torch.empty((b,), **kw)
    cent = torch.empty((b, 2), **kw)
    chord = torch.empty((b, 2), **kw)
    ncross = torch.empty((b,), dtype=torch.int32, device=p.device)
    if b == 0:
        return OverlapStats(area=area, centroid=cent, chord_p=chord,
                            n_cross=ncross)
    lib = build()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.clip_pallas_stats_f32(
            p.data_ptr(), q.data_ptr(), b, vp, vq, int(difference),
            EPS_SCALE, g, area.data_ptr(), cent.data_ptr(),
            chord.data_ptr(), ncross.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"clip_pallas kernel launch failed: CUDA error "
                           f"{err}")
    count("clip_pallas.launches")
    return OverlapStats(area=area, centroid=cent, chord_p=chord,
                        n_cross=ncross)


def clip_pallas_stats(p: torch.Tensor, q: torch.Tensor,
                      difference: bool) -> OverlapStats:
    """P ∩ Q (or P \\ Q) statistics of the Pallas kernel's math, float32:
    the kernel on CUDA tensors, the plain PyTorch version on CPU tensors."""
    _check(p, q)
    if p.device.type == "cuda":
        f32 = torch.float32
        return clip_pallas_cuda(p.to(f32).contiguous(),
                                q.to(f32).contiguous(), difference)
    if p.device.type == "cpu":
        return _clip_pallas(p, q, difference)
    raise ValueError(f"no clip for device {p.device}")


def overlap_stats_pallas(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """P ∩ Q statistics for ``[B, Vp, 2] × [B, Vq, 2]`` pairs (float32)."""
    return clip_pallas_stats(p, q, difference=False)


def difference_stats_pallas(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """P \\ Q statistics for ``[B, Vp, 2] × [B, Vq, 2]`` pairs (float32)."""
    return clip_pallas_stats(p, q, difference=True)
