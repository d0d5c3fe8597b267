"""The dense broad phase's Hopper CUDA kernel and its wrapper.

``neighbor_table_cuda`` computes the neighbour table of
``dynamics/broadphase.py:neighbor_candidates`` for CUDA tensors in one launch
of the kernel of ``csrc/broadphase.cu``: the circle test, the per-row top-K
by (r2, j), the invalid slots, the periodic shifts and the row demand,
without the plain version's [N, M] tensors.  It replaces no TPU kernel: the
JAX package writes this layer as plain XLA
(``subzero_tpu/dynamics/broadphase.py:neighbor_candidates``).
``neighbor_candidates`` launches it for CUDA tensors and runs the plain
version (``neighbor_candidates_plain``) for CPU tensors; there is no
fallback.

The kernel is built like ``csrc/clip.cu`` (``kernels/clip.py``): ``nvcc`` at
first use, the same flags (``--fmad=false``), a plain C interface loaded with
``ctypes``, cached under ``subzero_tpu_torch/_build/``.

Each launch adds 1 to the count ``broadphase.launches`` of the active
``trace.Table``, so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..trace import count
from .clip import _PKG, load_library

__all__ = ["neighbor_table_cuda", "build", "capacity"]

SOURCE = _PKG / "csrc" / "broadphase.cu"

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; fills
    ``build_info`` (``kernels.clip.load_library``)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            types = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, i,
                     ctypes.c_double, ctypes.c_double, p, p, p, p, p, p, p]
            _lib = load_library(SOURCE, {"broadphase_f32": types,
                                         "broadphase_f64": types},
                                build_info)
        return _lib


def capacity(k: int) -> int:
    """Entries of a row's candidate buffer at top-K ``k``: a multiple of 32,
    at least 2K and K + 32, so that a row with up to twice K candidates is
    ranked once, at the end."""
    return -(-max(2 * k, k + 32) // 32) * 32


def neighbor_table_cuda(x, y, rmax, alive, k_max: int, periodic: bool,
                        lx: float, ly: float, src=None, n_skip_rows: int = 0):
    """The neighbour table of ``neighbor_candidates`` (same arguments) from
    one kernel launch, as ``(idx, valid, shift, overflow, demand)``.  Needs
    CUDA tensors of one float dtype (float32 or float64), bool ``alive``,
    and ``k_max``, N and M of at least 1; raises otherwise."""
    n = x.shape[0]
    if src is None:
        x_s, y_s, r_s, alive_s, n_self = x, y, rmax, alive, n
    else:
        x_s, y_s, r_s, alive_s, n_self = src
    m = x_s.shape[0]
    floats = (x, y, rmax, x_s, y_s, r_s)
    dev, dtype = x.device, x.dtype
    if dev.type != "cuda":
        raise ValueError(f"neighbor_table_cuda needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64) or any(
            t.dtype != dtype for t in floats):
        raise TypeError("the broad-phase kernel needs float32 or float64 "
                        "positions and radii of one dtype")
    if alive.dtype != torch.bool or alive_s.dtype != torch.bool:
        raise TypeError("the broad-phase kernel needs bool alive masks")
    if any(t.device != dev for t in (*floats, alive, alive_s)):
        raise ValueError("the broad-phase kernel needs every input on one "
                         "device")
    if (n < 1 or m < 1 or k_max < 1 or any(t.shape != (n,) for t in (
            y, rmax, alive)) or any(t.shape != (m,) for t in (
            y_s, r_s, alive_s))):
        raise ValueError(f"broad-phase kernel: N={n}, M={m}, K={k_max} "
                         f"with mismatched or empty inputs")
    cap = capacity(k_max)
    idx = torch.empty((n, k_max), dtype=torch.int32, device=dev)
    valid = torch.empty((n, k_max), dtype=torch.bool, device=dev)
    shift = torch.empty((n, k_max, 2), dtype=dtype, device=dev)
    demand = torch.zeros((), dtype=torch.int32, device=dev)
    # each row's candidate buffer of cap (r2, j)
    s_r2 = torch.empty((n, cap), dtype=dtype, device=dev)
    s_j = torch.empty((n, cap), dtype=torch.int32, device=dev)
    args = [t.contiguous() for t in (x, y, rmax, alive)]
    args_s = [t.contiguous() for t in (x_s, y_s, r_s, alive_s)]
    lib = build()
    fn = lib.broadphase_f32 if dtype == torch.float32 else lib.broadphase_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in args), n,
                 *(t.data_ptr() for t in args_s), m, int(n_self),
                 int(n_skip_rows), int(k_max), cap, int(bool(periodic)),
                 2.0 * float(lx), 2.0 * float(ly), s_r2.data_ptr(),
                 s_j.data_ptr(), idx.data_ptr(), valid.data_ptr(), shift.data_ptr(),
                 demand.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"broad-phase kernel launch failed: CUDA error "
                           f"{err}")
    count("broadphase.launches")
    return idx, valid, shift, demand > k_max, demand
