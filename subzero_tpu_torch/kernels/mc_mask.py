"""The births' Monte-Carlo mask: its Hopper CUDA kernel and its wrapper.

``mc_mask_cuda(verts, nv, mc_xy)`` tests each floe's Monte-Carlo points for
lying inside its body-frame polygon, in one launch of the kernel of
``csrc/mc_mask.cu``, and returns the bool mask on the card.  It gives the
mask of the plain version, ``state.py:mc_inside`` (the numpy broadcast of
the JAX package's ``make_floe_arrays``), bit for bit.  It replaces no TPU
kernel: the JAX package computes this mask in numpy on the host.
``state.make_floe_arrays`` launches it for a CUDA device and runs the plain
version otherwise; there is no fallback.

The kernel is built like ``csrc/clip.cu`` (``kernels/clip.py``): ``nvcc`` at
first use, the same flags (``--fmad=false``), a plain C interface loaded with
``ctypes``, cached under ``subzero_tpu_torch/_build/``.

Each launch adds 1 to the count ``mc_mask.launches`` and its floes to
``mc_mask.floes`` of the active ``trace.Table``, so a run can show its
births went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..trace import count
from .clip import _PKG, load_library

__all__ = ["mc_mask_cuda", "build"]

SOURCE = _PKG / "csrc" / "mc_mask.cu"

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
            _lib = load_library(SOURCE, {"mc_mask_f64": [p, p, i, i, p, i,
                                                         p, p]}, build_info)
        return _lib


def mc_mask_cuda(verts: torch.Tensor, nv: torch.Tensor,
                 mc_xy: torch.Tensor) -> torch.Tensor:
    """The bool mask ``[B, P]`` of the points ``mc_xy`` ``[B, P, 2]`` inside
    the polygons ``verts`` ``[B, V, 2]`` with ``nv`` ``[B]`` real vertices
    (padded with vertex 0), all float64 (int32 ``nv``) on one CUDA device;
    raises otherwise.  B may be 0."""
    dev = verts.device
    if dev.type != "cuda":
        raise ValueError(f"mc_mask_cuda needs CUDA tensors, got {dev}")
    if verts.dtype != torch.float64 or mc_xy.dtype != torch.float64:
        raise TypeError("the Monte-Carlo mask kernel needs float64 vertices "
                        "and points")
    if nv.dtype != torch.int32:
        raise TypeError("the Monte-Carlo mask kernel needs int32 nv")
    if nv.device != dev or mc_xy.device != dev:
        raise ValueError("the Monte-Carlo mask kernel needs every input on "
                         "one device")
    b = verts.shape[0]
    if (verts.ndim != 3 or verts.shape[2] != 2 or verts.shape[1] < 1
            or mc_xy.ndim != 3 or mc_xy.shape[0] != b or mc_xy.shape[2] != 2
            or mc_xy.shape[1] < 1 or nv.shape != (b,)):
        raise ValueError(f"Monte-Carlo mask kernel: expected [B, V, 2], [B] "
                         f"and [B, P, 2], got {tuple(verts.shape)}, "
                         f"{tuple(nv.shape)} and {tuple(mc_xy.shape)}")
    v, p = verts.shape[1], mc_xy.shape[1]
    mask = torch.empty((b, p), dtype=torch.bool, device=dev)
    if b == 0:
        return mask
    verts, nv, mc_xy = verts.contiguous(), nv.contiguous(), mc_xy.contiguous()
    if mc_xy.data_ptr() % 16:
        mc_xy = mc_xy.clone()     # the kernel loads a point as one double2
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_mask_f64(verts.data_ptr(), nv.data_ptr(), b, v,
                              mc_xy.data_ptr(), p, mask.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"Monte-Carlo mask kernel launch failed: CUDA "
                           f"error {err}")
    count("mc_mask.launches")
    count("mc_mask.floes", b)
    return mask
