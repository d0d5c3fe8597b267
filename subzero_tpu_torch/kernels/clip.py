"""Parity-integral clip: the Hopper CUDA kernel and its dispatching wrapper.

``overlap_stats(p, q)`` / ``difference_stats(p, q)`` take ``[B, Vp, 2]`` and
``[B, Vq, 2]`` polygon pairs and return ``OverlapStats``:

* on CUDA tensors they launch the kernel of ``csrc/clip.cu``, the
  hand-written kernel of the XLA twin
  ``subzero_tpu/geometry/clip_integral.py:clip_integral_bm`` (XLA code in
  the JAX package, no TPU kernel: the Pallas kernel's math has its own
  kernel, ``kernels/clip_pallas.py``), or raise — there is no fallback;
* on CPU tensors they run the plain PyTorch version,
  ``geometry/clip_integral.clip_integral_bm``.

The kernel is compiled at first use, from the package's own source, with
``nvcc`` into a shared library with a plain C interface (loaded with
``ctypes``), cached under ``subzero_tpu_torch/_build/`` by a hash of the
source and flags.  Nothing is built or imported from CUDA when the module is
imported, so the CPU path works without ``nvcc`` or a GPU.

Each launch adds 1 to the count ``clip.launches`` of the active
``trace.Table``, so a run can show its main path went through the kernel.

The kernel gives each pair a group of G lanes; ``lane_group(B, Vp, Vq)``
picks G, and ``tile_bytes`` is the shared memory one block of the kernel
takes (the wrapper raises on shapes whose tile does not fit).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..geometry.clip import OverlapStats
from ..geometry.clip_integral import clip_integral_bm, eps_scale
from ..trace import count

__all__ = [
    "overlap_stats",
    "difference_stats",
    "clip_stats",
    "clip_stats_cuda",
    "build",
    "compile_source",
    "load_library",
    "lane_group",
    "tile_bytes",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "clip.cu"
BUILD_DIR = _PKG / "_build"
# --fmad=false and no --use_fast_math: products, differences, 1/x and sqrt
# round as IEEE operations, like the plain version, so n_cross agrees exactly.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# Threads per block of the kernel (csrc/clip.cu:kThreads); a block takes
# THREADS // G pairs.
THREADS = 128
# Dynamic shared memory a block may take on sm_90 (227 KB).
SMEM_LIMIT = 232448
# Threads that fill an H100: 132 SMs x 512.
FILL_THREADS = 132 * 512

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA clip kernel cannot be built")


def compile_source(source: Path) -> tuple[Path, bool, str]:
    """Compile ``source`` with ``NVCC_FLAGS`` into a shared library under
    ``BUILD_DIR``, once per hash of source, the headers beside it and flags.
    Returns the library path, whether it was compiled by this call, and
    nvcc's ``-Xptxas -v`` report (kept beside the library)."""
    source = Path(source)
    headers = b"".join(h.read_bytes()
                       for h in sorted(source.parent.glob("*.cuh")))
    key = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"{source.stem}-{key[:16]}.so"
    if so.exists():
        log = so.with_suffix(".log")
        return so, False, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                             capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)   # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, True, log


def load_library(source: Path, argtypes: dict, info: dict) -> ctypes.CDLL:
    """Compile ``source`` (``compile_source``) and load it with ``ctypes``,
    declaring ``argtypes[name]`` (and an int return) for each function.
    Fills ``info`` with the library path, whether it was compiled in this
    process, the seconds that took and nvcc's ``-Xptxas -v`` report."""
    t0 = time.perf_counter()
    so, compiled, log = compile_source(source)
    lib = ctypes.CDLL(str(so))
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    info.update(path=str(so), compiled=compiled,
                seconds=time.perf_counter() - t0, log=log)
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; fills
    ``build_info`` (``load_library``)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            types = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = load_library(SOURCE, {"clip_stats_f32": types,
                                         "clip_stats_f64": types},
                                build_info)
        return _lib


def tile_bytes(g: int, vp: int, vq: int, itemsize: int) -> int:
    """Dynamic shared memory of one kernel block at lane-group width ``g``
    (mirrors ``tile_bytes`` in csrc/clip.cu): the staged raw tile, the
    real-edge lists (x0, y0, dx, dy per slot, stride pairs + 1), and eps
    and the two real-edge counts per pair."""
    bt = THREADS // g
    ld, v = bt + 1, vp + vq
    return (bt * v * 2 * itemsize + v * ld * 4 * itemsize + bt * itemsize
            + 2 * bt * 4)


@functools.lru_cache(maxsize=256)
def lane_group(b: int, vp: int, vq: int) -> int:
    """Lanes per pair, G in {1, 2, 4, 8, 16, 32}, for B pairs of Vp x Vq
    slots.

    About one lane per real edge of the wider polygon, taking its real
    edges as a quarter of up to 16 slots (the quad lattice pads 4 vertices
    to 16) and half of more (the default capacity holds 10-30 vertices in
    64); more while the B·G threads would not fill the card; at least the
    smallest G whose tile fits in shared memory in float64; at most the
    wider polygon's slot count.  Fitted to a sweep of G on an H100 (see
    PERF.md)."""
    vmax = max(vp, vq)
    want = vmax // 4 if vmax <= 16 else vmax // 2
    g = 1
    while g < 32 and tile_bytes(g, vp, vq, 8) > SMEM_LIMIT:
        g *= 2
    cap = 1
    while cap < min(vmax, 32):
        cap *= 2
    while g < cap and (g < want or b * g < FILL_THREADS):
        g *= 2
    return g


def _check(p: torch.Tensor, q: torch.Tensor):
    if p.device != q.device:
        raise ValueError(f"p on {p.device} but q on {q.device}")
    if p.dtype != q.dtype or p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"clip needs float32 or float64 pairs of one dtype, "
                        f"got {p.dtype} and {q.dtype}")
    if (p.ndim != 3 or q.ndim != 3 or p.shape[2] != 2 or q.shape[2] != 2
            or p.shape[0] != q.shape[0] or p.shape[1] < 1 or q.shape[1] < 1):
        raise ValueError(f"expected [B, Vp, 2] and [B, Vq, 2], got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")


def clip_stats_cuda(p: torch.Tensor, q: torch.Tensor,
                    difference: bool) -> OverlapStats:
    """Launch the CUDA kernel on CUDA tensors ``p [B, Vp, 2]``,
    ``q [B, Vq, 2]`` (contiguous, float32 or float64); raises otherwise."""
    _check(p, q)
    if p.device.type != "cuda":
        raise ValueError(f"clip_stats_cuda needs CUDA tensors, got {p.device}")
    if not (p.is_contiguous() and q.is_contiguous()):
        raise ValueError("clip_stats_cuda needs contiguous inputs")
    b, vp, vq = p.shape[0], p.shape[1], q.shape[1]
    g = lane_group(b, vp, vq)
    if tile_bytes(g, vp, vq, p.element_size()) > SMEM_LIMIT:
        raise ValueError(f"clip kernel: Vp={vp}, Vq={vq} in {p.dtype} need "
                         f"{tile_bytes(g, vp, vq, p.element_size())} B of "
                         f"shared memory per block, more than {SMEM_LIMIT}")
    kw = dict(dtype=p.dtype, device=p.device)
    area = torch.empty((b,), **kw)
    cent = torch.empty((b, 2), **kw)
    chord = torch.empty((b, 2), **kw)
    ncross = torch.empty((b,), dtype=torch.int32, device=p.device)
    if b == 0:
        return OverlapStats(area=area, centroid=cent, chord_p=chord,
                            n_cross=ncross)
    lib = build()
    fn = lib.clip_stats_f32 if p.dtype == torch.float32 else lib.clip_stats_f64
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), q.data_ptr(), b, vp, vq, int(difference),
                 eps_scale(p.dtype), g, area.data_ptr(), cent.data_ptr(),
                 chord.data_ptr(), ncross.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"clip kernel launch failed: CUDA error {err}")
    count("clip.launches")
    return OverlapStats(area=area, centroid=cent, chord_p=chord,
                        n_cross=ncross)


def clip_stats(p: torch.Tensor, q: torch.Tensor,
               difference: bool) -> OverlapStats:
    """P ∩ Q (or P \\ Q) statistics: the kernel on CUDA tensors, the plain
    PyTorch version on CPU tensors."""
    _check(p, q)
    if p.device.type == "cuda":
        return clip_stats_cuda(p.contiguous(), q.contiguous(), difference)
    if p.device.type == "cpu":
        return clip_integral_bm(p, q, difference)
    raise ValueError(f"no clip for device {p.device}")


def overlap_stats(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """P ∩ Q statistics for ``[B, Vp, 2] × [B, Vq, 2]`` pairs."""
    return clip_stats(p, q, difference=False)


def difference_stats(p: torch.Tensor, q: torch.Tensor) -> OverlapStats:
    """P \\ Q statistics for ``[B, Vp, 2] × [B, Vq, 2]`` pairs."""
    return clip_stats(p, q, difference=True)
