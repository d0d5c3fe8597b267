"""ctypes binding for the reference's polygon-boolean engine.

A frozen copy of ``subzero_tpu_torch/native/__init__.py`` at commit
61c7962 with its ``polyboolean.cpp``, so the reference shares no library
with the program.  The library is built with ``g++ -O2 -shared -fPIC
-std=c++17`` at first use into the benchmark's own ``_build/`` directory
(a fixed path inside the checkout, listed in ``.gitignore``), and rebuilt
when the source is newer than the library; a failed build raises.

    poly_boolean(p, q, op) -> list of contour arrays [k, 2]

where p/q are single contours ``[n, 2]`` or lists of contours (outer CCW,
holes CW) and op is one of "int", "uni", "dif", "xor".
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "polyboolean.cpp"
BUILD_DIR = _HERE.parent / "_build"
_LIB = BUILD_DIR / "libpolyboolean_ref.so"

_OPS = {"int": 0, "uni": 1, "dif": 2, "xor": 3}

_lib = None
_lock = threading.Lock()


def _build() -> None:
    """Compile into a temporary file and move it into place, so processes
    that build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
               str(_SRC), "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {_SRC} failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB))
        lib.subzero_poly_boolean.restype = ctypes.c_int
        lib.subzero_poly_boolean.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.subzero_poly_area.restype = ctypes.c_double
        lib.subzero_poly_area.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ]
        _lib = lib
        return lib


def _flatten(poly) -> tuple[np.ndarray, np.ndarray]:
    if isinstance(poly, np.ndarray) and poly.ndim == 2:
        poly = [poly]
    pts = np.concatenate([np.asarray(c, dtype=np.float64) for c in poly])
    sizes = np.array([len(c) for c in poly], dtype=np.int32)
    return np.ascontiguousarray(pts), sizes


def poly_boolean(p, q, op: str, max_pts: int = 65536,
                 max_contours: int = 1024) -> list[np.ndarray]:
    """Boolean of two polygons; returns result contours (CCW outer, CW hole).

    The native engine signals -1 only when the *output* exceeds the caller's
    buffers (polyboolean.cpp:309) — the result itself is fine — so the
    wrapper retries with 4x buffers (dense packs at 10k+ floes produce
    channel-network differences with very many contours)."""
    lib = _load()
    p_pts, p_sizes = _flatten(p)
    q_pts, q_sizes = _flatten(q)
    n = -1
    for _ in range(5):
        out_pts = np.empty((max_pts, 2), dtype=np.float64)
        out_sizes = np.empty((max_contours,), dtype=np.int32)
        n = lib.subzero_poly_boolean(
            p_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            p_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(p_sizes),
            q_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            q_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(q_sizes),
            _OPS[op],
            out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_pts, max_contours,
        )
        if n >= 0:
            break
        max_pts *= 4
        max_contours *= 4
    if n < 0:
        raise RuntimeError("poly_boolean: result buffer overflow")
    res = []
    off = 0
    for i in range(n):
        res.append(out_pts[off:off + out_sizes[i]].copy())
        off += out_sizes[i]
    return res


def poly_area(p: np.ndarray) -> float:
    lib = _load()
    p = np.ascontiguousarray(np.asarray(p, dtype=np.float64))
    return float(lib.subzero_poly_area(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p)))


def union_all(polys: list) -> list[np.ndarray]:
    """Union of many polygons (left fold)."""
    if not polys:
        return []
    acc = [np.asarray(polys[0], dtype=np.float64)]
    for p in polys[1:]:
        acc = poly_boolean(acc, p, "uni")
    return acc
