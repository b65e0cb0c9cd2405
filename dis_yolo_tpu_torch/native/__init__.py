"""ctypes bindings for the native host data-path kernels (``datapath.cc``):
the polygon fill that ``data/rasterize.py`` uses as its ``native``
engine, and a float32 bilinear resize and letterbox.

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout, as ``ops/_build.py`` builds the CUDA kernels:
its file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  A failed build
raises; nothing here falls back to another engine (callers that want
the numpy fill ask for ``engine="numpy"``).  Nothing runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "datapath.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdatapath-{digest}.so"


def build() -> Path:
    """Compile ``datapath.cc`` unless this source's library exists;
    raises ``RuntimeError`` with the compiler's output on failure."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data path "
                           "(native/datapath.cc) is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native data path build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """The library, built if needed (once per process, thread-safe)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.fill_polygon.argtypes = [f64p, f64p, i64, u8p, i64, i64]
        lib.clear_polygon.argtypes = [f64p, f64p, i64, u8p, i64, i64]
        lib.resize_bilinear_f32.argtypes = [f32p, i64, i64, i64, f32p, i64,
                                            i64]
        lib.letterbox_f32.argtypes = [f32p, i64, i64, i64, f32p, i64, i64,
                                      i64, i64, i64, i64, ctypes.c_float]
        for fn in (lib.fill_polygon, lib.clear_polygon,
                   lib.resize_bilinear_f32, lib.letterbox_f32):
            fn.restype = None
        _lib = lib
        return _lib


def fill_polygon(xs, ys, h: int, w: int, out: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """Even-odd scanline fill + boundary outline (OR-ed into ``out``,
    uint8 [h, w])."""
    lib = _load()
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    if out is None:
        out = np.zeros((h, w), np.uint8)
    lib.fill_polygon(xs, ys, len(xs), out, h, w)
    return out


def clear_polygon(xs, ys, mask: np.ndarray) -> np.ndarray:
    """Clear a hole polygon's filled region from ``mask`` (uint8, in
    place)."""
    lib = _load()
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    lib.clear_polygon(xs, ys, len(xs), mask, mask.shape[0], mask.shape[1])
    return mask


def resize_bilinear_f32(src: np.ndarray, w: int, h: int) -> np.ndarray:
    """Half-pixel-center bilinear resize; src [H,W] or [H,W,C] float32."""
    lib = _load()
    flat = src.ndim == 2
    if flat:
        src = src[:, :, None]
    src = np.ascontiguousarray(src, np.float32)
    dst = np.empty((h, w, src.shape[2]), np.float32)
    lib.resize_bilinear_f32(src, src.shape[0], src.shape[1], src.shape[2],
                            dst, h, w)
    return dst[:, :, 0] if flat else dst


def letterbox_f32(src: np.ndarray, net_h: int, net_w: int, new_h: int,
                  new_w: int, dy: int, dx: int, pad_value: float) -> np.ndarray:
    """Resize into (new_h, new_w) and paste at (dy, dx) of a
    ``pad_value`` canvas [net_h, net_w(, C)]."""
    lib = _load()
    flat = src.ndim == 2
    if flat:
        src = src[:, :, None]
    src = np.ascontiguousarray(src, np.float32)
    dst = np.empty((net_h, net_w, src.shape[2]), np.float32)
    lib.letterbox_f32(src, src.shape[0], src.shape[1], src.shape[2], dst,
                      net_h, net_w, new_h, new_w, dy, dx, pad_value)
    return dst[:, :, 0] if flat else dst
