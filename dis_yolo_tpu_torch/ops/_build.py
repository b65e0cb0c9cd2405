"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the root
of the checkout, then loaded with ``ctypes``.  The library's file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  ``-fmad=false`` is part of
the kernels' contract: without it the compiler may contract a*b+c into
one FMA and the grid-line and IoU roundings stop matching float32 on the
CPU.

Nothing here runs at import time; the first kernel call builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each kernel library: (C entry point, its argtypes); every one returns int
SIGNATURES: Dict[str, Tuple[str, tuple]] = {
    # scoremaps, boxes, out, batch, n_box, size, k, apply_sigmoid,
    # pixel_boxes, planes, stream
    "assembly": ("dis_assemble_masks",
                 (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    # boxes_px, g, out, batch, n_roi, size, k, stream
    "assembly_bwd": ("dis_assemble_bwd", (_P, _P, _P, _I, _I, _I, _I, _P)),
    # boxes, scores, classes, valid, out, batch, k, max_det, thr, stream
    "nms": ("dis_nms", (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P)),
    # in, out, batch, size, k*k, in_bf16, stream
    "extract": ("dis_extract_planes", (_P, _P, _I, _I, _I, _I, _P)),
}
KERNELS = tuple(SIGNATURES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns name -> library path; the
    compiler's output (ptxas register and spill counts) is kept beside
    each library as ``.log``."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, todo[name])
        else:
            failed.append(f"{name} (nvcc exit {rc}): "
                          + todo[name].with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The kernel's C entry point, built if needed, with its argtypes set."""
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
