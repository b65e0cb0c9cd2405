"""The int8 GEMMs' device time per batch (``models/quant.py``'s
``torch._int_mm``).

Device milliseconds per batch of the kernels whose names mark an int8
GEMM (``work_int8.INT8_GEMM_KEYS``: ``gemm_s8``, ``imma``, ``s8s8``,
``i8i8``), from the traced sub-window.  Nothing when none ran."""

from port_bench.work_int8 import int8_gemm_s


def read(out):
    t = out.trace
    if t is None or not t.calls:
        return None
    secs, n = int8_gemm_s(t)
    return secs / t.calls * 1e3 if n and secs > 0 else None
