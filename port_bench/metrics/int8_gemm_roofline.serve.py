"""The int8 GEMMs' share of their roofline, in percent: the int8
layers' operations (``work_int8.forward_ops``, from the layer shapes) of
the traced batches over H100 SXM's dense int8 peak of 1979 TOPS, over
the int8 GEMM kernels' traced device time."""

from port_bench.work_int8 import INT8_OPS, int8_gemm_s


def read(out):
    t, c = out.trace, out.counters
    if t is None or not t.calls or not c.get("int8_ops_per_image"):
        return None
    secs, n = int8_gemm_s(t)
    if not n or secs <= 0:
        return None
    ops = c["int8_ops_per_image"] * c["images_per_batch"] * t.calls
    return ops / INT8_OPS / secs * 100.0
