"""Device time of a traced training window by kind of kernel.

``kernel_kind`` sorts a kernel by its name, as the profiler reports it:

  * ``conv``: cuDNN's and cuBLAS's convolutions and GEMMs (``nvjet``
    kernels are cuBLAS's), forward, data gradient and weight gradient,
    with cuDNN's layout transforms around them;
  * ``adam``: ``multi_tensor_apply`` kernels, the optimizer's foreach
    operations;
  * ``reduce``: reductions (sums and means over the batch, norms,
    maxima);
  * ``eltwise``: elementwise kernels, the casts and copies among them,
    concatenation and fills;
  * ``other``: everything else (indexing, sorting, the port's own
    kernels).
"""

from __future__ import annotations

from typing import Dict

KINDS = ("conv", "adam", "reduce", "eltwise", "other")
_CONV = ("conv", "cudnn", "xmma", "gemm", "cutlass", "fprop", "dgrad",
         "wgrad", "nchwtonhwc", "nhwctonchw", "sm90_", "sm80_", "nvjet")
_ELTWISE = ("elementwise", "catarraybatchedcopy", "fill", "copy_kernel")


def kernel_kind(name: str) -> str:
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "adam"
    if any(s in low for s in _CONV):
        return "conv"
    if "reduce" in low:
        return "reduce"
    if any(s in low for s in _ELTWISE):
        return "eltwise"
    return "other"


def device_s_by_kind(trace, span: str) -> Dict[str, float]:
    """Device seconds of the kernels launched inside ``span``, by kind."""
    out = dict.fromkeys(KINDS, 0.0)
    for _, dur, name, at, _ in trace.kernels():
        if at == span:
            out[kernel_kind(name)] += dur
    return out
