"""Work counts of the int8 serving graph (``quant``), from its layer
shapes, and the card's int8 peak they are held against.

  * ``forward_ops``: one image's convolution operations (2 per
    multiply-add) split by the dtype they run in: the int8 layers (the
    BatchNorm layers of ``quant_layers``, 5-85 by default: the s8 x s8
    GEMMs) and the rest (the stem, layers 1-4, and the four bias head
    convs, in bfloat16).  The same layer shapes as ``work.forward_flops``,
    so the two parts sum to its count: 132.68 GFLOP at 576^2 with the
    stride-2 decoder.  These are the GEMMs' operations before
    ``torch._int_mm``'s zero padding, which the port's counter
    ``quant.int_mm_ops`` counts alike;
  * ``ideal_s``: the least time of one image's forward with each layer
    at its own dtype's dense peak;
  * ``int8_gemm_s``: the traced device time of the int8 GEMM kernels,
    found by name as ``chip_smoke.py``'s "int8 gemm" kind finds them.

Peak: NVIDIA's data sheet for one H100 SXM, dense int8 tensor cores,
1979 TOPS (bfloat16 989 TFLOP/s, ``work.BF16_FLOPS``).
"""

from __future__ import annotations

from typing import Iterable, Tuple

from port_bench.work import BF16_FLOPS, layer_stride

INT8_OPS = 1979e12
INT8_GEMM_KEYS = ("gemm_s8", "imma", "s8s8", "i8i8")


def forward_ops(specs, image_size: int, mask_stride: int,
                quant_layers: Iterable[int]) -> Tuple[float, float]:
    """(int8 operations, other operations) of one image's forward."""
    quant_layers = set(quant_layers)
    int8 = other = 0
    for idx, kind, cin, cout, k, _ in specs:
        side = -(-image_size // layer_stride(idx, mask_stride))
        ops = 2 * cin * cout * k * k * side * side
        if kind == "cbn" and idx in quant_layers:
            int8 += ops
        else:
            other += ops
    return float(int8), float(other)


def ideal_s(int8_ops: float, other_ops: float) -> float:
    """Seconds at the dense peaks: int8 at 1979 TOPS, the rest at 989
    TFLOP/s."""
    return int8_ops / INT8_OPS + other_ops / BF16_FLOPS


def int8_gemm_s(trace) -> Tuple[float, int]:
    """Device seconds and count of the int8 GEMM kernels of a traced
    window (``port_bench/trace.py``'s ``Trace``)."""
    hits = [op[1] for op in trace.kernels()
            if any(k in op[2].lower() for k in INT8_GEMM_KEYS)]
    return sum(hits), len(hits)
