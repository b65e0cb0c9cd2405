"""The int8 layers' glue, device time per batch (``models/quant.py``).

Device milliseconds per batch of the operations launched inside the
program's spans ``dis_yolo.quant.quantize``, ``dis_yolo.quant.im2col``
and ``dis_yolo.quant.dequant`` (the quantize, the unfold and the
operands' layout, the dequantize with its cast and leaky ReLU), from the
program's own profiled window (``program_trace.program_window``).
Nothing where the program opens no such span."""

SPANS = ("dis_yolo.quant.quantize", "dis_yolo.quant.im2col",
         "dis_yolo.quant.dequant")


def read(out):
    program = out.counters.get("program")
    if not program:
        return None
    ms = sum(program["spans"].get(name, {}).get("device_ms", 0.0)
             for name in SPANS)
    return ms if ms > 0 else None
