"""Post-forward device time per batch: decode, NMS, the box drop and K1 (``ops/decode.py``, ``ops/nms.py``, ``ops/custom_ops.py``).

Device milliseconds per batch of the operations launched inside the
serving driver's ``predict_from_outputs`` span, from the traced sub-window.  Nothing
when no operation ran there."""


def read(out):
    t = out.trace
    if t is None or not t.calls:
        return None
    s = t.span_device_s("predict_from_outputs")
    return s / t.calls * 1e3 if s > 0 else None
