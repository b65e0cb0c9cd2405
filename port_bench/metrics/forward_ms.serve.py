"""The network's device time per batch (``models/dis_yolo.py``, ``models/layers.py``).

Device milliseconds per batch of the operations launched inside the
serving driver's ``forward`` span, from the traced sub-window.  Nothing
when no operation ran there."""


def read(out):
    t = out.trace
    if t is None or not t.calls:
        return None
    s = t.span_device_s("forward")
    return s / t.calls * 1e3 if s > 0 else None
