"""The paste's share of its roofline, in percent: the least time the
profiled batches' valid detections need (``work.paste_work``: their
masks read, their boolean masks and the semantic maps written, 4
bilinear taps per pixel inside each box; bytes over 3.35 TB/s or
operations over 67 TFLOP/s, whichever is larger) over the device time
under the ``paste`` span."""


def read(out):
    t = out.trace
    bound = out.counters.get("paste_bound_s")
    if t is None or not bound:
        return None
    secs = t.span_device_s("paste")
    return bound / secs * 100.0 if secs > 0 else None
