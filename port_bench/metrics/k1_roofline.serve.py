"""Kernel K1's (``csrc/assembly.cu``) share of its roofline, in percent:
the least time its bytes and operations need on the traced batches'
boxes (``work.k1_work``), per call, over its profiled device time per
call."""


def read(out):
    t = out.trace
    bound = out.counters.get("k1_bound_s_per_call")
    if t is None or not bound:
        return None
    secs, calls = t.named_device_s("assembly_kernel")
    return bound * calls / secs * 100.0 if calls and secs > 0 else None
