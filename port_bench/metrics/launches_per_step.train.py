"""Kernel launches per training step in the traced sub-window."""


def read(out):
    t = out.trace
    if t is None or not t.calls:
        return None
    return len(t.kernels()) / t.calls
