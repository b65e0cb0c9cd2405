"""Reductions (BatchNorm's batch moments and their gradients, the losses'
sums and means, the finite checks; ``models/layers.py``, ``losses/``,
``train/train_step.py``).

Device milliseconds per training step of the kernels of this kind
(``train_trace.kernel_kind``) launched inside the training driver's
``block`` span, from the traced sub-window.  Nothing when none ran
there."""

from port_bench.train_trace import device_s_by_kind


def read(out):
    t = out.trace
    if t is None or not t.calls:
        return None
    s = device_s_by_kind(t, "block")["reduce"]
    return s / t.calls * 1e3 if s > 0 else None
