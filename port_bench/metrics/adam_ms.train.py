"""Adam's ``multi_tensor_apply`` kernels (``train/train_step.py``
``adam_apply``, PyTorch's foreach operations).

Device milliseconds per training step of the kernels of this kind
(``train_trace.kernel_kind``) launched inside the training driver's
``block`` span, from the traced sub-window.  Nothing when none ran
there."""

from port_bench.train_trace import device_s_by_kind


def read(out):
    t = out.trace
    if t is None or not t.calls:
        return None
    s = device_s_by_kind(t, "block")["adam"]
    return s / t.calls * 1e3 if s > 0 else None
