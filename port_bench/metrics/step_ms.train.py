"""A training step's device time (``train/train_step.py``
``make_corpus_multi_step``: the batch's assembly and augmentation on the
card, the train-mode forward, the losses, the backward and Adam).

Device milliseconds per step of the operations launched inside the
training driver's ``block`` span, from the traced sub-window.  Nothing
when no operation ran there."""


def read(out):
    t = out.trace
    if t is None or not t.calls:
        return None
    s = t.span_device_s("block")
    return s / t.calls * 1e3 if s > 0 else None
