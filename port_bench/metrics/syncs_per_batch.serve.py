"""Host syncs per serving batch, counted under PyTorch's sync debug mode
over a few batches after the traced sub-window."""


def read(out):
    return out.counters.get("syncs_per_batch")
