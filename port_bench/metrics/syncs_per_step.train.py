"""Host syncs per training step, counted under PyTorch's sync debug mode
over a block after the traced sub-window."""


def read(out):
    return out.counters.get("syncs_per_step")
