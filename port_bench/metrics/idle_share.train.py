"""The card's idle share of the traced training sub-window, in percent:
1 minus the union of its device operations' intervals over the window's
wall time."""


def read(out):
    t = out.trace
    if t is None or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
