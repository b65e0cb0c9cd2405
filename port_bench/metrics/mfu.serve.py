"""The whole predict's share of the card's bf16 peak, in percent: the
network's convolution FLOPs per image (``port_bench/work.py``) times the
images per second of the traced run's unprofiled window, over 989
TFLOP/s."""

from port_bench.work import BF16_FLOPS


def read(out):
    c = out.counters
    if not c.get("rate_img_per_s") or not c.get("flops_per_image"):
        return None
    return c["flops_per_image"] * c["rate_img_per_s"] / BF16_FLOPS * 100.0
