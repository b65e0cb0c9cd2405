"""The whole training step's share of the card's bf16 peak, in percent:
the step's convolution FLOPs per image (``port_bench/train_work.py``:
forward, weight gradients, input gradients but the first layer's) times
the images per second of the traced run's unprofiled window, over 989
TFLOP/s."""

from port_bench.work import BF16_FLOPS


def read(out):
    c = out.counters
    if not c.get("rate_img_per_s") or not c.get("flops_per_image"):
        return None
    return c["flops_per_image"] * c["rate_img_per_s"] / BF16_FLOPS * 100.0
