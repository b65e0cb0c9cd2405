"""The work of one training step, from its shapes.

``train_flops``: convolution FLOPs per image of a training step (2 per
multiply-add): the forward (``work.forward_flops``), the weight gradient
of every layer (the same multiply-adds as its forward) and the input
gradient of every layer but the first, whose input is the image and
needs none: ``3 x forward - conv1``.  397.48 GFLOP at 576^2 with the
stride-2 decoder.  The loss, BatchNorm and Adam are elementwise work and
not counted; ``mfu.train`` holds this against the bf16 peak.
"""

from __future__ import annotations

from port_bench.work import forward_flops, layer_stride


def train_flops(specs, image_size: int, mask_stride: int) -> float:
    first = specs[0]
    side = -(-image_size // layer_stride(first[0], mask_stride))
    conv1 = 2 * first[2] * first[3] * first[4] ** 2 * side * side
    return 3 * forward_flops(specs, image_size, mask_stride) - conv1
