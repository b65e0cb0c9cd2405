"""Work counts: the operations and bytes a call needs, from its shapes,
and the card's published peaks they are held against.

  * ``forward_flops``: the network's convolution FLOPs per image (2 per
    multiply-add), layer by layer from ``reference.net.layer_specs``
    (the arithmetic of the JAX package's ``forward_budget.bucket_flops``,
    rewritten): 132.68 GFLOP at 576^2 with the stride-2 decoder, 136.52
    with the stride-1 decoder.  ``bucket_flops`` counts 126.57 and
    130.40: it misses one 3x3 conv in the stride-16 and stride-8 towers;
  * ``k1_work``: kernel K1 (mask assembly) as its boxes need it: every
    mask pixel written once (a padding row's mask is zeros, but the
    output is dense), each score-map pixel inside some box read once
    (at least one of its k^2 values), the boxes read; 6 operations per
    mask pixel inside its box and 2 per further bin edge.  The port's
    card check counted the whole score map read and every pixel's
    operations, which with few boxes is more than K1 needs;
  * ``k3_bytes``: kernel K3 (the assembly's backward) reads the
    upstream gradient only inside the ROIs, reads the boxes and writes
    the dense score-map gradient;
  * ``paste_work``: the paste of one batch as these inputs need it: the
    masks of the valid rows read once, their boolean masks at the
    photo's size and the semantic map written once, and 4 bilinear taps
    (4 multiply-adds, 8 operations) per output pixel inside each valid
    box.  Padding rows and pixels outside the boxes need no work.

Peaks are NVIDIA's data sheet for one H100 SXM, dense: 989 TFLOP/s
bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# output stride of each conv layer, relative to the input image
_STRIDE = {1: 1, 2: 2, 3: 2, 4: 2}
for _lo, _hi, _stride in ((5, 10, 4), (10, 27, 8), (27, 44, 16),
                          (44, 61, 32), (61, 69, 16), (69, 77, 8),
                          (77, 80, 4), (80, 82, 2)):
    _STRIDE.update(dict.fromkeys(range(_lo, _hi), _stride))


def layer_stride(idx: int, mask_stride: int) -> int:
    """Output stride of conv layer ``idx`` (82-85 depend on the
    decoder: 82 is the stride-2 score-map head or, at stride 1, the 1x1
    before the last upsample)."""
    if idx in _STRIDE:
        return _STRIDE[idx]
    if idx == 82:
        return 2
    if idx in (83, 84, 85) and mask_stride == 1:
        return 1
    raise ValueError(f"no layer {idx} at mask stride {mask_stride}")


def forward_flops(specs, image_size: int, mask_stride: int) -> float:
    """Convolution FLOPs of one image's forward (2 per multiply-add)."""
    total = 0
    for idx, _, cin, cout, k, _ in specs:
        side = -(-image_size // layer_stride(idx, mask_stride))
        total += 2 * cin * cout * k * k * side * side
    return float(total)


def roofline_s(bytes_moved: float, ops: float, peak_ops: float = FP32_FLOPS
               ) -> Tuple[float, str]:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over ``peak_ops``, whichever is larger, and which."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(boxes, size: int, k: int) -> Tuple[float, float]:
    """(bytes, operations) of one K1 call on ``boxes`` [B, D, 4]
    (y1, x1, y2, x2, normalized), rounded to score-map pixels as K1
    rounds them."""
    px = np.rint(np.asarray(boxes, np.float32) * np.float32(size))
    px = np.clip(px, 0, size).astype(np.int64)
    batch, rows = px.shape[:2]
    inside = covered = 0
    for image in px:
        cover = np.zeros((size, size), bool)
        for y1, x1, y2, x2 in image:
            if y2 > y1 and x2 > x1:
                cover[y1:y2, x1:x2] = True
                inside += int((y2 - y1) * (x2 - x1))
        covered += int(cover.sum())
    nbytes = batch * rows * size * size * 4 + covered * 4 + batch * rows * 16
    return float(nbytes), float(inside * (6 + 2 * (k - 1)))


def k3_bytes(inside_px: float, n_roi_boxes: int, batch: int, size: int,
             k: int) -> float:
    return float(inside_px * 4 + n_roi_boxes * 4 * 4
                 + batch * size * size * k * k * 4)


def paste_work(boxes_px: Iterable[Tuple[int, int, int, int]],
               n_images: int, image_h: int, image_w: int, mask_size: int
               ) -> Tuple[float, float]:
    """(bytes, operations) of pasting the valid detections whose boxes
    in the photo's pixels are ``boxes_px`` (y1, x1, y2, x2), over
    ``n_images`` photos of one size."""
    boxes = list(boxes_px)
    inside = sum(max(y2 - y1, 0) * max(x2 - x1, 0)
                 for y1, x1, y2, x2 in boxes)
    nbytes = (len(boxes) * mask_size * mask_size * 4
              + len(boxes) * image_h * image_w
              + n_images * image_h * image_w)
    return float(nbytes), float(8 * inside)
