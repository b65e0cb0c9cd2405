"""Detection post-processing back to original image coordinates, on the
host (numpy; the counterpart of ``dis_yolo_tpu/eval/postprocess.py``).

Invert the letterbox to original pixels, crop the score-map-sized
sigmoid mask by the normalized box, bilinear-resize the crop to the
box's size, binarize at 0.5 and paste into a full-resolution canvas.
The rounding choices are the reference's, and mAP parity depends on
them: ``np.around`` (half to even), ``//2`` integer offsets and a strict
``> 0.5``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from dis_yolo_tpu_torch.data.augment import resize_bilinear


def correct_yolo_box(x1: float, y1: float, x2: float, y2: float,
                     image_h: int, image_w: int, net_h: int, net_w: int
                     ) -> Tuple[int, int, int, int]:
    """Normalized letterboxed coords -> integer original-image coords."""
    if (float(net_w) / image_w) < (float(net_h) / image_h):
        new_w = net_w
        new_h = (image_h * net_w) // image_w
    else:
        new_h = net_h
        new_w = (image_w * net_h) // image_h
    x_off, x_scale = float((net_w - new_w) // 2) / net_w, float(new_w) / net_w
    y_off, y_scale = float((net_h - new_h) // 2) / net_h, float(new_h) / net_h
    xi1 = int(max(min(np.around((x1 - x_off) / x_scale * image_w), image_w), 0))
    xi2 = int(max(min(np.around((x2 - x_off) / x_scale * image_w), image_w), 0))
    yi1 = int(max(min(np.around((y1 - y_off) / y_scale * image_h), image_h), 0))
    yi2 = int(max(min(np.around((y2 - y_off) / y_scale * image_h), image_h), 0))
    return xi1, yi1, xi2, yi2


def paste_mask(pred_mask: np.ndarray, box_norm: np.ndarray,
               box_px: Tuple[int, int, int, int],
               image_h: int, image_w: int) -> np.ndarray:
    """Crop the sigmoid mask by the normalized box, resize, binarize,
    paste -> bool [image_h, image_w]."""
    x1, y1, x2, y2 = box_px
    size = pred_mask.shape[0]
    yn1 = int(np.around(box_norm[0] * size))
    xn1 = int(np.around(box_norm[1] * size))
    yn2 = int(np.around(box_norm[2] * size))
    xn2 = int(np.around(box_norm[3] * size))
    crop = pred_mask[yn1:yn2, xn1:xn2]
    full = np.zeros((image_h, image_w), dtype=bool)
    if crop.size == 0:  # degenerate at score-map resolution: empty instance
        return full
    resized = resize_bilinear(np.ascontiguousarray(crop, np.float32),
                              x2 - x1, y2 - y1)
    full[y1:y2, x1:x2] = resized > 0.5
    return full


def detections_to_original(dets: np.ndarray, masks: np.ndarray,
                           image_h: int, image_w: int, net_size: int,
                           merged_map: Optional[np.ndarray] = None
                           ) -> List[Dict]:
    """One image's padded [D,6] detections + [D,S,S] masks -> original-size
    instances [{'classid', 'score', 'box', 'mask'}].

    Skips padding rows (score <= 0) and boxes degenerate in original
    pixels; if ``merged_map`` (uint8 [image_h, image_w]) is given, paints
    classid + 1 into it for the mIoU semantic map (later detections
    overwrite earlier ones).
    """
    out = []
    for k in range(dets.shape[0]):
        score = float(dets[k, 5])
        if score <= 0.0:
            continue
        y1n, x1n, y2n, x2n = (float(v) for v in dets[k, :4])
        classid = int(dets[k, 4])
        x1, y1, x2, y2 = correct_yolo_box(x1n, y1n, x2n, y2n,
                                          image_h, image_w, net_size, net_size)
        if (y2 - y1) * (x2 - x1) <= 0:
            continue
        full = paste_mask(masks[k], dets[k, :4], (x1, y1, x2, y2),
                          image_h, image_w)
        out.append({"classid": classid, "score": score,
                    "box": (x1, y1, x2, y2), "mask": full})
        if merged_map is not None:
            merged_map[full] = classid + 1
    return out
