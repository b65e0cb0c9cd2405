"""A seeded synthetic training batch in the reference's feed layout, made
with numpy: the training slice's input on the card (``chip_smoke.py``)
and in the CPU parity tests, where no dataset is at hand."""

from __future__ import annotations

from typing import Dict

import numpy as np

from dis_yolo_tpu_torch.config import DISYoloConfig


def synthetic_batch(cfg: DISYoloConfig, batch_size: int, n_boxes: int,
                    seed: int) -> Dict[str, np.ndarray]:
    """``n_boxes`` random GT boxes per image, each with an elliptic mask
    inside it and its label at the best-matching anchor's cell:

    images [B,H,W,3] f32 in [0,1); true_masks [B,T,H,W] bool; true_boxes
    [B,1,1,1,T,5] normalized (xc, yc, w, h, classid), zero rows = padding;
    labels_s8 / labels_s16 / labels_s32 [B,g,g,A,5+C] (xc, yc, w, h, 1,
    one-hot class); windows [B,4] = the whole image.
    """
    if not 0 < n_boxes <= cfg.max_box_per_image:
        raise ValueError(f"n_boxes must be in [1, {cfg.max_box_per_image}]")
    rng = np.random.RandomState(seed)
    s, t, c = cfg.image_size, cfg.max_box_per_image, cfg.num_class
    a = cfg.anchors_per_scale
    grids = cfg.grid_sizes()
    anchors = cfg.anchors_array() / np.float32(s)        # as decode scales them
    images = rng.rand(batch_size, s, s, 3).astype(np.float32)
    masks = np.zeros((batch_size, t, s, s), bool)
    boxes = np.zeros((batch_size, 1, 1, 1, t, 5), np.float32)
    labels = [np.zeros((batch_size, g, g, a, 5 + c), np.float32) for g in grids]
    pos = (np.arange(s, dtype=np.float32) + 0.5) / s
    for i in range(batch_size):
        for j in range(n_boxes):
            w, h = rng.uniform(0.1, 0.45, 2).astype(np.float32)
            xc = np.float32(rng.uniform(w / 2, 1 - w / 2))
            yc = np.float32(rng.uniform(h / 2, 1 - h / 2))
            cls = rng.randint(c)
            boxes[i, 0, 0, 0, j] = (xc, yc, w, h, cls)
            ry = ((pos - yc) / (h / 2)) ** 2
            rx = ((pos - xc) / (w / 2)) ** 2
            masks[i, j] = ry[:, None] + rx[None, :] <= 1.0
            inter = np.minimum(w, anchors[:, 0]) * np.minimum(h, anchors[:, 1])
            iou = inter / (w * h + anchors[:, 0] * anchors[:, 1] - inter)
            best = int(np.argmax(iou))
            scale, slot = best // a, best % a
            g = grids[scale]
            row = labels[scale][i, int(yc * g), int(xc * g), slot]
            row[:4] = (xc, yc, w, h)
            row[4] = 1.0
            row[5 + cls] = 1.0
    return dict(images=images, true_masks=masks, true_boxes=boxes,
                labels_s8=labels[0], labels_s16=labels[1],
                labels_s32=labels[2],
                windows=np.tile(np.array([0, 0, 1, 1], np.float32),
                                (batch_size, 1)))
