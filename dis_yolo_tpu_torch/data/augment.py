"""Host image resampling (the part of ``dis_yolo_tpu/data/augment.py``
that the evaluation path needs).

``resize_bilinear`` is the numpy formula only: cv2 INTER_LINEAR's
half-pixel mapping, src = (dst + 0.5) * src_size / dst_size - 0.5, with
edge clamping.  The JAX package calls ``cv2.resize`` when OpenCV imports
and this formula otherwise; the port keeps the formula alone, so it gives
the same answer on a machine without OpenCV (or PIL), as the card's has.
The output keeps the input's rank, as ``cv2.resize`` does for one- and
three-channel images: the JAX package's formula ends in ``squeeze()``,
which also drops a length-1 height or width (a one-pixel-wide box's
paste then fails to broadcast); the values are the same.
"""

from __future__ import annotations

import numpy as np


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize of [H, W] or [H, W, C] to (w, h), align-corners
    False (cv2-compatible)."""
    src_h, src_w = img.shape[:2]
    ys = (np.arange(h) + 0.5) * src_h / h - 0.5
    xs = (np.arange(w) + 0.5) * src_w / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, src_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, src_w - 1)
    y1 = np.clip(y0 + 1, 0, src_h - 1)
    x1 = np.clip(x0 + 1, 0, src_w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    flat = img.ndim == 2
    if flat:
        img = img[:, :, None]
    out = ((img[y0][:, x0] * (1 - wy)[..., None]
            + img[y1][:, x0] * wy[..., None]) * (1 - wx)[..., None]
           + (img[y0][:, x1] * (1 - wy)[..., None]
              + img[y1][:, x1] * wy[..., None]) * wx[..., None])
    return out[:, :, 0] if flat else out
