"""Validation/test image loading: aspect-preserving letterbox and clip
window (the counterpart of ``dis_yolo_tpu/data/val_data.py``).

Each image is resized to fit ``test_size`` with its aspect ratio kept,
centered on a 127-gray canvas and divided by 255; the normalized window
(y1, x1, y2, x2) of the non-pad region goes with it, for box clipping
and un-letterboxing.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data.augment import resize_bilinear
from dis_yolo_tpu_torch.data.image_io import read_image


def letterbox_image(image_rgb: np.ndarray,
                    size: int) -> Tuple[np.ndarray, np.ndarray]:
    """One RGB image [H, W, 3] -> (canvas [size, size, 3] float32 in
    [0, 1], window [4] float32), with integer-floor resize dimensions and
    centering."""
    ih, iw = image_rgb.shape[:2]
    if size / iw < size / ih:
        new_h = (ih * size) // iw
        new_w = size
    else:
        new_w = (iw * size) // ih
        new_h = size
    resized = resize_bilinear(image_rgb.astype(np.float32), new_w, new_h)
    top = (size - new_h) // 2
    left = (size - new_w) // 2
    canvas = np.full((size, size, 3), 127.0, np.float32)
    canvas[top:top + new_h, left:left + new_w, :] = resized
    window = np.asarray([top / size, left / size, (new_h + top) / size,
                         (new_w + left) / size], np.float32)
    return canvas / 255.0, window


class DefectValData:
    """A split's images, all loaded into memory at once.

    Reads ``<dataset>/<phase>/cache/{ground_truth_cache.pkl,<phase>.txt}``
    and each ``images/<stem>.jpg`` with ``data.image_io.read_image``: a
    binary PPM (whatever its name) is read in numpy, anything else needs
    OpenCV, and ``get`` raises where it is missing.
    """

    def __init__(self, cfg: DISYoloConfig, phase: str = "val"):
        self.cfg = cfg
        self.phase = phase
        split_dir = cfg.data_path(phase)
        cache_dir = os.path.join(split_dir, "cache")
        with open(os.path.join(cache_dir, "ground_truth_cache.pkl"),
                  "rb") as f:
            annotations = pickle.load(f)
        annotations = [a for a in annotations if a["regions"]]
        with open(os.path.join(cache_dir, f"{phase}.txt")) as f:
            index = [x.strip() for x in f.readlines()]
        assert len(index) == len(annotations)
        self.image_paths: List[str] = []
        for i, stem in enumerate(index):
            assert os.path.splitext(annotations[i]["filename"])[0] == stem
            self.image_paths.append(os.path.join(split_dir, "images",
                                                 stem + ".jpg"))

    def get(self):
        """(images [N, size, size, 3] float32, names, windows [N, 4])."""
        size = self.cfg.test_size
        n = len(self.image_paths)
        images = np.zeros((n, size, size, 3), np.float32)
        windows = np.zeros((n, 4), np.float32)
        names = []
        for i, path in enumerate(self.image_paths):
            images[i], windows[i] = letterbox_image(read_image(path), size)
            names.append(os.path.splitext(os.path.basename(path))[0])
        return images, names, windows
