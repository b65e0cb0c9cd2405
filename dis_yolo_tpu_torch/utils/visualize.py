"""Overlay rendering: ground-truth verification images and predictions
(the counterpart of ``dis_yolo_tpu/utils/visualize.py``, after the
reference's renderer, pre_process.py:234-310).

Class masks are alpha-blended onto the RGB image (crack yellow 0.2,
spall cyan 0.15, rebar magenta 0.2), each instance gets a red box with a
2-pixel stroke and an indexed class label.  Masks and boxes are drawn in
numpy: the box is PIL's ``rectangle(width=2)``, an inward stroke on
inclusive corners, clipped to the image (``draw_box``).  The labels need
PIL's text renderer (its default font is a FreeType face that numpy
cannot reproduce): with PIL the output equals the JAX package's byte for
byte; without it, as on the card's machine, the labels are left off.
Files are written as PNG (``data.image_io.write_png``), which needs
neither OpenCV nor PIL, where the JAX package writes with
``cv2.imwrite``.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dis_yolo_tpu_torch.data import rasterize
from dis_yolo_tpu_torch.data.image_io import read_image, write_png

CLASS_COLORS: Dict[str, Tuple[Tuple[int, int, int], float]] = {
    "crack": ((255, 255, 0), 0.2),    # yellow
    "spall": ((0, 255, 255), 0.15),   # cyan
    "rebar": ((255, 0, 255), 0.2),    # magenta
}
BOX_COLOR = (255, 0, 0)
LABEL_COLOR = (0, 0, 255)
BOX_WIDTH = 2


def have_labels() -> bool:
    """Whether labels can be drawn (PIL imports)."""
    try:
        from PIL import ImageDraw  # noqa: F401
    except ImportError:
        return False
    return True


def blend_mask(image: np.ndarray, mask: np.ndarray, classname: str) -> np.ndarray:
    """Alpha-blend one bool mask onto an RGB uint8 image (in place)."""
    color, alpha = CLASS_COLORS.get(classname, ((255, 0, 0), 0.2))
    sel = mask.astype(bool)
    for c in range(3):
        ch = image[:, :, c]
        ch[sel] = (ch[sel] * (1 - alpha) + alpha * color[c]).astype(np.uint8)
    return image


def draw_box(image: np.ndarray, box, color=BOX_COLOR) -> np.ndarray:
    """PIL's ``rectangle([x1, y1, x2, y2], outline=color, width=2)`` in
    numpy (in place), clipped to the image.  PIL draws, for i in 0, 1,
    the rows y1+i and y2-i from x1 to x2 inclusive, and the columns
    x1+i and x2-i as lines from y1+2 towards y2-1 that stop one pixel
    short of their end, in either direction (a box under 4 pixels tall
    thus gets column pixels just below its top rows)."""
    h, w = image.shape[:2]
    x1, y1, x2, y2 = (int(v) for v in box)

    def fill(xa, ya, xb, yb):
        xa, ya = max(xa, 0), max(ya, 0)
        xb, yb = min(xb, w - 1), min(yb, h - 1)
        if xa <= xb and ya <= yb:
            image[ya:yb + 1, xa:xb + 1] = color

    start, stop = y1 + BOX_WIDTH, y2 - BOX_WIDTH + 1
    rows = (start, stop - 1) if start <= stop else (stop + 1, start)
    for i in range(BOX_WIDTH):
        fill(x1, y1 + i, x2, y1 + i)
        fill(x1, y2 - i, x2, y2 - i)
        fill(x1 + i, rows[0], x1 + i, rows[1])
        fill(x2 - i, rows[0], x2 - i, rows[1])
    return image


def _label(j: int, inst: Dict) -> str:
    label = f"{j} {inst['classname']}"
    if "score" in inst:
        label += f" {inst['score']:.2f}"
    return label


def draw_instances(image_rgb: np.ndarray,
                   instances: Sequence[Dict]) -> np.ndarray:
    """Render instances = [{'classname', 'mask' bool[H,W], 'box' (x1,y1,
    x2,y2), optional 'score'}] onto a copy of the image; returns uint8
    RGB.  Where PIL imports, each label is drawn after its box, as the
    JAX renderer does."""
    labels = have_labels()
    out = image_rgb.astype(np.uint8).copy()
    for inst in instances:
        if inst.get("mask") is not None:
            blend_mask(out, inst["mask"], inst["classname"])
    for j, inst in enumerate(instances):
        if inst.get("box") is None:
            continue
        draw_box(out, inst["box"])
        if labels:
            from PIL import Image, ImageDraw
            x1, y1 = int(inst["box"][0]), int(inst["box"][1])
            img = Image.fromarray(out)
            ImageDraw.Draw(img).text((x1, max(y1 - 10, 0)), _label(j, inst),
                                     fill=LABEL_COLOR)
            out = np.array(img)
    return out


def render_groundtruth(dataset: str, phase: str, out_dir: Optional[str] = None,
                       limit: Optional[int] = None) -> List[str]:
    """Overlay the ground truth onto every image of a split (the
    reference's do_verification): ``<dataset>/<phase>/verify/<stem>.png``
    unless ``out_dir`` is given.  Images are read by
    ``data.image_io.read_image`` (P6 anywhere, other formats with
    OpenCV), polygons filled by ``data.rasterize``."""
    split = os.path.join(dataset, phase)
    out_dir = out_dir or os.path.join(split, "verify")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(split, "cache", "ground_truth_cache.pkl"), "rb") as f:
        annotations = pickle.load(f)

    written = []
    for a in annotations[:limit]:
        img = read_image(os.path.join(split, "images", a["filename"]))
        h, w = a["size"]
        instances = []
        for r in a["regions"].values():
            mask = rasterize.instance_mask(r["shape_attributes"], h, w)
            bb = rasterize.mask_to_box(mask)
            if bb is None:
                continue
            instances.append({"classname": r["region_attributes"],
                              "mask": mask,
                              "box": (bb[0], bb[1], bb[2], bb[3])})
        rendered = draw_instances(img, instances)
        path = os.path.join(out_dir,
                            os.path.splitext(a["filename"])[0] + ".png")
        write_png(path, rendered)
        written.append(path)
    return written
