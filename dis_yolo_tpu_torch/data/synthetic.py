"""Synthetic concrete-defect dataset generator (test fixture / demo data;
the counterpart of ``dis_yolo_tpu/data/synthetic.py``, byte-identical
output for a seed).  It draws and writes with OpenCV, imported when
``generate_dataset`` runs; without OpenCV it raises.

The reference ships only 4 sample images; real data is a private download.
This generator fabricates a self-contained dataset in the exact on-disk
layout the pipeline consumes — images/, masks/ (per-class binary JPEGs) —
so the *whole* stack (pre-processing -> cache -> loader -> train -> eval)
can run hermetically in tests and demos.

Defects drawn: 'crack' = random thin poly-line; 'spall' = blobby ellipse;
'rebar' = thick bar.  Masks are drawn white-on-black per class, matching
what pre_process expects to contour.

Round 3 adds **render families** (`RenderFamily`): parameterized texture
statistics, defect geometry ranges, contrast, and optional corruption
(noise/blur), so accuracy can be measured on a *held-out* family the model
never trained on — the strongest generalization evidence available without
the reference's private dataset (its published "up to 80%" is on a
held-out test split, README.md:23).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

@dataclasses.dataclass(frozen=True)
class RenderFamily:
    """Rendering-parameter family for held-out generalization splits.

    ``FAMILY_A`` reproduces the original generator exactly; ``FAMILY_B``
    shifts every knob (darker, noisier texture; thinner cracks; larger
    spalls; thicker rebar; weaker defect contrast); the ``*_CORRUPT``
    variant additionally applies sensor-style Gaussian noise + blur after
    rendering.
    """
    name: str = "A"
    texture_mean: float = 140.0
    texture_std: float = 25.0
    defect_darken: float = 0.4            # defect pixels *= this
    crack_thickness: Tuple[int, int] = (3, 6)     # randint lo, hi(excl)
    crack_segments: Tuple[int, int] = (4, 8)
    spall_axes_div: Tuple[int, int] = (10, 5)     # axes ~ U(dim/div0, dim/div1)
    rebar_thickness: Tuple[int, int] = (8, 14)
    noise_sigma: float = 0.0              # post-render additive Gaussian
    blur_ksize: int = 0                   # post-render box blur (odd, 0=off)


FAMILY_A = RenderFamily()
# a plausible domain shift (different concrete, camera, defect geometry):
# contrast-to-noise drops from A's ~3.4 to ~2.3 and every geometry range
# shifts — but defects stay human-visible.  (An earlier B at mean 118 /
# std 38 / darken 0.55 had CNR 1.4 — essentially invisible defects, which
# tests nothing but failure.)
FAMILY_B = RenderFamily(
    name="B", texture_mean=128.0, texture_std=30.0, defect_darken=0.46,
    crack_thickness=(2, 5), crack_segments=(5, 10), spall_axes_div=(8, 4),
    rebar_thickness=(10, 18))
FAMILY_B_CORRUPT = dataclasses.replace(
    FAMILY_B, name="Bc", noise_sigma=8.0, blur_ksize=3)


def _draw_crack(mask, rng, h, w, fam: RenderFamily):
    import cv2
    x, y = rng.randint(w // 4, 3 * w // 4), rng.randint(h // 8, h // 4)
    pts = [(x, y)]
    for _ in range(rng.randint(*fam.crack_segments)):
        x = np.clip(x + rng.randint(-w // 8, w // 8), 5, w - 5)
        y = np.clip(y + rng.randint(h // 12, h // 6), 5, h - 5)
        pts.append((x, y))
    for a, b in zip(pts[:-1], pts[1:]):
        cv2.line(mask, a, b, 255, thickness=rng.randint(*fam.crack_thickness))


def _draw_spall(mask, rng, h, w, fam: RenderFamily):
    import cv2
    d0, d1 = fam.spall_axes_div
    c = (rng.randint(w // 4, 3 * w // 4), rng.randint(h // 4, 3 * h // 4))
    axes = (rng.randint(w // d0, w // d1), rng.randint(h // d0, h // d1))
    cv2.ellipse(mask, c, axes, rng.randint(0, 180), 0, 360, 255, -1)


def _draw_rebar(mask, rng, h, w, fam: RenderFamily):
    import cv2
    x = rng.randint(w // 4, 3 * w // 4)
    y0 = rng.randint(h // 8, h // 4)
    y1 = rng.randint(3 * h // 4, 7 * h // 8)
    cv2.line(mask, (x, y0), (x, y1), 255,
             thickness=rng.randint(*fam.rebar_thickness))


def generate_dataset(root: str, phases=("train", "val", "test"),
                     images_per_phase: int = 8, image_size: int = 320,
                     seed: int = 0,
                     family: Optional[RenderFamily] = None) -> str:
    """Create a synthetic dataset under ``root``; returns ``root``.

    ``family`` selects the rendering parameters (default ``FAMILY_A``,
    byte-identical to the pre-family generator for the same seed).
    """
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV required for the synthetic generator") from e
    fam = family or FAMILY_A
    rng = np.random.RandomState(seed)
    drawers = {"crack": _draw_crack, "spall": _draw_spall, "rebar": _draw_rebar}

    for phase in phases:
        img_dir = os.path.join(root, phase, "images")
        mask_dir = os.path.join(root, phase, "masks")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)
        for i in range(images_per_phase):
            h = image_size + int(rng.randint(0, 3)) * 32   # vary aspect a bit
            w = image_size
            # concrete-ish texture
            img = (rng.normal(fam.texture_mean, fam.texture_std, (h, w, 3))
                   ).clip(0, 255).astype(np.uint8)
            stem = f"{phase}{i:04d}"
            class_masks = {}
            n_defects = rng.randint(1, 4)
            chosen = rng.choice(list(drawers), size=n_defects, replace=True)
            for cls in chosen:
                m = class_masks.setdefault(cls, np.zeros((h, w), np.uint8))
                drawers[cls](m, rng, h, w, fam)
            for cls, m in class_masks.items():
                img[m > 0] = (img[m > 0] * fam.defect_darken).astype(np.uint8)
                cv2.imwrite(os.path.join(mask_dir, f"{stem}{cls}.jpg"), m)
            if fam.noise_sigma > 0:
                img = (img.astype(np.float64)
                       + rng.normal(0, fam.noise_sigma, img.shape)
                       ).clip(0, 255).astype(np.uint8)
            if fam.blur_ksize > 1:
                img = cv2.blur(img, (fam.blur_ksize, fam.blur_ksize))
            cv2.imwrite(os.path.join(img_dir, f"{stem}.jpg"), img)
    return root
