"""Seeded inspection photos for the serving traffic, made on the device.

A photo is concrete-like texture (normal noise around grey 140, spread
25, per pixel and channel) with 1 to 4 polygon defects darkened to 0.4
of their brightness, stored as uint8: the split that the port's card
check writes for its training driver, with the polygons filled by an
even-odd test here instead of the port's rasterizer.  Photos are
letterboxed to the network's square input as the port's
``data/val_data.letterbox_image`` does (integer-floor resize
dimensions, centred on grey 127, divided by 255), with a half-pixel
bilinear resize.

Everything is drawn from the seed: the polygons on the host with
``numpy.random.default_rng``, the texture on the device with a
``torch.Generator`` in one call per photo size.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _polygons(rng: np.random.Generator, h: int, w: int, max_defects: int
              ) -> List[np.ndarray]:
    """1 to ``max_defects`` star-shaped polygons [(x, y), ...] inside the
    photo, each of 4 to 11 vertices around a centre."""
    out = []
    for _ in range(int(rng.integers(1, max_defects + 1))):
        cx = rng.integers(w // 8, 7 * w // 8)
        cy = rng.integers(h // 8, 7 * h // 8)
        rad = rng.integers(min(h, w) // 20, min(h, w) // 5)
        ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(4, 12))))
        rr = rad * rng.uniform(0.5, 1.0, ang.size)
        xs = np.clip(cx + rr * np.cos(ang), 0, w - 1).astype(np.int64)
        ys = np.clip(cy + rr * np.sin(ang), 0, h - 1).astype(np.int64)
        out.append(np.stack([xs, ys], 1))
    return out


def _fill(poly: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """Bool [h, w]: pixel centres inside the polygon (even-odd rule)."""
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None] + 0.5
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :] + 0.5
    inside = torch.zeros((h, w), dtype=torch.bool, device=device)
    pts = poly.astype(np.float64)
    for (x0, y0), (x1, y1) in zip(pts, np.roll(pts, -1, 0)):
        if y0 == y1:
            continue
        crosses = (ys >= min(y0, y1)) & (ys < max(y0, y1))
        x_at = x0 + (ys - y0) * ((x1 - x0) / (y1 - y0))
        inside ^= crosses & (xs < x_at)
    return inside


def letterbox(photos: torch.Tensor, size: int
              ) -> Tuple[torch.Tensor, np.ndarray]:
    """uint8 photos [N, H, W, 3] of one size -> (float32 [N, size, size,
    3] in [0, 1], window [4] float32 (y1, x1, y2, x2) of the photo)."""
    ih, iw = photos.shape[1:3]
    if size / iw < size / ih:
        new_h, new_w = (ih * size) // iw, size
    else:
        new_h, new_w = size, (iw * size) // ih
    x = photos.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=False)
    top, left = (size - new_h) // 2, (size - new_w) // 2
    canvas = torch.full((photos.shape[0], 3, size, size), 127.0,
                        device=photos.device)
    canvas[:, :, top:top + new_h, left:left + new_w] = x
    window = np.asarray([top / size, left / size, (new_h + top) / size,
                         (new_w + left) / size], np.float32)
    return (canvas / 255.0).permute(0, 2, 3, 1).contiguous(), window


def make_photos(seed: int, sizes: Sequence[Sequence[int]], per_size: int,
                max_defects: int, device) -> Dict[Tuple[int, int], dict]:
    """{(h, w): {"photos": uint8 [per_size, h, w, 3] on ``device``,
    "polygons": per photo a list of (class, polygon)}} for each size."""
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    out = {}
    for h, w in sizes:
        tex = torch.randn((per_size, h, w, 3), generator=gen, device=device)
        tex = tex * 25.0 + 140.0
        polys = []
        for i in range(per_size):
            shapes = _polygons(rng, h, w, max_defects)
            dark = torch.zeros((h, w), dtype=torch.bool, device=device)
            for p in shapes:
                dark |= _fill(p, h, w, device)
            tex[i][dark] *= 0.4
            polys.append([(int(rng.integers(3)), p) for p in shapes])
        out[(h, w)] = {"photos": tex.round_().clamp_(0, 255).to(torch.uint8),
                       "polygons": polys}
    return out
