"""Polygon -> instance-mask rasterization (host numpy; the counterpart of
``dis_yolo_tpu/data/rasterize.py``).

Ground-truth semantics of the reference loaders: an instance is a list
of polygons of ``type`` 'out' (filled True) or 'in' (interior hole
filled False), applied in order, and every polygon's vertex pixels are
always set True, so a hole's rim stays part of the mask.

One fill engine: the numpy even-odd scanline over pixel centers (the
JAX package's ``engine="numpy"`` and its parity oracle).  Its native C++
engine comes with the port of ``native/datapath.cc``; cv2 is not used
(the card's machine has no OpenCV).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def fill_polygon_scanline(xs: np.ndarray, ys: np.ndarray, h: int,
                          w: int) -> np.ndarray:
    """Even-odd scanline fill over pixel centers (y, x integer grid):
    pixel (r, c) is inside iff a ray from it crosses the outline an odd
    number of times; the outline itself is drawn in (boundary
    inclusive)."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    mask = np.zeros((h, w), dtype=bool)
    if len(xs) < 3:
        return mask
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), h - 1)
    x_next = np.roll(xs, -1)
    y_next = np.roll(ys, -1)
    for r in range(y0, y1 + 1):
        # edges straddling this scanline (half-open: no double counts)
        c1 = (ys <= r) & (y_next > r)
        c2 = (y_next <= r) & (ys > r)
        sel = c1 | c2
        if not sel.any():
            continue
        t = (r - ys[sel]) / (y_next[sel] - ys[sel])
        xcross = np.sort(xs[sel] + t * (x_next[sel] - xs[sel]))
        for i in range(0, len(xcross) - 1, 2):
            a = max(int(np.ceil(xcross[i])), 0)
            b = min(int(np.floor(xcross[i + 1])), w - 1)
            if b >= a:
                mask[r, a:b + 1] = True
    _draw_edges(mask, xs, ys)
    return mask


def _draw_edges(mask: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> None:
    """Set every pixel along the polygon outline True."""
    h, w = mask.shape
    x2 = np.roll(xs, -1)
    y2 = np.roll(ys, -1)
    for i in range(len(xs)):
        n = int(max(abs(x2[i] - xs[i]), abs(y2[i] - ys[i]))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        px = np.clip(np.round(xs[i] + t * (x2[i] - xs[i])).astype(int), 0,
                     w - 1)
        py = np.clip(np.round(ys[i] + t * (y2[i] - ys[i])).astype(int), 0,
                     h - 1)
        mask[py, px] = True


def _set_boundary(mask: np.ndarray, xs, ys) -> None:
    xs = np.clip(np.asarray(xs, np.int64), 0, mask.shape[1] - 1)
    ys = np.clip(np.asarray(ys, np.int64), 0, mask.shape[0] - 1)
    mask[ys, xs] = True


def instance_mask(polygons: List[Dict], h: int, w: int) -> np.ndarray:
    """One instance (a list of {'type', 'all_points_x', 'all_points_y'})
    -> bool mask [h, w]."""
    m = np.zeros((h, w), dtype=bool)
    for poly in polygons:
        xs, ys = poly["all_points_x"], poly["all_points_y"]
        filled = fill_polygon_scanline(np.asarray(xs), np.asarray(ys), h, w)
        if poly["type"] == "out":
            m |= filled
        else:                       # 'in': interior hole, rim stays on
            m &= ~filled
        _set_boundary(m, xs, ys)
    return m


def instance_masks(all_polygons: List[List[Dict]], h: int, w: int,
                   max_instances: int) -> np.ndarray:
    """Padded stack [max_instances, h, w] of instance masks."""
    out = np.zeros((max_instances, h, w), dtype=bool)
    for i, polys in enumerate(all_polygons[:max_instances]):
        out[i] = instance_mask(polys, h, w)
    return out


def mask_to_box(mask: np.ndarray):
    """Tight (x1, y1, x2, y2) with exclusive max edges; None for an empty
    mask."""
    cols = np.flatnonzero(mask.any(axis=0))
    rows = np.flatnonzero(mask.any(axis=1))
    if len(cols) == 0 or len(rows) == 0:
        return None
    return int(cols[0]), int(rows[0]), int(cols[-1]) + 1, int(rows[-1]) + 1
