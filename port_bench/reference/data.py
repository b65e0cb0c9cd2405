"""The training batch of DIS-YOLO in plain form: a corpus row resized and
placed on the network's canvas, its masks and label grids, then flips
and photometric augmentation from their draws.

Frozen copies of the port's device data path (``data/device_corpus.py``
``make_assemble_fn``, ``data/device_augment.py``, the ``prepare_batch``
of ``train/train_step.py``), written one image at a time, with the same
float32 operations in the same order, so that on the same inputs and
device they give the same bits.  Its inputs are the host corpus's arrays
(uint8 images, ``np.packbits`` masks, sizes), one step's placement
decisions and the augmentation generator's state.  Departures, all of
form:

  * each mask is resized and placed as a 0/1 image and rounded, where
    the port looks each pixel up in a 16-entry table of its four taps'
    bits over per-pixel words of all masks; the port documents the two
    as equal;
  * the label grids are written box by box in the loader's order, the
    first box to reach a cell keeping it, where the port scatters all
    boxes at once after a pairwise test;
  * each image's photometric transform is the one its draw chose, where
    the port computes all three and selects.

Like the port, the bilinear multiply-adds round once (``_fma``: the
float64 product of two float32 values is exact), and ``/ 255`` of a
Python scalar is what PyTorch makes of it on the device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

SALT_BELOW = 0.004 * 0.2
PEPPER_ABOVE = 1.0 - 0.004 * 0.8
N_BLUR_KERNELS = 12


# ------------------------------------------------------------ the draws
def draw_augment(generator: torch.Generator, b: int, size: int
                 ) -> Dict[str, torch.Tensor]:
    """One step's flip and photometric draws, in the port's order, from
    ``generator`` on its device."""
    dev = generator.device
    return {
        "flip": torch.randint(1, 4, (b,), generator=generator, device=dev),
        "bnl": torch.randint(1, 5, (b,), generator=generator, device=dev),
        "salt": torch.rand((b, size, size), generator=generator, device=dev),
        "coeff": torch.rand((b,), generator=generator, device=dev) + 0.5,
        "blur": torch.randint(0, N_BLUR_KERNELS, (b,), generator=generator,
                              device=dev)}


def draw_uniforms(generator: torch.Generator, b: int, n_prop: int,
                  n_gt: int):
    """The mask loss's ROI-pick uniforms of one step, on the generator's
    device."""
    dev = generator.device
    u_prop = torch.rand((b, n_prop), generator=generator, device=dev)
    u_gt = torch.rand((b, n_gt), generator=generator, device=dev)
    return u_prop, u_gt


# -------------------------------------------------------- resize, place
def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _taps(ih: int, iw: int, new_h: int, new_w: int, dy: int, dx: int,
          size: int, device):
    """Bilinear taps of a resize of an ``ih x iw`` image to ``new_h x
    new_w`` placed at (dx, dy) on a ``size``^2 canvas: OpenCV's pixel
    centres, edge-clamped."""
    ar = torch.arange(size, dtype=torch.float32, device=device)
    ry = ar - torch.tensor(float(dy), device=device)
    rx = ar - torch.tensor(float(dx), device=device)
    fh = torch.tensor(float(ih), device=device) / torch.tensor(
        float(new_h), device=device)
    fw = torch.tensor(float(iw), device=device) / torch.tensor(
        float(new_w), device=device)
    sy = _fma(ry + 0.5, fh, -0.5)
    sx = _fma(rx + 0.5, fw, -0.5)
    y0 = torch.clamp(torch.floor(sy), 0, ih - 1).long()
    x0 = torch.clamp(torch.floor(sx), 0, iw - 1).long()
    y1 = torch.clamp(y0 + 1, max=ih - 1)
    x1 = torch.clamp(x0 + 1, max=iw - 1)
    wy = torch.clamp(sy - y0, 0.0, 1.0)
    wx = torch.clamp(sx - x0, 0.0, 1.0)
    inside = (((ry >= 0) & (ry < new_h))[:, None]
              & ((rx >= 0) & (rx < new_w))[None, :])
    return y0, y1, wy, x0, x1, wx, inside


def _resize_place(src: torch.Tensor, taps, pad: float) -> torch.Tensor:
    """src [H, W, C] -> [size, size, C] float32."""
    y0, y1, wy, x0, x1, wx, inside = taps
    rows = _fma(src[y0].float(), 1.0 - wy[:, None, None],
                src[y1].float() * wy[:, None, None])
    out = _fma(rows[:, x0], 1.0 - wx[None, :, None],
               rows[:, x1] * wx[None, :, None])
    return torch.where(inside[..., None], out, pad)


def _unpack(packed: np.ndarray, n: int, hm: int, wm: int) -> np.ndarray:
    """The first ``n`` of one row's packed masks -> [hm, wm, n] uint8."""
    bits = np.unpackbits(packed[:n], axis=1)[:, :hm * wm]
    return bits.reshape(n, hm, wm).transpose(1, 2, 0)


def _grids(tb_px: np.ndarray, tb_val: np.ndarray, n: int, anchors: np.ndarray,
           g: int, a: int, c: int, net: int, device):
    """The three label grids [m, m, a, 5 + c] (stride 8 first) of one
    image: each of its ``n`` boxes at the cell of its centre on the scale
    and anchor of its best anchor by width-height IoU; the first box to
    reach a cell keeps it; a box whose best IoU is 0 is dropped."""
    px = torch.as_tensor(tb_px, device=device)
    anc = torch.as_tensor(anchors, device=device)
    wh = px[:, 2:4]
    inter = (torch.minimum(wh[:, None, 0], anc[:, 0])
             * torch.minimum(wh[:, None, 1], anc[:, 1]))
    union = wh[:, 0:1] * wh[:, 1:2] + anc[:, 0] * anc[:, 1] - inter
    iou = inter / union
    best = torch.argmax(iou, -1).tolist()
    best_iou = iou.max(-1).values.tolist()
    net_t = torch.tensor(float(net), device=device)
    sides = (4 * g, 2 * g, g)
    grids = [torch.zeros((m, m, a, 5 + c), device=device) for m in sides]
    taken = set()
    for i in range(n):
        if not best_iou[i] > 0:
            continue
        scale, anchor = best[i] // a, best[i] % a
        m = torch.tensor(float(sides[scale]), device=device)
        x = int((px[i, 0] * m / net_t).item())
        y = int((px[i, 1] * m / net_t).item())
        if (scale, y, x, anchor) in taken:
            continue
        taken.add((scale, y, x, anchor))
        row = torch.zeros(5 + c, device=device)
        row[:4] = torch.as_tensor(tb_val[i, :4], device=device)
        row[4] = 1.0
        row[5 + int(tb_px[i, 4])] = 1.0
        grids[scale][y, x, anchor] = row
    return grids


def assemble(corpus: Dict[str, np.ndarray], dec: Dict[str, np.ndarray],
             cfg: dict, device) -> Dict[str, torch.Tensor]:
    """One step's batch from the host corpus (``images`` [N, Hm, Wm, 3]
    uint8, ``masks_packed`` [N, T, bytes], ``sizes`` [N, 2]) and its
    decisions (``idx`` [B], ``place`` [B, 4] = new_h, new_w, dy, dx,
    ``true_box_px`` / ``true_box`` [B, T, 5], ``nvalid`` [B]): images
    uint8 [B, S, S, 3], true_masks bool [B, T, S, S], true_boxes
    [B, T, 5], the grids ``labels_s8`` / ``s16`` / ``s32``."""
    size, t = cfg["image_size"], cfg["max_box_per_image"]
    hm, wm = corpus["images"].shape[1:3]
    images, masks = [], []
    grids = ([], [], [])
    for b, row in enumerate(dec["idx"].tolist()):
        ih, iw = (int(v) for v in corpus["sizes"][row])
        new_h, new_w, dy, dx = (int(v) for v in dec["place"][b])
        taps = _taps(ih, iw, new_h, new_w, dy, dx, size, device)
        src = torch.as_tensor(corpus["images"][row], device=device)
        canvas = _resize_place(src, taps, 127.0)
        images.append(torch.clamp(torch.round(canvas), 0, 255)
                      .to(torch.uint8))
        bits = torch.as_tensor(_unpack(corpus["masks_packed"][row], t, hm,
                                       wm), device=device)
        placed = _resize_place(bits, taps, 0.0)
        masks.append((torch.round(placed) != 0).permute(2, 0, 1))
        n = int(dec["nvalid"][b])
        for out, grid in zip(grids, _grids(
                dec["true_box_px"][b], dec["true_box"][b], n,
                np.asarray(cfg["anchors"], np.float32), cfg["base_grid"],
                cfg["anchors_per_scale"], len(cfg["classes"]), size,
                device)):
            out.append(grid)
    return {"images": torch.stack(images), "true_masks": torch.stack(masks),
            "true_boxes": torch.as_tensor(dec["true_box"], device=device),
            "labels_s8": torch.stack(grids[0]),
            "labels_s16": torch.stack(grids[1]),
            "labels_s32": torch.stack(grids[2])}


# ---------------------------------------------------------------- flips
def _flip(batch: Dict[str, torch.Tensor], b: int, how: int, net: float):
    """Mirror image ``b`` of the batch in place: ``how`` 2 left-right, 3
    top-bottom; box and grid centres move to ``(net-1)/net - x``."""
    if how == 1:
        return
    coord = 0 if how == 2 else 1
    img_dim, mask_dim, grid_dim = (1, 2, 1) if how == 2 else (0, 1, 0)
    batch["images"][b] = torch.flip(batch["images"][b], (img_dim,))
    batch["true_masks"][b] = torch.flip(batch["true_masks"][b], (mask_dim,))
    tb = batch["true_boxes"][b]
    real = (tb[:, :4] != 0).any(-1)
    tb[:, coord] = torch.where(real, (net - 1.0) / net - tb[:, coord],
                               tb[:, coord])
    for key in ("labels_s8", "labels_s16", "labels_s32"):
        grid = torch.flip(batch[key][b], (grid_dim,))
        obj = grid[..., 4] == 1
        grid[..., coord] = torch.where(obj, (net - 1.0) / net
                                       - grid[..., coord], grid[..., coord])
        batch[key][b] = grid


# ---------------------------------------------------------- photometric
def _salt_pepper(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    hit = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    hit[-1, :] = False
    hit[:, -1] = False
    salt = ((u < SALT_BELOW) & hit)[..., None]
    pepper = ((u > PEPPER_ABOVE) & hit)[..., None]
    return torch.where(salt, 1.0 / 255.0, torch.where(pepper, 0.0, x))


def _rgb2hls(img255: torch.Tensor):
    """OpenCV's 8-bit RGB2HLS in float32: H, L, S as uint8 values."""
    x = img255.float() * (1.0 / 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    light = (vmax + vmin) * 0.5
    diff = vmax - vmin
    sat = torch.where(light < 0.5,
                      diff / torch.clamp_min(vmax + vmin, 1e-20),
                      diff / torch.clamp_min(2.0 - (vmax + vmin), 1e-20))
    sat = torch.where(diff == 0, 0.0, sat)
    dinv = torch.full_like(diff, 60.0) / torch.clamp_min(diff, 1e-20)
    num = torch.where(vmax == r, g - b, torch.where(vmax == g, b - r, r - g))
    part = torch.where(vmax == r, 0.0, torch.where(vmax == g, 120.0, 240.0))
    hue = _fma(num, dinv, part)
    hue = torch.where(diff == 0, 0.0, hue)
    hue = torch.where(hue < 0, hue + 360.0, hue)
    return (torch.round(hue * 0.5), torch.round(light * 255.0),
            torch.round(sat * 255.0))


def _hls2rgb(h8: torch.Tensor, l8: torch.Tensor, s8: torch.Tensor):
    """OpenCV's 8-bit HLS2RGB: RGB [..., 3] as uint8 values."""
    h = h8.float() * 2.0
    light = l8.float() * (1.0 / 255.0)
    sat = s8.float() * (1.0 / 255.0)
    q = torch.where(light < 0.5, light * (1 + sat),
                    light + sat - light * sat)
    p = 2.0 * light - q

    def chan(hh):
        hh = torch.remainder(hh, 360.0) * (1.0 / 360.0)
        return torch.where(hh < 1 / 6, p + (q - p) * 6 * hh,
                           torch.where(hh < 1 / 2, q,
                                       torch.where(hh < 2 / 3,
                                                   p + (q - p) * (2 / 3 - hh) * 6,
                                                   p)))

    rgb = torch.stack([chan(h + 120), chan(h), chan(h - 120)], -1)
    return torch.clamp(torch.round(rgb * 255.0), 0.0, 255.0)


def _lightness(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    h8, l8, s8 = _rgb2hls(torch.round(x * 255.0))
    l2 = torch.floor(torch.clamp_max(l8 * coeff, 255.0))
    return _hls2rgb(h8, l2, s8) * (1.0 / 255.0)


def motion_kernel(angle_deg: float, line_type: str) -> np.ndarray:
    """The length-3 line kernel at ``angle_deg`` (OpenCV's motion blur
    of the DIS-YOLO loader): 'full' the whole line, 'right' / 'left' its
    half from the centre, normalized to sum 1."""
    k = np.zeros((3, 3), np.float64)
    rad = math.radians(angle_deg)
    span = {"full": (-1, 0, 1), "right": (0, 1), "left": (-1, 0)}[line_type]
    for t in span:
        x = int(round(1 + t * math.cos(rad)))
        y = int(round(1 - t * math.sin(rad)))
        if 0 <= x < 3 and 0 <= y < 3:
            k[y, x] = 1.0
    return (k / max(k.sum(), 1.0)).astype(np.float32)


def _blur(x: torch.Tensor, kidx: int) -> torch.Tensor:
    """Correlation with kernel ``kidx`` (angle index * 3 + line type of
    right, left, full over 0, 45, 90, 135 degrees), reflect-101 border,
    rounded to uint8 values."""
    kern = torch.as_tensor(motion_kernel(45.0 * (kidx // 3),
                                         ("right", "left", "full")[kidx % 3]),
                           device=x.device)
    xp = F.pad((x * 255.0).permute(2, 0, 1)[None], (1, 1, 1, 1),
               mode="reflect")[0].permute(1, 2, 0)
    hgt, wid = x.shape[0], x.shape[1]
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + kern[dy, dx] * xp[dy:dy + hgt, dx:dx + wid, :]
    return torch.round(acc) * (1.0 / 255.0)


def augment(batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
            size: int) -> Dict[str, torch.Tensor]:
    """The float images (uint8 / 255) of the batch, flipped with their
    masks, boxes and grids, then each image's photometric transform: 1
    none, 2 salt and pepper, 3 lightness, 4 motion blur."""
    out = {k: v.clone() for k, v in batch.items()}
    out["images"] = out["images"].float() / 255.0
    for b, how in enumerate(draws["flip"].tolist()):
        _flip(out, b, how, float(size))
    for b, how in enumerate(draws["bnl"].tolist()):
        x = out["images"][b]
        if how == 2:
            x = _salt_pepper(x, draws["salt"][b])
        elif how == 3:
            x = _lightness(x, draws["coeff"][b])
        elif how == 4:
            x = _blur(x, int(draws["blur"][b]))
        out["images"][b] = x
    return out
