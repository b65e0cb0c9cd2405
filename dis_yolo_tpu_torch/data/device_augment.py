"""Flips and photometric augmentation inside the train step, on the
device (the counterpart of ``dis_yolo_tpu/data/device_augment.py``).

With ``cfg.device_side_augs`` the host loader only places and rasterizes
(``DefectTrainData(host_augs=False)``) and these batched transforms run
on the expanded 7-field batch (``train_step.prepare_batch``'s output):

  * flip per image: 1 none, 2 horizontal, 3 vertical; images and masks
    mirrored, true-box centers ``x -> (net-1)/net - x`` on nonzero rows,
    label grids mirrored with the same fix-up at object cells;
  * photometric per image: 1 none, 2 salt and pepper (salt writes 1/255,
    the last row and column are never hit), 3 lightness (the uint8 HLS
    round trip, L scaled and truncated), 4 motion blur (one of the 12
    length-3 line kernels, reflect-101 border, uint8 rounding).

The draws and the transforms are split: JAX's threefry stream has no
torch counterpart, so ``draw_augment`` draws from a ``torch.Generator``
(on the model's device: the salt-and-pepper field is B x S x S floats,
which a host draw would put back on the wire) and ``augment_batch``
applies given draws, so a test can hand it the draws JAX made.  Every
per-image choice is computed for the whole batch and selected with
``torch.where`` on the draws: no host decision, no sync.

Constants and the order of operations are those of JAX's jitted step,
in float32: the hue's multiply-add rounds once and ``/ 255`` is a
multiply by the float32 reciprocal, as XLA's fusion computes them (and
as PyTorch's CUDA division by a Python scalar does).  ``v / x`` is a
true division (PyTorch's ``v / x`` would multiply by ``1 / x``).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from dis_yolo_tpu_torch.data.augment import _motion_kernel

SALT_BELOW = 0.004 * 0.2          # amount .004, salt fraction .2
PEPPER_ABOVE = 1.0 - 0.004 * 0.8
N_BLUR_KERNELS = 12


def draw_augment(generator: torch.Generator, b: int, size: int,
                 flips: bool = True, photometric: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """The draws of one batch, on ``generator``'s device: ``flip`` [B]
    in {1,2,3}; ``bnl`` [B] in {1..4}, ``salt`` [B,S,S] uniforms in
    [0, 1), ``coeff`` [B] in [0.5, 1.5] and ``blur`` [B] kernel indices
    in 0..11 (angle index * 3 + line type: right, left, full)."""
    dev = generator.device
    draws = {}
    if flips:
        draws["flip"] = torch.randint(1, 4, (b,), generator=generator,
                                      device=dev)
    if photometric:
        draws["bnl"] = torch.randint(1, 5, (b,), generator=generator,
                                     device=dev)
        draws["salt"] = torch.rand((b, size, size), generator=generator,
                                   device=dev)
        draws["coeff"] = torch.rand((b,), generator=generator,
                                    device=dev) + 0.5
        draws["blur"] = torch.randint(0, N_BLUR_KERNELS, (b,),
                                      generator=generator, device=dev)
    return draws


# ------------------------------------------------------------------ flips

def _flip_boxes(tb: torch.Tensor, coord: int, net: float) -> torch.Tensor:
    """true boxes [...,T,5]: mirror one center coordinate of nonzero rows."""
    valid = (tb[..., :4] != 0).any(-1)
    out = tb.clone()
    out[..., coord] = torch.where(valid, (net - 1.0) / net - tb[..., coord],
                                  tb[..., coord])
    return out


def _flip_grid(grid: torch.Tensor, dim: int, coord: int,
               net: float) -> torch.Tensor:
    """Label grids [B,H,W,A,5+C]: mirror along ``dim`` (1 rows, 2
    columns) and fix the center coordinate ``coord`` at object cells."""
    grid = torch.flip(grid, (dim,))
    obj = grid[..., 4] == 1
    grid[..., coord] = torch.where(obj, (net - 1.0) / net - grid[..., coord],
                                   grid[..., coord])
    return grid


def _select(choice: torch.Tensor, options: Dict[int, torch.Tensor],
            default: torch.Tensor) -> torch.Tensor:
    """Per image (dim 0): ``options[v]`` where ``choice == v``, else
    ``default``."""
    out = default
    for value, opt in options.items():
        pick = (choice == value).reshape((-1,) + (1,) * (default.dim() - 1))
        out = torch.where(pick, opt, out)
    return out


def _apply_flips(batch: Dict[str, torch.Tensor], flip: torch.Tensor,
                 net: float) -> Dict[str, torch.Tensor]:
    out = dict(batch)
    img, masks = batch["images"], batch["true_masks"]
    out["images"] = _select(flip, {2: torch.flip(img, (2,)),
                                   3: torch.flip(img, (1,))}, img)
    out["true_masks"] = _select(flip, {2: torch.flip(masks, (3,)),
                                       3: torch.flip(masks, (2,))}, masks)
    tb = batch["true_boxes"][:, 0, 0, 0]
    out["true_boxes"] = _select(flip, {2: _flip_boxes(tb, 0, net),
                                       3: _flip_boxes(tb, 1, net)},
                                tb)[:, None, None, None]
    for key in ("labels_s8", "labels_s16", "labels_s32"):
        g = batch[key]
        out[key] = _select(flip, {2: _flip_grid(g, 2, 0, net),
                                  3: _flip_grid(g, 1, 1, net)}, g)
    return out


# ------------------------------------------------------------ photometric

def _rgb2hls_u8(img255: torch.Tensor):
    """uint8-valued RGB [...,3] floats -> (H, L, S) uint8-valued floats
    (OpenCV's RGB2HLS on 8-bit input, emulated in float32: H, L and S
    equal OpenCV's and the jitted JAX function's)."""
    x = img255.float() * (1.0 / 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    l = (vmax + vmin) * 0.5
    diff = vmax - vmin
    s = torch.where(l < 0.5,
                    diff / torch.clamp_min(vmax + vmin, 1e-20),
                    diff / torch.clamp_min(2.0 - (vmax + vmin), 1e-20))
    s = torch.where(diff == 0, 0.0, s)
    dinv = torch.full_like(diff, 60.0) / torch.clamp_min(diff, 1e-20)
    # num * dinv + part as one fused multiply-add, as OpenCV's SIMD path
    # and XLA's fusion of JAX's jnp form take it: the float64 product of
    # two float32 values is exact, so the sum rounds once
    num = torch.where(vmax == r, g - b, torch.where(vmax == g, b - r, r - g))
    part = torch.where(vmax == r, 0.0, torch.where(vmax == g, 120.0, 240.0))
    h = (num.double() * dinv.double() + part.double()).float()
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h)
    return (torch.round(h * 0.5), torch.round(l * 255.0),
            torch.round(s * 255.0))


def _hls2rgb_u8(h8: torch.Tensor, l8: torch.Tensor, s8: torch.Tensor):
    """uint8-valued (H, L, S) -> uint8-valued RGB [...,3] floats
    (OpenCV's HLS2RGB on 8-bit input)."""
    h = h8.float() * 2.0
    l = l8.float() * (1.0 / 255.0)
    s = s8.float() * (1.0 / 255.0)
    q = torch.where(l < 0.5, l * (1 + s), l + s - l * s)
    p = 2.0 * l - q

    def chan(hh):
        hh = torch.remainder(hh, 360.0) * (1.0 / 360.0)
        return torch.where(hh < 1 / 6, p + (q - p) * 6 * hh,
                           torch.where(hh < 1 / 2, q,
                                       torch.where(hh < 2 / 3,
                                                   p + (q - p) * (2 / 3 - hh) * 6,
                                                   p)))

    rgb = torch.stack([chan(h + 120), chan(h), chan(h - 120)], -1)
    return torch.clamp(torch.round(rgb * 255.0), 0.0, 255.0)


@functools.lru_cache(maxsize=None)
def _motion_kernels_on(device: torch.device) -> torch.Tensor:
    """The table on ``device``, copied there once (a copy from host
    memory in the step would wait for the device)."""
    return torch.as_tensor(_motion_kernel_table(), device=device)


@functools.lru_cache(maxsize=1)
def _motion_kernel_table() -> np.ndarray:
    """The 12 length-3 motion kernels [12,3,3] float32: 4 angles
    {0, 45, 90, 135} x line types {right, left, full}, index = angle * 3
    + type."""
    angles = np.linspace(0, 180, 4, endpoint=False)
    return np.stack([_motion_kernel(3, float(a), t) for a in angles
                     for t in ("right", "left", "full")]).astype(np.float32)


def _salt_pepper(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    hitable = torch.ones(u.shape[-2:], dtype=torch.bool, device=u.device)
    hitable[-1, :] = False
    hitable[:, -1] = False
    salt = ((u < SALT_BELOW) & hitable)[..., None]
    pepper = ((u > PEPPER_ABOVE) & hitable)[..., None]
    return torch.where(salt, 1.0 / 255.0, torch.where(pepper, 0.0, x))


def _lightness(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """change_light: uint8 HLS round trip, L * coeff clamped at 255 and
    truncated."""
    h8, l8, s8 = _rgb2hls_u8(torch.round(x * 255.0))
    l2 = torch.floor(torch.clamp_max(l8 * coeff[:, None, None], 255.0))
    return _hls2rgb_u8(h8, l2, s8) * (1.0 / 255.0)


def _blur(x: torch.Tensor, kidx: torch.Tensor) -> torch.Tensor:
    """Correlation with each image's 3x3 kernel, reflect-101 border,
    rounded to uint8 values."""
    kern = _motion_kernels_on(x.device)[kidx]                # [B,3,3]
    xp = F.pad((x * 255.0).permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="reflect").permute(0, 2, 3, 1)
    hgt, wid = x.shape[1], x.shape[2]
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + kern[:, dy, dx, None, None, None] \
                * xp[:, dy:dy + hgt, dx:dx + wid, :]
    return torch.round(acc) * (1.0 / 255.0)


def _apply_photometric(images: torch.Tensor,
                       draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _select(draws["bnl"], {2: _salt_pepper(images, draws["salt"]),
                                  3: _lightness(images, draws["coeff"]),
                                  4: _blur(images, draws["blur"])}, images)


def augment_batch(batch: Dict[str, torch.Tensor],
                  draws: Dict[str, torch.Tensor], image_size: int,
                  flips: bool = True, photometric: bool = True
                  ) -> Dict[str, torch.Tensor]:
    """Flips, then photometric, on the expanded 7-field batch (float
    images in [0, 1], bool ``true_masks``) with ``draw_augment``'s
    draws, on their device."""
    out = dict(batch)
    if flips:
        out = _apply_flips(out, draws["flip"], float(image_size))
    if photometric:
        out["images"] = _apply_photometric(out["images"], draws)
    return out
