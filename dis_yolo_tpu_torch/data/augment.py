"""Host image resampling and the training loader's augmentation
primitives (the counterpart of ``dis_yolo_tpu/data/augment.py``).

Everything here is numpy: the card's machine has no OpenCV (and no PIL).
Where the JAX package calls OpenCV, this module computes what OpenCV
computes, in numpy, so the loader gives the same pixels with or without
it:

  * ``resize_bilinear`` on a uint8 image is ``cv2.resize(INTER_LINEAR)``'s
    8-bit fixed-point path: 11-bit coefficients ``rint(alpha * 2048)``
    from float32 fractions, the horizontal sums shifted right by 4, the
    vertical pass ``((r0*b0) >> 16) + ((r1*b1) >> 16) + 2 >> 2``; an
    exact 2x downscale is OpenCV's 2x2 area average (it switches to
    INTER_AREA there).  On a float image it is the formula the JAX
    package uses without OpenCV: the half-pixel mapping src = (dst +
    0.5) * src_size / dst_size - 0.5 with edge clamping, in float64.
    The output keeps the input's rank, as ``cv2.resize`` does for one- and
    three-channel images (the JAX package's formula ends in ``squeeze()``,
    which also drops a length-1 height or width).
  * ``change_light`` is the exact uint8 HLS round trip of
    ``cv2.cvtColor`` (the float32 recipe of the JAX package's
    ``device_augment._rgb2hls_u8`` / ``_hls2rgb_u8``), with the hue's
    last step fused as OpenCV's SIMD path fuses it, so H, L and S are
    OpenCV's bit for bit on the pixels that path converts (a row's
    last few pixels may take OpenCV's scalar path, whose hue can differ
    by 1 on an exact .5 tie).
  * ``linear_motion_blur`` is ``cv2.filter2D``: the kernel in float32,
    a reflect-101 border, the sum rounded half to even into uint8.

The scale/crop placement and its letterbox padding, salt-and-pepper noise
(with the reference's quirk that salt writes 1, not 255) and the
dispatch by the code's order (2 -> salt & pepper, 3 -> light, 4 -> blur)
follow the JAX package; every random draw comes in the JAX package's
order, so a ``RandomState`` ends in the same state.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_F32 = np.float32
_COEF_SCALE = 2048          # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _resize_float(img: np.ndarray, w: int, h: int) -> np.ndarray:
    src_h, src_w = img.shape[:2]
    ys = (np.arange(h) + 0.5) * src_h / h - 0.5
    xs = (np.arange(w) + 0.5) * src_w / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, src_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, src_w - 1)
    y1 = np.clip(y0 + 1, 0, src_h - 1)
    x1 = np.clip(x0 + 1, 0, src_w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    top, bottom = img[y0], img[y1]
    return ((top[:, x0] * (1 - wy)[..., None]
             + bottom[:, x0] * wy[..., None]) * (1 - wx)[..., None]
            + (top[:, x1] * (1 - wy)[..., None]
               + bottom[:, x1] * wy[..., None]) * wx[..., None])


def _taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's source index and float32 fraction of each output pixel."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(_F32)).astype(_F32)


def _fixed_coeffs(frac: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``saturate_cast<short>(alpha * 2048)`` of (1 - f, f), as int32."""
    a0 = np.rint((_F32(1) - frac) * _F32(_COEF_SCALE)).astype(np.int32)
    a1 = np.rint(frac * _F32(_COEF_SCALE)).astype(np.int32)
    return a0, a1


def _resize_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    # int32 is wide enough: a row sum is at most 255 * 2048, a product of
    # the vertical pass at most 32767 * 2048
    src_h, src_w = img.shape[:2]
    if src_w == 2 * w and src_h == 2 * h:
        # OpenCV turns an exact 2x INTER_LINEAR downscale into INTER_AREA
        src = img.astype(np.int32)
        quad = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
                + src[1::2, 1::2])
        return ((quad + 2) >> 2).astype(np.uint8)
    sy, fy = _taps(src_h, h)
    y0 = np.clip(sy, 0, src_h - 1)
    y1 = np.clip(sy + 1, 0, src_h - 1)
    # the horizontal pass runs on the source rows the output uses only
    used, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    c = img.shape[2]
    src = img[used].reshape(len(used), src_w * c).astype(np.int32)
    sx, fx = _taps(src_w, w)
    edge = (sx < 0) | (sx >= src_w - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, src_w - 1)
    ax0, ax1 = (np.repeat(a, c) for a in _fixed_coeffs(fx))
    chan = np.arange(c)
    i0 = (sx[:, None] * c + chan).ravel()
    i1 = (np.minimum(sx + 1, src_w - 1)[:, None] * c + chan).ravel()
    rows = (src[:, i0] * ax0 + src[:, i1] * ax1) >> 4      # [rows, w*c]
    np.clip(rows, -32768, 32767, out=rows)
    by0, by1 = _fixed_coeffs(fy)
    v = ((rows[inv[:h]] * by0[:, None]) >> 16) \
        + ((rows[inv[h:]] * by1[:, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8).reshape(h, w, c)


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize of [H, W] or [H, W, C] to (w, h), align-corners
    False: OpenCV's 8-bit fixed-point path for uint8 input, the float64
    formula for anything else (module doc)."""
    flat = img.ndim == 2
    if flat:
        img = img[:, :, None]
    out = _resize_u8(img, w, h) if img.dtype == np.uint8 else \
        _resize_float(img, w, h)
    return out[:, :, 0] if flat else out


def place_and_pad(image: np.ndarray, new_w: int, new_h: int, dx: int, dy: int,
                  net_w: int, net_h: int, pad_value: float) -> np.ndarray:
    """Resize to (new_w, new_h), then place at (dx, dy) in a canvas of
    ``pad_value``: negative offsets crop, positive ones pad; the result is
    [net_h, net_w, C] in the input's dtype."""
    im = resize_bilinear(image, new_w, new_h)
    if im.ndim == 2:
        im = im[:, :, None]
    src_y0, src_x0 = max(-dy, 0), max(-dx, 0)
    dst_y0, dst_x0 = max(dy, 0), max(dx, 0)
    h_copy = min(new_h - src_y0, net_h - dst_y0)
    w_copy = min(new_w - src_x0, net_w - dst_x0)
    out = np.full((net_h, net_w, im.shape[2]), pad_value, im.dtype)
    if h_copy > 0 and w_copy > 0:
        out[dst_y0:dst_y0 + h_copy, dst_x0:dst_x0 + w_copy] = \
            im[src_y0:src_y0 + h_copy, src_x0:src_x0 + w_copy]
    return out


def sample_scale_crop(rng: np.random.RandomState, image_w: int, image_h: int,
                      net_w: int, net_h: int,
                      jitter: float = 0.2) -> Tuple[int, int, int, int, int]:
    """Draw (scale_crop_flag, new_w, new_h, dx, dy): a coin, then (flag 2
    only) the aspect jitter, scale and offset uniforms.  The caller
    rejects a placement that would cut a GT box."""
    scale_crop = rng.randint(1, 3)
    if scale_crop == 2:
        new_ar = (image_w / image_h * rng.uniform(1 - jitter, 1 + jitter)
                  / rng.uniform(1 - jitter, 1 + jitter))
        scale = rng.uniform(0.75, 1.5)
        if new_ar < 1:
            new_h = int(scale * net_h)
            new_w = int(new_h * new_ar)
        else:
            new_w = int(scale * net_w)
            new_h = int(new_w / new_ar)
        dx = int(rng.uniform(0, net_w - new_w))
        dy = int(rng.uniform(0, net_h - new_h))
        return 2, new_w, new_h, dx, dy
    return (1,) + identity_placement(image_w, image_h, net_w, net_h)


def identity_placement(image_w: int, image_h: int, net_w: int,
                       net_h: int) -> Tuple[int, int, int, int]:
    """Centered aspect-preserving letterbox (the flag-1 branch)."""
    new_ar = image_w / image_h
    if new_ar < 1:
        new_h = int(net_h)
        new_w = int(new_h * new_ar)
    else:
        new_w = int(net_w)
        new_h = int(new_w / new_ar)
    return new_w, new_h, (net_w - new_w) // 2, (net_h - new_h) // 2


def add_salt_pepper_noise(im: np.ndarray,
                          rng: np.random.RandomState) -> np.ndarray:
    """In place: salt (value 1, the reference's quirk) and pepper (0) on
    0.4% of the pixels, a fifth of them salt."""
    amount, salt_vs_pepper = 0.004, 0.2
    num_salt = int(np.ceil(amount * im.size * salt_vs_pepper))
    num_pepper = int(np.ceil(amount * im.size * (1.0 - salt_vs_pepper)))
    coords = [rng.randint(0, s - 1, num_salt) for s in im.shape[:2]]
    im[coords[0], coords[1], :] = 1
    coords = [rng.randint(0, s - 1, num_pepper) for s in im.shape[:2]]
    im[coords[0], coords[1], :] = 0
    return im


def rgb_to_hls_u8(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """uint8 RGB [H,W,3] -> (H, L, S) uint8, ``cv2.COLOR_RGB2HLS``'s
    float32 computation (H in [0, 180))."""
    x = img.astype(_F32) * _F32(1.0 / 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    l = (vmax + vmin) * _F32(0.5)
    diff = vmax - vmin
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(l < _F32(0.5),
                     diff / np.maximum(vmax + vmin, _F32(1e-20)),
                     diff / np.maximum(_F32(2.0) - (vmax + vmin), _F32(1e-20)))
        s = np.where(diff == 0, _F32(0.0), s)
        dinv = _F32(60.0) / np.maximum(diff, _F32(1e-20))
        # OpenCV's SIMD path takes num * dinv + part as one fused
        # multiply-add: the float64 product of two float32 values is
        # exact, so the sum rounds once to float32 as the FMA does
        num = np.where(vmax == r, g - b, np.where(vmax == g, b - r, r - g))
        part = np.where(vmax == r, 0.0, np.where(vmax == g, 120.0, 240.0))
        hue = (num.astype(np.float64) * dinv.astype(np.float64)
               + part).astype(_F32)
    hue = np.where(diff == 0, _F32(0.0), hue)
    hue = np.where(hue < 0, hue + _F32(360.0), hue)
    return (np.rint(hue * _F32(0.5)).astype(np.uint8),
            np.rint(l * _F32(255.0)).astype(np.uint8),
            np.rint(s * _F32(255.0)).astype(np.uint8))


def hls_to_rgb_u8(h8: np.ndarray, l8: np.ndarray,
                  s8: np.ndarray) -> np.ndarray:
    """uint8 (H, L, S) -> uint8 RGB [H,W,3], ``cv2.COLOR_HLS2RGB``'s
    float32 computation."""
    h = h8.astype(_F32) * _F32(2.0)
    l = l8.astype(_F32) * _F32(1.0 / 255.0)
    s = s8.astype(_F32) * _F32(1.0 / 255.0)
    q = np.where(l < _F32(0.5), l * (_F32(1) + s), l + s - l * s)
    p = _F32(2.0) * l - q

    def chan(hh):
        hh = np.mod(hh, _F32(360.0)) * _F32(1.0 / 360.0)
        return np.where(hh < _F32(1 / 6), p + (q - p) * _F32(6) * hh,
                        np.where(hh < _F32(1 / 2), q,
                                 np.where(hh < _F32(2 / 3),
                                          p + (q - p) * (_F32(2 / 3) - hh)
                                          * _F32(6), p)))

    rgb = np.stack([chan(h + _F32(120)), chan(h), chan(h - _F32(120))],
                   axis=-1)
    return np.clip(np.rint(rgb * _F32(255.0)), 0, 255).astype(np.uint8)


def change_light(image: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Scale the HLS lightness of a uint8 RGB image by U(0.5, 1.5), clamp
    at 255 and truncate, through the exact uint8 HLS round trip."""
    coeff = rng.uniform() + 0.5
    h8, l8, s8 = rgb_to_hls_u8(image)
    lut = np.minimum(np.arange(256, dtype=np.float64) * coeff,
                     255).astype(np.uint8)
    return hls_to_rgb_u8(h8, lut[l8], s8)


def _motion_kernel(dim: int, angle_deg: float, line_type: str) -> np.ndarray:
    """Length-``dim`` line kernel at ``angle_deg``; 'left'/'right' use half."""
    k = np.zeros((dim, dim), np.float64)
    c = dim // 2
    rad = math.radians(angle_deg)
    dxy = (math.cos(rad), -math.sin(rad))
    span = {"full": range(-c, c + 1), "right": range(0, c + 1),
            "left": range(-c, 1)}[line_type]
    for t in span:
        x = int(round(c + t * dxy[0]))
        y = int(round(c + t * dxy[1]))
        if 0 <= x < dim and 0 <= y < dim:
            k[y, x] = 1.0
    return k / max(k.sum(), 1.0)


def filter2d_u8(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` of a uint8 [H,W,C] image:
    correlation with the kernel cast to float32, reflect-101 border, the
    float32 sum of the nonzero taps (row-major) rounded half to even."""
    kh, kw = kernel.shape
    kf = kernel.astype(_F32)
    padded = np.pad(img, ((kh // 2, kh // 2), (kw // 2, kw // 2), (0, 0)),
                    mode="reflect").astype(_F32)
    h, w = img.shape[:2]
    acc = np.zeros(img.shape, _F32)
    for y in range(kh):
        for x in range(kw):
            if kf[y, x]:
                acc += kf[y, x] * padded[y:y + h, x:x + w]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def linear_motion_blur(img: np.ndarray,
                       rng: np.random.RandomState) -> np.ndarray:
    """A length-3 line kernel at one of 4 quantized angles, of type
    'right', 'left' or 'full', applied as ``cv2.filter2D`` does."""
    dim = 3     # the reference keeps 3 so thin cracks stay visible
    angles = np.linspace(0, 180, (dim // 2) * 4, endpoint=False)
    angle = float(angles[rng.randint(0, len(angles))])
    line_type = ["right", "left", "full"][rng.randint(0, 3)]
    return filter2d_u8(img, _motion_kernel(dim, angle, line_type))


def apply_photometric(image: np.ndarray, bnl: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Dispatch by the reference's code order: 2 -> salt & pepper, 3 ->
    light, 4 -> motion blur, anything else -> unchanged."""
    if bnl == 2:
        return add_salt_pepper_noise(image, rng)
    if bnl == 3:
        return change_light(image, rng)
    if bnl == 4:
        return linear_motion_blur(image, rng)
    return image
