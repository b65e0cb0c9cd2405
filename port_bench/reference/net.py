"""DIS-YOLO's network in plain float32: the Darknet-53 backbone, three
YOLOv3 heads and the position-sensitive mask decoder at stride 1 or 2.

A functional copy of the port's ``models/dis_yolo.py`` default graph
(``ConvBN`` layers, eval-mode BatchNorm), taking its weights as a dict
under the port's ``state_dict`` names (``convolutional<i>.conv.weight``,
``.bn.weight`` / ``.bn.bias`` / ``.bn.running_mean`` /
``.bn.running_var``, ``.conv.bias`` for the head convs), so one dict
drives both.  Layer ``i`` follows the DIS-YOLO reference's
``yolo3_net_pos.py``: 52 backbone layers, detection towers 53-75, the
mask decoder 76-82 (stride 2) or 76-85 (stride 1).

Departures from the port, all of precision or form only: every conv,
BatchNorm and activation runs in float32 (the port convolves in
bfloat16); BatchNorm is the closed form ``(x - mean) / sqrt(var + eps)
* gamma + beta``; padding is XLA's 'SAME' written out with ``F.pad``.
``calibrate=True`` normalizes each layer with its batch's biased
moments and writes them into the dict as the running statistics
(``port_bench/weights.py`` uses it to give random weights the
statistics of the images they see).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
ALPHA = 0.1


def layer_specs(image_size: int, mask_stride: int, num_class: int,
                k_map: int, anchors_per_scale: int = 3
                ) -> List[Tuple[int, str, int, int, int, int]]:
    """(index, kind, cin, cout, kernel, stride) of every conv layer;
    kind "cbn" is conv + BatchNorm + leaky ReLU, "bias" a conv with a
    bias and nothing after it."""
    del image_size
    specs = [(1, "cbn", 3, 32, 3, 1), (2, "cbn", 32, 64, 3, 2),
             (3, "cbn", 64, 32, 1, 1), (4, "cbn", 32, 64, 3, 1),
             (5, "cbn", 64, 128, 3, 2)]
    for i in (6, 8):
        specs += [(i, "cbn", 128, 64, 1, 1), (i + 1, "cbn", 64, 128, 3, 1)]
    specs.append((10, "cbn", 128, 256, 3, 2))
    for i in range(11, 27, 2):
        specs += [(i, "cbn", 256, 128, 1, 1), (i + 1, "cbn", 128, 256, 3, 1)]
    specs.append((27, "cbn", 256, 512, 3, 2))
    for i in range(28, 44, 2):
        specs += [(i, "cbn", 512, 256, 1, 1), (i + 1, "cbn", 256, 512, 3, 1)]
    specs.append((44, "cbn", 512, 1024, 3, 2))
    for i in range(45, 53, 2):
        specs += [(i, "cbn", 1024, 512, 1, 1), (i + 1, "cbn", 512, 1024, 3, 1)]
    out = (num_class + 5) * anchors_per_scale
    for first, cin, w in ((53, 1024, 512), (61, 768, 256), (69, 384, 128)):
        specs += [(first, "cbn", cin, w, 1, 1),
                  (first + 1, "cbn", w, 2 * w, 3, 1),
                  (first + 2, "cbn", 2 * w, w, 1, 1),
                  (first + 3, "cbn", w, 2 * w, 3, 1),
                  (first + 4, "cbn", 2 * w, w, 1, 1),
                  (first + 5, "cbn", w, 2 * w, 3, 1),
                  (first + 6, "bias", 2 * w, out, 1, 1)]
        if first < 69:
            specs.append((first + 7, "cbn", w, w // 2, 1, 1))
    kk = k_map * k_map
    specs += [(76, "cbn", 128, 64, 1, 1), (77, "cbn", 192, 64, 1, 1),
              (78, "cbn", 64, 128, 3, 1), (79, "cbn", 128, 32, 1, 1),
              (80, "cbn", 96, 32, 1, 1), (81, "cbn", 32, 64, 3, 1)]
    if mask_stride == 2:
        specs.append((82, "bias", 64, kk, 1, 1))
    elif mask_stride == 1:
        specs += [(82, "cbn", 64, 16, 1, 1), (83, "cbn", 48, 16, 1, 1),
                  (84, "cbn", 16, 32, 3, 1), (85, "bias", 32, kk, 1, 1)]
    else:
        raise ValueError(f"the reference has mask strides 1 and 2, got "
                         f"{mask_stride}")
    return specs


def param_shapes(specs) -> Dict[str, Tuple[int, ...]]:
    """The float parameters and statistics of every layer, by name."""
    shapes = {}
    for idx, kind, cin, cout, k, _ in specs:
        name = f"convolutional{idx}"
        shapes[f"{name}.conv.weight"] = (cout, cin, k, k)
        if kind == "bias":
            shapes[f"{name}.conv.bias"] = (cout,)
        else:
            for leaf in ("bn.weight", "bn.bias", "bn.running_mean",
                         "bn.running_var"):
                shapes[f"{name}.{leaf}"] = (cout,)
    return shapes


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x, weight, bias, stride):
    k = weight.shape[-1]
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride)


def _up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Net:
    """``Net(specs, weights)(images)`` -> (raw_s8, raw_s16, raw_s32,
    scoremaps), NHWC float32, as the port's ``DISYolo`` returns them:
    raw heads [B, H/s, W/s, 3, 5+C], score maps [B, S, S, k^2]."""

    def __init__(self, specs, weights: Dict[str, torch.Tensor],
                 calibrate: bool = False):
        self.specs = {s[0]: s for s in specs}
        self.w = weights
        self.calibrate = calibrate
        self.anchors_per_scale = 3

    def c(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        _, kind, _, _, _, stride = self.specs[idx]
        name = f"convolutional{idx}"
        w = self.w
        if kind == "bias":
            return _conv(x, w[f"{name}.conv.weight"], w[f"{name}.conv.bias"],
                         stride)
        y = _conv(x, w[f"{name}.conv.weight"], None, stride)
        if self.calibrate:
            mean = y.mean((0, 2, 3))
            var = (y * y).mean((0, 2, 3)) - mean * mean
            w[f"{name}.bn.running_mean"].copy_(mean)
            w[f"{name}.bn.running_var"].copy_(var.clamp_min(0.0))
        mean = w[f"{name}.bn.running_mean"][:, None, None]
        var = w[f"{name}.bn.running_var"][:, None, None]
        y = ((y - mean) / torch.sqrt(var + BN_EPS)
             * w[f"{name}.bn.weight"][:, None, None]
             + w[f"{name}.bn.bias"][:, None, None])
        return torch.where(y > 0, y, ALPHA * y)

    def _head(self, y):
        b, ch, h, wd = y.shape
        a = self.anchors_per_scale
        return y.permute(0, 2, 3, 1).reshape(b, h, wd, a, ch // a).contiguous()

    @torch.no_grad()
    def __call__(self, images: torch.Tensor):
        c = self.c
        x = images.float().permute(0, 3, 1, 2)
        x = c(1, x)
        skip1 = x
        x = c(2, x)
        x = x + c(4, c(3, x))
        skip2 = x
        x = c(5, x)
        x = x + c(7, c(6, x))
        x = x + c(9, c(8, x))
        skip3 = x
        x = c(10, x)
        for i in range(8):
            x = x + c(2 * i + 12, c(2 * i + 11, x))
        skip4 = x
        x = c(27, x)
        for i in range(8):
            x = x + c(2 * i + 29, c(2 * i + 28, x))
        skip5 = x
        x = c(44, x)
        for i in range(4):
            x = x + c(2 * i + 46, c(2 * i + 45, x))
        for i in range(53, 58):
            x = c(i, x)
        raw_s32 = self._head(c(59, c(58, x)))
        x = c(61, torch.cat([skip5, _up2(c(60, x))], 1))
        for i in range(62, 66):
            x = c(i, x)
        raw_s16 = self._head(c(67, c(66, x)))
        x = c(69, torch.cat([skip4, _up2(c(68, x))], 1))
        for i in range(70, 74):
            x = c(i, x)
        raw_s8 = self._head(c(75, c(74, x)))
        m = c(77, torch.cat([skip3, _up2(c(76, x))], 1))
        m = c(78, m)
        m = c(80, torch.cat([skip2, _up2(c(79, m))], 1))
        m = c(81, m)
        if 85 in self.specs:
            m = c(83, torch.cat([skip1, _up2(c(82, m))], 1))
            sm = c(85, c(84, m))
        else:
            sm = c(82, m)
        return raw_s8, raw_s16, raw_s32, sm.permute(0, 2, 3, 1).contiguous()
