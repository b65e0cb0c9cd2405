"""DIS-YOLO network: Darknet-53 backbone, 3 YOLOv3 heads, mask decoder.

PyTorch counterpart of ``dis_yolo_tpu/models/dis_yolo.py``: the same 52
backbone conv_bn layers with skip taps at 1x .. 1/16 resolution, three
detection towers at strides 32/16/8 emitting ``(5 + C) * 3`` channels,
and the FPN-style mask decoder down to ``cfg.mask_stride`` score maps
(k^2 channels).  Submodules are named ``convolutional1..85`` like the
Flax modules, so the weight bridge (``models/weights.py``) maps names 1:1.

The public outputs keep the JAX layouts and dtype: raw heads
``[B, H/s, W/s, 3, 5+C]`` and score maps ``[B, S, S, k^2]``, NHWC, all
float32.  Inside, the convs run NCHW on a channels-last view of the NHWC
input.  ``model.train()`` is Flax's ``train=True``: BatchNorm uses batch
statistics, except in the layers of ``cfg.locked_layers``.

The serving graphs choose each conv_bn layer as the JAX package does:
``QuantConv`` for ``cfg.quant`` and an id in ``cfg.quant_layers``, else
``DeployConv`` for ``cfg.deploy or cfg.quant``, else ``ConvBN`` (the
decoder's fusion nodes 77/80/83 as ``CommutedConcatConvBN`` with
``cfg.decoder_commute`` outside the deploy and quant graphs).
``cfg.s2d_stem`` replaces conv1/conv2 by the space-to-depth stem
(``models/s2d.py``).  ``remat`` is refused by ``cfg.check_ported()``.

``stop_stage`` is a profiling probe, as in the JAX package: the forward
returns early at a named cut (``STOP_STAGES``: after the stem, the
128-, 256- and 512-channel stages, the backbone, or the heads: then the
stride-8 tower's last 1x1 output), as a 1-tuple holding that activation
NHWC in the compute dtype, so timings of the truncated forwards itemize
where a forward's time goes.  None (the default) is the full network;
training never sets it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models.layers import (CommutedConcatConvBN, ConvBias,
                                              ConvBN, DeployConv,
                                              upsample2x_nearest)
from dis_yolo_tpu_torch.models.quant import QuantConv
from dis_yolo_tpu_torch.models.s2d import space_to_depth

# the decoder's fusion nodes: ConvBN1x1(concat([skip, up2(small)]))
_DECODER_FUSION = (77, 80, 83)
STOP_STAGES = ("stem", "c128", "c256", "c512", "backbone", "heads")


def _layer_specs(cfg: DISYoloConfig):
    """(idx, kind, cin, features, kernel, stride) for every conv layer."""
    if cfg.s2d_stem:
        if not cfg.deploy or cfg.mask_stride == 1:
            raise ValueError("s2d_stem requires deploy=True and "
                             "mask_stride != 1 (conv1 skip unavailable)")
        stem = [(1, "cbn", 12, 128, 3, 1), (2, "cbn", 128, 64, 2, 1)]
    else:
        stem = [(1, "cbn", 3, 32, 3, 1), (2, "cbn", 32, 64, 3, 2)]
    specs = stem + [(3, "cbn", 64, 32, 1, 1), (4, "cbn", 32, 64, 3, 1),
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
    out = cfg.output_depth
    # detection towers: (first idx, cin of the first 1x1, width)
    for first, cin, w in ((53, 1024, 512), (61, 768, 256), (69, 384, 128)):
        specs += [(first, "cbn", cin, w, 1, 1),
                  (first + 1, "cbn", w, 2 * w, 3, 1),
                  (first + 2, "cbn", 2 * w, w, 1, 1),
                  (first + 3, "cbn", w, 2 * w, 3, 1),
                  (first + 4, "cbn", 2 * w, w, 1, 1),
                  (first + 5, "cbn", w, 2 * w, 3, 1),
                  (first + 6, "bias", 2 * w, out, 1, 1)]
        if first < 69:                       # 1x1 before the upsample
            specs.append((first + 7, "cbn", w, w // 2, 1, 1))
    kk = cfg.num_scoremaps
    specs += [(76, "cbn", 128, 64, 1, 1), (77, "cbn", 192, 64, 1, 1),
              (78, "cbn", 64, 128, 3, 1)]
    if cfg.mask_stride == 4:
        specs.append((79, "bias", 128, kk, 1, 1))
    elif cfg.mask_stride in (1, 2):
        specs += [(79, "cbn", 128, 32, 1, 1), (80, "cbn", 96, 32, 1, 1),
                  (81, "cbn", 32, 64, 3, 1)]
        if cfg.mask_stride == 2:
            specs.append((82, "bias", 64, kk, 1, 1))
        else:
            specs += [(82, "cbn", 64, 16, 1, 1), (83, "cbn", 48, 16, 1, 1),
                      (84, "cbn", 16, 32, 3, 1), (85, "bias", 32, kk, 1, 1)]
    else:
        raise ValueError(f"mask_stride must be 1, 2 or 4, "
                         f"got {cfg.mask_stride}")
    return specs


class DISYolo(nn.Module):
    """Returns (raw_s8, raw_s16, raw_s32, scoremaps), all float32 NHWC.

    raw_sN: [B, H/N, W/N, 3, 5+C] raw head outputs (stride N)
    scoremaps: [B, H/m, W/m, k*k] position-sensitive score maps
    (m = ``cfg.mask_stride``)
    """

    def __init__(self, cfg: DISYoloConfig, stop_stage: Optional[str] = None):
        super().__init__()
        cfg.check_ported()
        if stop_stage is not None and stop_stage not in STOP_STAGES:
            raise ValueError(f"stop_stage must be one of {STOP_STAGES} or "
                             f"None, got {stop_stage!r}")
        self.cfg = cfg
        self.stop_stage = stop_stage
        dtype = getattr(torch, cfg.compute_dtype)
        serving = cfg.deploy or cfg.quant
        self.commute = cfg.decoder_commute and not serving
        for idx, kind, cin, feat, kernel, stride in _layer_specs(cfg):
            if kind == "bias":
                layer = ConvBias(cin, feat, dtype)
            elif cfg.quant and idx in cfg.quant_layers:
                layer = QuantConv(cin, feat, kernel, stride, cfg.alpha, dtype,
                                  calibrate=cfg.quant_calibrate,
                                  calib_pct=cfg.quant_calib_pct)
            elif serving:
                # quant graphs keep their other layers (the stem by
                # default) in the float deploy form
                layer = DeployConv(cin, feat, kernel, stride, cfg.alpha, dtype)
            elif self.commute and idx in _DECODER_FUSION:
                layer = CommutedConcatConvBN(cin, feat, cfg.alpha, dtype,
                                             lock=idx in cfg.locked_layers)
            else:
                layer = ConvBN(cin, feat, kernel, stride, cfg.alpha, dtype,
                               lock=idx in cfg.locked_layers)
            self.add_module(f"convolutional{idx}", layer)
        self.compute_dtype = dtype

    def _c(self, idx: int) -> nn.Module:
        return getattr(self, f"convolutional{idx}")

    def _up_concat_cbn(self, idx: int, skip, small):
        """Decoder fusion node: ConvBN1x1(concat([skip, up2(small)])), the
        1x1 before the upsample with ``decoder_commute``."""
        if self.commute and idx in _DECODER_FUSION:
            return self._c(idx)(skip, small)
        return self._c(idx)(torch.cat([skip, upsample2x_nearest(small)], 1))

    def _stop(self, stage: str, x: torch.Tensor):
        """(x as NHWC,) when the forward stops at ``stage``, else None."""
        return (x.permute(0, 2, 3, 1),) if self.stop_stage == stage else None

    @staticmethod
    def _head(y: torch.Tensor, a: int) -> torch.Tensor:
        b, _, h, w = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, h, w, a, -1).float()

    def forward(self, images: torch.Tensor):
        cfg = self.cfg
        c = self._c
        a = cfg.anchors_per_scale
        # NHWC -> NCHW view: channels-last strides, no copy
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)

        # ---- Darknet-53 backbone ----
        if cfg.s2d_stem:
            # conv1' on the (a, b, ch)-packed input emits conv1's output
            # repacked at half resolution; conv2' (2x2, stride 1, 'SAME'
            # pads (0, 1)) lands on conv2's output; no full-res tap
            x = c(2)(c(1)(space_to_depth(x)))
            skip1 = None
        else:
            x = c(1)(x)
            skip1 = x                                 # 1/1, 32ch
            x = c(2)(x)
        if (cut := self._stop("stem", x)) is not None:
            return cut
        x = x + c(4)(c(3)(x))
        skip2 = x                                     # 1/2, 64ch
        x = c(5)(x)
        x = x + c(7)(c(6)(x))
        x = x + c(9)(c(8)(x))
        skip3 = x                                     # 1/4, 128ch
        if (cut := self._stop("c128", x)) is not None:
            return cut
        x = c(10)(x)
        for i in range(8):
            x = x + c(2 * i + 12)(c(2 * i + 11)(x))
        skip4 = x                                     # 1/8, 256ch
        if (cut := self._stop("c256", x)) is not None:
            return cut
        x = c(27)(x)
        for i in range(8):
            x = x + c(2 * i + 29)(c(2 * i + 28)(x))
        skip5 = x                                     # 1/16, 512ch
        if (cut := self._stop("c512", x)) is not None:
            return cut
        x = c(44)(x)
        for i in range(4):
            x = x + c(2 * i + 46)(c(2 * i + 45)(x))
        if (cut := self._stop("backbone", x)) is not None:
            return cut

        # ---- head 1: stride 32 ----
        for i in range(53, 58):
            x = c(i)(x)
        raw_s32 = self._head(c(59)(c(58)(x)), a)

        # ---- head 2: stride 16 ----
        x = self._up_concat_cbn(61, skip5, c(60)(x))
        for i in range(62, 66):
            x = c(i)(x)
        raw_s16 = self._head(c(67)(c(66)(x)), a)

        # ---- head 3: stride 8 ----
        x = self._up_concat_cbn(69, skip4, c(68)(x))
        for i in range(70, 74):
            x = c(i)(x)
        raw_s8 = self._head(c(75)(c(74)(x)), a)
        if (cut := self._stop("heads", x)) is not None:
            return cut

        # ---- mask decoder: stride 8 -> cfg.mask_stride score maps ----
        m = self._up_concat_cbn(77, skip3, c(76)(x))
        m = c(78)(m)
        if cfg.mask_stride == 4:
            sm = c(79)(m)
        else:
            m = self._up_concat_cbn(80, skip2, c(79)(m))
            m = c(81)(m)
            if cfg.mask_stride == 2:
                sm = c(82)(m)
            else:
                m = self._up_concat_cbn(83, skip1, c(82)(m))
                sm = c(85)(c(84)(m))
        scoremaps = sm.permute(0, 2, 3, 1).float().contiguous()
        return (raw_s8.contiguous(), raw_s16.contiguous(),
                raw_s32.contiguous(), scoremaps)
