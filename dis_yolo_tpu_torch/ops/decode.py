"""Anchor decoding of raw YOLO head outputs (PyTorch counterpart of
``dis_yolo_tpu/ops/decode.py``).

Scale index 0 is the stride-8 (largest grid / small objects) map, so the
anchor slice for scale i is ``anchors[3*i : 3*i+3]``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from dis_yolo_tpu_torch.config import DISYoloConfig


class ScalePrediction(NamedTuple):
    """Decoded predictions for one YOLO scale (all float32)."""

    conf_logit: torch.Tensor      # [B, H, W, A, 1]
    class_logit: torch.Tensor     # [B, H, W, A, C]
    coord: torch.Tensor           # [B, H, W, A, 4] (sigmoid cx, cy, raw tw, th)
    norm_coord: torch.Tensor      # [B, H, W, A, 4] (xc, yc, w, h in [0,1] units)
    anchors: torch.Tensor         # [A, 2] pixel anchors for this scale


def cell_offsets(grid_h: int, grid_w: int, device=None) -> torch.Tensor:
    """(x, y) cell-corner offsets: [1, H, W, 1, 2]."""
    ys, xs = torch.meshgrid(
        torch.arange(grid_h, dtype=torch.float32, device=device),
        torch.arange(grid_w, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None, :, :, None, :]


def decode_scale(raw: torch.Tensor, scale_idx: int, cfg: DISYoloConfig,
                 net_hw: Sequence[int]) -> ScalePrediction:
    """Decode one head output [B, H, W, A, 5+C] -> ScalePrediction."""
    raw = raw.float()
    grid_h, grid_w = raw.shape[1], raw.shape[2]
    net_h, net_w = net_hw
    a = cfg.anchors_per_scale
    dev = raw.device

    conf_logit = raw[..., 4:5]
    class_logit = raw[..., 5:]
    # the literal formula, not torch.sigmoid: ULP parity with the reference
    pred_cxy = 1.0 / (1.0 + torch.exp(-raw[..., :2]))
    pred_twh = raw[..., 2:4]
    coord = torch.cat([pred_cxy, pred_twh], dim=-1)

    grid_factor = torch.tensor([grid_w, grid_h], dtype=torch.float32,
                               device=dev)
    net_factor = torch.tensor([net_w, net_h], dtype=torch.float32, device=dev)
    anchors = torch.as_tensor(
        cfg.anchors_array()[a * scale_idx: a * scale_idx + a], device=dev)

    box_xy = (cell_offsets(grid_h, grid_w, dev) + pred_cxy) / grid_factor
    box_wh = torch.exp(pred_twh) * anchors[None, None, None] / net_factor
    norm_coord = torch.cat([box_xy, box_wh], dim=-1)
    return ScalePrediction(conf_logit, class_logit, coord, norm_coord, anchors)


def decode_all(raws: Sequence[torch.Tensor],
               cfg: DISYoloConfig) -> List[ScalePrediction]:
    """Decode the three scales; ``raws[0]`` is the stride-8 map.

    ``net_hw`` is the stride-32 grid times 32, as in the reference.
    """
    net_h = raws[2].shape[1] * 32
    net_w = raws[2].shape[2] * 32
    return [decode_scale(r, i, cfg, (net_h, net_w)) for i, r in enumerate(raws)]
