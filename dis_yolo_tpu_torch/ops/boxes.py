"""Box geometry primitives (PyTorch counterpart of
``dis_yolo_tpu/ops/boxes.py``): fixed shapes, any leading batch dims."""

from __future__ import annotations

import torch


def cxcywh_to_yxyx(boxes: torch.Tensor) -> torch.Tensor:
    """[..., (xc, yc, w, h)] -> [..., (y1, x1, y2, x2)] (normalized coords)."""
    xc, yc, w, h = boxes.unbind(-1)
    return torch.stack([yc - h / 2.0, xc - w / 2.0, yc + h / 2.0,
                        xc + w / 2.0], dim=-1)


def clip_boxes(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Clip [..., N, (y1,x1,y2,x2)] boxes to ``window`` [..., 4] =
    (wy1, wx1, wy2, wx2), one window per leading index."""
    wy1, wx1, wy2, wx2 = (window[..., i, None] for i in range(4))
    y1 = torch.minimum(torch.maximum(boxes[..., 0], wy1), wy2)
    x1 = torch.minimum(torch.maximum(boxes[..., 1], wx1), wx2)
    y2 = torch.minimum(torch.maximum(boxes[..., 2], wy1), wy2)
    x2 = torch.minimum(torch.maximum(boxes[..., 3], wx1), wx2)
    return torch.stack([y1, x1, y2, x2], dim=-1)


def iou_matrix_yxyx(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., N, 4] and [..., M, 4] yxyx boxes -> [..., N, M].

    Zero-union pairs give 0 (the ``where(union > 0, ...)`` guard); no
    epsilon, like the reference.
    """
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    y1 = torch.maximum(b1[..., 0], b2[..., 0])
    x1 = torch.maximum(b1[..., 1], b2[..., 1])
    y2 = torch.minimum(b1[..., 2], b2[..., 2])
    x2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = a1 + a2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def iou_cxcywh_pairwise(pred_xywh: torch.Tensor,
                        true_xywh: torch.Tensor) -> torch.Tensor:
    """IoU of the YOLO loss's ignore mask: pred [..., 1, 4] broadcast
    against true [..., T, 4], both (xc, yc, w, h); the union is floored at
    1e-10 and the result clipped to [0, 1], like the reference."""
    pred_xy, pred_wh = pred_xywh[..., 0:2], pred_xywh[..., 2:4]
    true_xy, true_wh = true_xywh[..., 0:2], true_xywh[..., 2:4]
    pred_min, pred_max = pred_xy - pred_wh / 2.0, pred_xy + pred_wh / 2.0
    true_min, true_max = true_xy - true_wh / 2.0, true_xy + true_wh / 2.0
    inter_wh = (torch.minimum(pred_max, true_max)
                - torch.maximum(pred_min, true_min)).clamp_min(0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = (pred_wh[..., 0] * pred_wh[..., 1]
             + true_wh[..., 0] * true_wh[..., 1] - inter).clamp_min(1e-10)
    return torch.clamp(inter / union, 0.0, 1.0)
