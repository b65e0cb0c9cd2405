"""Three-scale YOLOv3 detection loss (PyTorch counterpart of
``dis_yolo_tpu/losses/yolo_loss.py``, term for term):

  * ignore mask: each predicted box's best IoU against the padded true
    boxes; the no-object confidence loss is dropped where it reaches
    ``cfg.ignore_thresh``;
  * conf loss = obj * BCE * object_scale + noobj * ignore * BCE *
    noobject_scale, summed over the grid and meaned over the batch;
  * class loss = sparse softmax cross-entropy at object cells;
  * coord loss = squared error on (sigmoid-space cxy, log-space twh) with
    the (2 - w*h)^2 size scale; the twh targets' log is clipped to +-1e2.

``net_hw`` is the stride-32 grid times 32, as in decoding.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.ops.boxes import iou_cxcywh_pairwise
from dis_yolo_tpu_torch.ops.decode import ScalePrediction, cell_offsets


def bce_with_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``tf.nn.sigmoid_cross_entropy_with_logits``'s formula."""
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def _softmax_ce(labels_idx: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``tf.nn.sparse_softmax_cross_entropy_with_logits``."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels_idx[..., None])[..., 0]
    return logz - picked


def yolo_loss(preds: Sequence[ScalePrediction], true_boxes: torch.Tensor,
              labels: Sequence[torch.Tensor], cfg: DISYoloConfig
              ) -> Dict[str, torch.Tensor]:
    """preds: decoded scales, index 0 = stride 8; true_boxes [B,1,1,1,T,5]
    normalized (xc, yc, w, h, classid), zero rows = padding; labels: per
    scale [B,H,W,A,5+C] in the order of ``preds``.  Returns the scalar
    conf / class / coord losses and the monitoring splits (object,
    noobject, xy, wh), all scale-weighted."""
    dev = preds[0].conf_logit.device
    net_hw = torch.tensor([preds[2].conf_logit.shape[2] * 32,
                           preds[2].conf_logit.shape[1] * 32],
                          dtype=torch.float32, device=dev)   # (net_w, net_h)
    true_xywh = true_boxes[..., 0:4]                         # [B,1,1,1,T,4]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    objloss = noobjloss = xyloss = whloss = zero
    confloss = classloss = coordloss = zero

    for i, p in enumerate(preds):
        grid_h, grid_w = p.conf_logit.shape[1], p.conf_logit.shape[2]
        grid_factor = torch.tensor([grid_w, grid_h], dtype=torch.float32,
                                   device=dev)

        # ignore mask: a comparison, so no gradient flows through the IoU
        with torch.no_grad():
            iou = iou_cxcywh_pairwise(p.norm_coord[..., None, :], true_xywh)
            best_iou = iou.max(dim=-1).values
            ignore = (best_iou < cfg.ignore_thresh).float()[..., None]

        label = labels[i]
        object_mask = label[..., 4:5]
        noobject_mask = 1.0 - object_mask

        bce = bce_with_logits(object_mask, p.conf_logit)
        obj_l = torch.mean(torch.sum(object_mask * bce * cfg.object_scale,
                                     dim=(1, 2, 3, 4)))
        noobj_l = torch.mean(torch.sum(
            noobject_mask * ignore * bce * cfg.noobject_scale,
            dim=(1, 2, 3, 4)))

        true_cls = torch.argmax(label[..., 5:], dim=-1)
        ce = _softmax_ce(true_cls, p.class_logit)[..., None]
        class_l = torch.mean(torch.sum(object_mask * ce * cfg.class_scale,
                                       dim=(1, 2, 3, 4)))

        pred_cxy = p.coord[..., 0:2]
        pred_twh = p.coord[..., 2:4]
        offs = cell_offsets(grid_h, grid_w, dev)              # [1,H,W,1,2]
        true_cxy = label[..., 0:2] * grid_factor - offs
        true_twh_px = label[..., 2:4] * net_hw
        true_twh = torch.clamp(
            torch.log(torch.where(object_mask > 0, true_twh_px, 1.0)
                      / p.anchors[None, None, None, :, :]),
            -1e2, 1e2)
        wh_scale = (2.0 - label[..., 2] * label[..., 3])[..., None]
        cxy_d = object_mask * (pred_cxy - true_cxy)
        twh_d = object_mask * (pred_twh - true_twh)
        xy_l = torch.mean(torch.sum(
            torch.square(cxy_d) * torch.square(wh_scale) * cfg.coord_scale,
            dim=(1, 2, 3, 4)))
        wh_l = torch.mean(torch.sum(
            torch.square(twh_d) * torch.square(wh_scale) * cfg.coord_scale,
            dim=(1, 2, 3, 4)))

        objloss = objloss + obj_l
        noobjloss = noobjloss + noobj_l
        xyloss = xyloss + xy_l
        whloss = whloss + wh_l
        confloss = confloss + (obj_l + noobj_l)
        classloss = classloss + class_l
        coordloss = coordloss + (xy_l + wh_l)

    return {
        "conf_loss": confloss, "class_loss": classloss, "coord_loss": coordloss,
        "object_loss": objloss, "noobject_loss": noobjloss,
        "xy_loss": xyloss, "wh_loss": whloss,
    }
