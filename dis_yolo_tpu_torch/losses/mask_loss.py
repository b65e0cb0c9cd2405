"""Mask-subnet loss: ROI sampling, GT matching, assembled-mask BCE
(PyTorch counterpart of ``dis_yolo_tpu/losses/mask_loss.py``).

  * proposals = the padded [B,D,4] NMS output; validity = nonzero row;
  * GT = padded [B,T,5] true boxes + [B,T,H,W] bool masks, resized to the
    score-map size with TF1's origin-aligned bilinear sampling and rounded;
  * ROI mix per image: 7 random valid proposals + 3 random valid GT boxes;
  * positives: ROI best IoU against GT >= 0.5, each assigned its argmax
    GT mask;
  * per-ROI loss: BCE between the assembled logits and the assigned mask
    inside the box, over the box area; the mean over positive ROIs times
    ``mask_scale``; an image without positives gives 0.

The batch is written out (no vmap).  The random picks take their uniforms
as tensors, ``u_prop`` [B,D] and ``u_gt`` [B,T] (the JAX package draws
them with ``jax.random.uniform`` from per-image keys; ``draw_uniforms``
draws them from a ``torch.Generator``), so a test can hand both sides the
same numbers.  Assembly runs through ``assemble_masks_trainable``: kernels
K1 and K3 on CUDA, their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.losses.yolo_loss import bce_with_logits
from dis_yolo_tpu_torch.ops.boxes import cxcywh_to_yxyx, iou_matrix_yxyx
from dis_yolo_tpu_torch.ops.cuda_assembly import assemble_masks_trainable
from dis_yolo_tpu_torch.ops.mask_assembly import box_inside_mask
from dis_yolo_tpu_torch.ops.nms import _top_k

N_PROP = 7   # random proposals mixed into the ROI set
N_GT = 3     # random GT boxes mixed into the ROI set


def draw_uniforms(generator: torch.Generator, batch: int, n_prop: int,
                  n_gt: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_prop [B,D], u_gt [B,T]) uniform in [0, 1) from ``generator``
    (on its own device), moved to ``device``."""
    u_prop = torch.rand((batch, n_prop), generator=generator,
                        device=generator.device)
    u_gt = torch.rand((batch, n_gt), generator=generator,
                      device=generator.device)
    return u_prop.to(device), u_gt.to(device)


def random_take(u: torch.Tensor, n_take: int, valid: torch.Tensor):
    """Up to ``n_take`` random valid indices per row: the top ``n_take`` of
    ``u - 1e6 * ~valid`` (ties at the lowest index, as ``lax.top_k``).
    Returns (indices [B,n_take], taken_valid [B,n_take])."""
    pri = u - (~valid).float() * 1e6
    _, idx = _top_k(pri, n_take)
    return idx, torch.gather(valid, 1, idx)


def _tf1_bilinear_taps(in_size: int, out_size: int, device):
    """The two nonzero taps of each row of TF1's legacy bilinear resize
    matrix (``align_corners=False``: ``src = dst * in/out``, ``lo =
    floor(src)``, ``hi = min(lo+1, in-1)``), the JAX package's
    ``_tf1_bilinear_matrix``: (lo, hi, w_lo, w_hi), with the two weights
    of an edge row where ``hi == lo`` summed into ``w_lo`` as the matrix
    sums them."""
    scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    src = torch.arange(out_size, dtype=torch.float32) * scale
    lo = torch.floor(src).long()
    frac = src - lo.float()
    hi = torch.clamp(lo + 1, max=in_size - 1)
    edge = hi == lo
    w_lo = torch.where(edge, (1.0 - frac) + frac, 1.0 - frac)
    w_hi = torch.where(edge, 0.0, frac)
    return lo.to(device), hi.to(device), w_lo.to(device), w_hi.to(device)


def _resize_axis(m: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    lo, hi, w_lo, w_hi = _tf1_bilinear_taps(m.shape[axis], size, m.device)
    shape = [1] * m.dim()
    shape[axis] = size
    return (m.index_select(axis, lo) * w_lo.view(shape)
            + m.index_select(axis, hi) * w_hi.view(shape))


def resize_gt_masks(true_masks: torch.Tensor, size: int) -> torch.Tensor:
    """[..., T, H, W] bool -> float {0, 1} at [..., T, size, size]: the
    bilinear resize + round of ``tf.image.resize_images`` + ``tf.round``.

    The JAX package multiplies by the dense TF1 matrix on each side; each
    matrix row has two nonzero weights, so here each output is the same
    two products summed in the same order, in float32, with no matmul
    (whose TF32 mode would shift the weights and flip rounded pixels).
    """
    m = true_masks.float()
    out = _resize_axis(_resize_axis(m, m.dim() - 2, size), m.dim() - 1, size)
    return torch.round(out)


def mask_loss_per_image(scoremaps: torch.Tensor, detections: torch.Tensor,
                        true_boxes: torch.Tensor, masks_small: torch.Tensor,
                        u_prop: torch.Tensor, u_gt: torch.Tensor,
                        cfg: DISYoloConfig, iou_threshold: float = 0.5
                        ) -> torch.Tensor:
    """[B] per-image mask losses.

    scoremaps [B,S,S,k*k]; detections [B,D,6] padded NMS output (y1, x1,
    y2, x2, cls, conf); true_boxes [B,T,5] normalized (xc, yc, w, h,
    classid), zero-padded; masks_small [B,T,S,S] GT masks at the score-map
    size, {0, 1}; u_prop [B,D] and u_gt [B,T] the ROI picks' uniforms.
    """
    s = scoremaps.shape[1]
    proposals = detections[..., :4]
    prop_valid = torch.sum(torch.abs(proposals), dim=-1) > 0
    gt_xywh = true_boxes[..., :4]
    gt_valid = torch.sum(torch.abs(gt_xywh), dim=-1) > 0
    gt_boxes = cxcywh_to_yxyx(gt_xywh)                           # [B,T,4]

    pidx, pval = random_take(u_prop, N_PROP, prop_valid)
    gidx, gval = random_take(u_gt, N_GT, gt_valid)
    rois = torch.cat([
        torch.gather(proposals, 1, pidx[..., None].expand(-1, -1, 4)),
        torch.gather(gt_boxes, 1, gidx[..., None].expand(-1, -1, 4))], 1)
    roi_valid = torch.cat([pval, gval], 1)                       # [B,10]

    overlaps = iou_matrix_yxyx(rois, gt_boxes)                   # [B,10,T]
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)
    roi_iou_max = overlaps.max(dim=-1).values
    positive = roi_valid & (roi_iou_max >= iou_threshold)
    assignment = torch.argmax(overlaps, dim=-1)                  # [B,10]
    roi_gt_mask = torch.gather(
        masks_small, 1, assignment[..., None, None].expand(-1, -1, s, s))

    rois_px = torch.round(rois * float(s))
    logits = assemble_masks_trainable(scoremaps, rois_px, cfg.k_map)
    inside = box_inside_mask(rois_px, s)                         # [B,10,S,S]
    num = torch.sum(inside * bce_with_logits(roi_gt_mask, logits), dim=(2, 3))
    den = torch.sum(inside, dim=(2, 3)).clamp_min(1.0)
    per_roi = num / den
    n_pos = positive.float().sum(-1)
    mean_pos = torch.sum(per_roi * positive, -1) / n_pos.clamp_min(1.0)
    return torch.where(n_pos > 0, cfg.mask_scale * mean_pos, 0.0)

