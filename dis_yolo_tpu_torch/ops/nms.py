"""Fixed-shape detection filtering + class-aware NMS (PyTorch counterpart
of ``dis_yolo_tpu/ops/nms.py``).

  1. class-specific confidence = sigmoid(obj) * max softmax(class)
  2. cxcywh -> yxyx, clip to the per-image window
  3. validity = conf > obj_threshold (strict)
  4. top-K score-sorted shortlist, then greedy NMS with *per-class*
     suppression at IoU > iou_threshold: the ``fixpoint`` or ``scan``
     engine, or the CUDA kernel (``ops.cuda_nms``) when
     ``cfg.use_pallas_nms`` is set and the tensors are on CUDA
  5. score-sorted survivors as zero-padded (y1, x1, y2, x2, classid, conf)
     rows, [B, max_detection, 6]

The JAX package vmaps per-image functions over the batch; here every
function takes the batch dimension written out.  ``lax.top_k``'s tie
order (lowest index first) is kept with a stable descending sort:
``torch.topk`` promises no tie order on CUDA.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.ops import boxes as box_ops
from dis_yolo_tpu_torch.ops.cuda_nms import nms_cuda
from dis_yolo_tpu_torch.ops.decode import ScalePrediction

_NEG_INF = float("-inf")


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: ties keep the lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def flatten_predictions(preds: Sequence[ScalePrediction]):
    """Concatenate the 3 scales into flat per-anchor tensors.

    Returns (conf [B,N], class_prob [B,N,C], boxes_cxcywh [B,N,4]).
    """
    confs, probs, coords = [], [], []
    for p in preds:
        b = p.conf_logit.shape[0]
        confs.append(torch.sigmoid(p.conf_logit[..., 0]).reshape(b, -1))
        c = p.class_logit.shape[-1]
        probs.append(torch.softmax(p.class_logit, dim=-1).reshape(b, -1, c))
        coords.append(p.norm_coord.reshape(b, -1, 4))
    return torch.cat(confs, 1), torch.cat(probs, 1), torch.cat(coords, 1)


def _select_suppress_nms(boxes: torch.Tensor, scores: torch.Tensor,
                         classids: torch.Tensor, valid: torch.Tensor,
                         iou_thresh: float, max_det: int) -> torch.Tensor:
    """Class-aware greedy NMS as ``max_det`` select-and-suppress rounds.

    boxes [B,K,4] yxyx, scores [B,K], classids [B,K], valid [B,K] ->
    kept indices [B,max_det] (int64) in descending-score order, -1 padded.
    Each round's argmax over the alive scores (lowest index on ties) is
    exactly the next greedy survivor.  This is also the plain version of
    the CUDA kernel K2.
    """
    iou = box_ops.iou_matrix_yxyx(boxes, boxes)                   # [B,K,K]
    suppress = (iou > iou_thresh) & (classids[:, :, None] == classids[:, None, :])
    bsz, k = scores.shape
    rows = torch.arange(bsz, device=scores.device)
    idx = torch.arange(k, device=scores.device)
    alive = valid.bool()
    picked = []
    for _ in range(max_det):
        s = torch.where(alive, scores, _NEG_INF)
        j = torch.argmax(s, dim=-1)                                 # [B]
        ok = s[rows, j] > _NEG_INF
        alive = alive & ~suppress[rows, j] & (idx[None] != j[:, None])
        alive = alive & ok[:, None]
        picked.append(torch.where(ok, j, -1))
    return torch.stack(picked, dim=-1)


def _select_suppress_nms_full(boxes: torch.Tensor, scores: torch.Tensor,
                              classids: torch.Tensor, valid: torch.Tensor,
                              iou_thresh: float, max_det: int) -> torch.Tensor:
    """Exact greedy NMS over the FULL candidate set, matrix-free: the
    winner's IoU row is computed each round (O(N) per round), so it scales
    to every anchor of a 576 px image.  The lossless fallback when the
    top-K shortlist underfills."""
    bsz, n = scores.shape
    rows = torch.arange(bsz, device=scores.device)
    idx = torch.arange(n, device=scores.device)
    alive = valid.bool()
    picked = []
    for _ in range(max_det):
        s = torch.where(alive, scores, _NEG_INF)
        j = torch.argmax(s, dim=-1)
        ok = s[rows, j] > _NEG_INF
        row = box_ops.iou_matrix_yxyx(boxes[rows, j][:, None], boxes)[:, 0]
        suppress = (row > iou_thresh) & (classids == classids[rows, j][:, None])
        alive = alive & ~suppress & (idx[None] != j[:, None]) & ok[:, None]
        picked.append(torch.where(ok, j, -1))
    return torch.stack(picked, dim=-1)


def _fixpoint_nms(boxes: torch.Tensor, scores: torch.Tensor,
                  classids: torch.Tensor, valid: torch.Tensor,
                  iou_thresh: float, max_det: int) -> torch.Tensor:
    """Exact greedy NMS as a convergence iteration.

    The keep set is the unique fixpoint of ``kept[i] = valid[i] and no
    kept j that beats i suppresses i``; sweeps repeat until nothing
    changes (~suppression-chain depth).  Same -1-padded descending-score
    indices as ``_select_suppress_nms``.
    """
    iou = box_ops.iou_matrix_yxyx(boxes, boxes)
    same_class = classids[:, :, None] == classids[:, None, :]
    k = scores.shape[1]
    idx = torch.arange(k, device=scores.device)
    # j beats i: higher score, or equal score and lower index
    beats = (scores[:, :, None] > scores[:, None, :]) | (
        (scores[:, :, None] == scores[:, None, :])
        & (idx[:, None] < idx[None, :]))
    suppress = (iou > iou_thresh) & same_class & beats             # [B,j,i]
    valid = valid.bool()

    def sweep(kept):
        return valid & ~torch.any(suppress & kept[:, :, None], dim=1)

    kept, prev = sweep(valid), valid
    # host-checked loop (the JAX while_loop): one device sync per sweep
    while bool(torch.any(kept != prev)):
        kept, prev = sweep(kept), kept

    kk = min(max_det, k)
    top_score, top_idx = _top_k(torch.where(kept, scores, _NEG_INF), kk)
    picked = torch.where(top_score > _NEG_INF, top_idx, -1)
    if kk < max_det:
        picked = torch.nn.functional.pad(picked, (0, max_det - kk), value=-1)
    return picked


def _score_class_boxes(conf, class_prob, coord_cxcywh, windows):
    """Shared head: per-candidate score/class/clipped boxes, [B,N,...]."""
    class_max, classid = torch.max(class_prob, dim=-1)
    score = conf * class_max                                          # [B,N]
    boxes = box_ops.clip_boxes(box_ops.cxcywh_to_yxyx(coord_cxcywh), windows)
    return score, classid.to(torch.int32), boxes


def _rows_from_picked(picked, boxes, classid, score):
    """-1-padded candidate indices [B,D] -> zero-padded [B,D,6] rows."""
    safe = picked.clamp_min(0)
    det = torch.cat([
        torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4)),
        torch.gather(classid, 1, safe).float()[..., None],
        torch.gather(score, 1, safe)[..., None],
    ], dim=-1)
    return torch.where((picked >= 0)[..., None], det, 0.0)


def _shortlist_nms(conf, class_prob, coord_cxcywh, windows,
                   cfg: DISYoloConfig, obj_thresh):
    """Top-K shortlist NMS (``_shortlist_nms_single`` with the batch
    written out) -> ([B,D,6] detections, [B] shortfall flags).

    Greedy NMS is prefix-stable in score order, so the shortlist result
    equals unbounded NMS unless it underfilled ``max_detection`` while more
    than K candidates were above threshold; the flag marks that case.
    """
    score, classid, boxes = _score_class_boxes(conf, class_prob,
                                               coord_cxcywh, windows)
    valid = score > obj_thresh
    k = min(cfg.pre_nms_top_k, score.shape[1])
    top_score, top_idx = _top_k(torch.where(valid, score, -1.0), k)
    top_score = top_score.contiguous()
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_class = torch.gather(classid, 1, top_idx)
    top_valid = top_score > obj_thresh

    d = cfg.max_detection
    if cfg.use_pallas_nms and top_boxes.is_cuda:
        picked_local = nms_cuda(top_boxes, top_score, top_class, top_valid,
                                d, cfg.iou_threshold)
    elif cfg.nms_engine == "fixpoint":
        picked_local = _fixpoint_nms(top_boxes, top_score, top_class,
                                     top_valid, cfg.iou_threshold, d)
    else:
        picked_local = _select_suppress_nms(top_boxes, top_score, top_class,
                                            top_valid, cfg.iou_threshold, d)
    # map shortlist picks back to full-array candidate indices
    picked = torch.where(picked_local >= 0,
                         torch.gather(top_idx, 1, picked_local.clamp_min(0)),
                         -1)
    shortfall = torch.any(picked_local < 0, dim=-1) & (valid.sum(-1) > k)
    return _rows_from_picked(picked, boxes, classid, score), shortfall


def _full_nms(conf, class_prob, coord_cxcywh, windows, cfg: DISYoloConfig,
              obj_thresh):
    """Exact unbounded-candidate pass (``_full_nms_single`` batched)."""
    score, classid, boxes = _score_class_boxes(conf, class_prob,
                                               coord_cxcywh, windows)
    picked = _select_suppress_nms_full(boxes, score, classid,
                                       score > obj_thresh, cfg.iou_threshold,
                                       cfg.max_detection)
    return _rows_from_picked(picked, boxes, classid, score)


def filter_candidates(conf: torch.Tensor, class_prob: torch.Tensor,
                      coord_cxcywh: torch.Tensor, windows: torch.Tensor,
                      cfg: DISYoloConfig, obj_thresh) -> torch.Tensor:
    """Flat candidates -> [B,D,6]: [B,N] conf, [B,N,C] probs, [B,N,4]
    cxcywh, [B,4] windows.  Lossless for any ``pre_nms_top_k``: images
    whose shortlist underfilled take the exact full-candidate pass."""
    dets, shortfall = _shortlist_nms(conf, class_prob, coord_cxcywh,
                                     windows, cfg, obj_thresh)
    # host-checked batch-level fallback (the JAX lax.cond): one device sync
    if bool(torch.any(shortfall)):
        full = _full_nms(conf, class_prob, coord_cxcywh, windows, cfg,
                         obj_thresh)
        dets = torch.where(shortfall[:, None, None], full, dets)
    return dets


def filter_detections(preds: Sequence[ScalePrediction], windows: torch.Tensor,
                      cfg: DISYoloConfig, obj_thresh=None) -> torch.Tensor:
    """Batched detection head: ScalePredictions + [B,4] windows -> [B,D,6]."""
    if obj_thresh is None:
        obj_thresh = cfg.obj_threshold
    conf, prob, coord = flatten_predictions(preds)
    return filter_candidates(conf, prob, coord, windows, cfg, obj_thresh)
