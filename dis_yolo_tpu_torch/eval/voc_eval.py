"""Mask-level VOC AP evaluation (host numpy; a copy of
``dis_yolo_tpu/eval/voc_eval.py``).

Mask-IoU matrix by flatten+dot, greedy confidence-sorted TP/FP matching
with per-GT once-only assignment, AP as the area under the interpolated
precision envelope (with the 11-point VOC-2007 variant available).
Detections arrive in one of three forms, which score identically: a
bool mask, a bit-packed mask (popcount IoU) or an IoU row computed on
the card (``ops.paste.mask_iou_single``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# byte -> set-bit count, for mask IoU on bit-packed masks (8 px/byte)
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                      axis=1).sum(axis=1).astype(np.uint16)


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP from recall/precision arrays."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def compute_overlaps_masks(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """IoU between two mask sets stored [H, W, N]."""
    if masks1.shape[-1] == 0 or masks2.shape[-1] == 0:
        return np.zeros((masks1.shape[-1], masks2.shape[-1]))
    m1 = np.reshape(masks1 > 0.5, (-1, masks1.shape[-1])).astype(np.float32)
    m2 = np.reshape(masks2 > 0.5, (-1, masks2.shape[-1])).astype(np.float32)
    area1 = m1.sum(axis=0)
    area2 = m2.sum(axis=0)
    inter = m1.T @ m2
    union = area1[:, None] + area2[None, :] - inter
    return inter / union


def packed_overlaps(det_packed: np.ndarray, gt_packed: np.ndarray,
                    gt_areas: np.ndarray) -> np.ndarray:
    """IoU of one bit-packed mask [H,Wb] against a packed stack [G,H,Wb].

    Popcount on the byte-wise AND — exact integer intersections, so the
    float32 division reproduces ``compute_overlaps_masks`` bit-for-bit
    (pixel counts < 2^24 are exact in float32) at 1/8 the host memory
    traffic and with no unpack pass.  Trailing pad bits are zero in both
    operands (np.packbits and ops.paste.pack_mask_bits both zero-pad).
    """
    inter = _POP8[det_packed[None] & gt_packed].sum(axis=(1, 2),
                                                    dtype=np.int64)
    det_area = int(_POP8[det_packed].sum(dtype=np.int64))
    inter32 = inter.astype(np.float32)
    union32 = (det_area + gt_areas - inter).astype(np.float32)
    return inter32 / union32


def _packed_gt(rec: Dict) -> None:
    """Lazily bit-pack a class_rec's GT stack (once per image/class)."""
    if "packed" not in rec:
        gt = rec["mask"]                        # [H, W, G] bool
        stack = np.packbits(np.moveaxis(gt, -1, 0) > 0.5, axis=-1)
        rec["packed"] = stack                   # [G, H, ceil(W/8)]
        rec["areas"] = np.array([int(_POP8[m].sum(dtype=np.int64))
                                 for m in stack], np.int64)


def voc_eval(detections: List[Dict], gt_records: Dict[str, List[Dict]],
             imagenames: Sequence[str], classid: int, ovthresh: float = 0.5,
             use_07_metric: bool = False):
    """(recall, precision, ap) for one class.

    detections: [{'imageid', 'score', 'mask' bool[H,W]}, ...] — or, from
    the device-paste sweep, {'mask_packed' uint8[H,ceil(W/8)]} (bit-packed
    rows, np.packbits convention); the two forms score identically.
    gt_records: imageid -> [{'classid', 'difficult', 'mask'}, ...]
    Matching semantics of the reference's voc_eval_mask.py, including the
    strict ``ovmax > ovthresh`` comparison and double-detection -> FP.
    """
    class_recs = {}
    npos = 0
    for name in imagenames:
        objs = [o for o in gt_records[name] if o["classid"] == classid]
        if objs:
            gt_masks = np.stack([o["mask"] for o in objs], axis=-1)
        else:
            gt_masks = np.array([])
        difficult = np.asarray([o["difficult"] for o in objs], dtype=bool)
        npos += int(np.sum(~difficult))
        class_recs[name] = {"mask": gt_masks, "difficult": difficult,
                            "det": [False] * len(objs)}

    if not detections:
        return 0.0, 0.0, 0.0
    if npos == 0:
        # no GT of this class: every detection is a FP.  (The reference
        # divides by zero here and propagates NaN into the mAP mean;
        # deliberate deviation for robustness.)
        return 0.0, 0.0, 0.0
    order = np.argsort(-np.asarray([float(d["score"]) for d in detections]))
    dets = [detections[i] for i in order]

    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d, det in enumerate(dets):
        rec = class_recs[det["imageid"]]
        gt = rec["mask"]
        ovmax, jmax = -np.inf, -1
        if "iou_row" in det:
            # device-scored route: the IoU against this image's class-c GTs
            # was computed on the card (ops/paste.mask_iou_single), in the
            # same instance order: same float32 values as the mask routes
            row = det["iou_row"]
            if row.size > 0:
                ovmax = row.max()
                jmax = int(row.argmax())
        elif gt.size > 0:
            if "mask_packed" in det:
                _packed_gt(rec)
                overlaps = packed_overlaps(det["mask_packed"],
                                           rec["packed"], rec["areas"])
                ovmax = overlaps.max()
                jmax = int(overlaps.argmax())
            else:
                overlaps = compute_overlaps_masks(
                    det["mask"][..., None].astype(float), gt.astype(float))
                ovmax = overlaps[0].max()
                jmax = int(overlaps[0].argmax())
        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1.0
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    recall = tp[-1] / float(npos)
    precision = tp[-1] / np.maximum(tp[-1] + fp[-1], np.finfo(np.float64).eps)
    return float(recall), float(precision), float(ap)
