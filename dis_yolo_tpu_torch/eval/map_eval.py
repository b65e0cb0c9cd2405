"""Dataset-level evaluation: mask mAP@0.5 and the 4-class mIoU (host
numpy; the counterpart of ``dis_yolo_tpu/eval/map_eval.py``).

  * ground truth: rasterized instance masks per image (cached on disk
    as ``cache/gt_rasterized_<phase>.pkl``) and, for the test path, a
    merged semantic map (classes painted 1..3 in region order);
  * ``evaluate_detections``: network outputs -> original-size masks ->
    per-class VOC AP -> mAP;
  * ``miou``: pixel confusion totals over {bg, crack, spall, rebar} ->
    per-class IoU and their mean (the reference's union is
    col_sum + row_sum - diag).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import rasterize
from dis_yolo_tpu_torch.eval.postprocess import detections_to_original
from dis_yolo_tpu_torch.eval.voc_eval import voc_eval


class Evaluator:
    """Holds rasterized GT for one split and scores detection sets."""

    def __init__(self, cfg: DISYoloConfig, phase: str = "val",
                 with_semantic: bool = False, annotations=None,
                 index: Optional[List[str]] = None, use_cache: bool = True):
        self.cfg = cfg
        self.phase = phase
        self.with_semantic = with_semantic
        self.class_to_ind = cfg.class_to_ind()
        from_disk = annotations is None
        if from_disk:
            cache = self._gt_cache_path() if use_cache else None
            if cache and os.path.isfile(cache):
                # rasterized-GT disk cache; an unreadable one (e.g.
                # truncated by a crash mid-write) is rebuilt
                try:
                    with open(cache, "rb") as f:
                        blob = pickle.load(f)
                except Exception:
                    blob = None
                if blob is not None and (not self.with_semantic
                                         or blob["gt_semantic"]):
                    self.index = blob["index"]
                    self.gt_masks = blob["gt_masks"]
                    self.gt_semantic = blob["gt_semantic"]
                    self.gt_sizes = blob["gt_sizes"]
                    return
            annotations, index = self._load_annotations(use_cache)
        self.index = list(index)
        (self.gt_masks, self.gt_semantic, self.gt_sizes) = \
            self._rasterize_groundtruth(annotations)
        if from_disk and use_cache:
            cache = self._gt_cache_path()
            if cache:
                try:
                    with open(cache, "wb") as f:
                        pickle.dump({"index": self.index,
                                     "gt_masks": self.gt_masks,
                                     "gt_semantic": self.gt_semantic,
                                     "gt_sizes": self.gt_sizes}, f)
                except OSError:
                    pass

    def _gt_cache_path(self):
        cache_dir = os.path.join(self.cfg.data_path(self.phase), "cache")
        if not os.path.isdir(cache_dir):
            return None
        return os.path.join(cache_dir, f"gt_rasterized_{self.phase}.pkl")

    # ------------------------------------------------------------------
    def _load_annotations(self, use_cache: bool):
        split_dir = self.cfg.data_path(self.phase)
        cache_dir = os.path.join(split_dir, "cache")
        with open(os.path.join(cache_dir, "ground_truth_cache.pkl"), "rb") as f:
            annotations = pickle.load(f)
        annotations = [a for a in annotations if a["regions"]]
        with open(os.path.join(cache_dir, f"{self.phase}.txt")) as f:
            index = [x.strip() for x in f.readlines()]
        assert len(index) == len(annotations)
        return annotations, index

    def _rasterize_groundtruth(self, annotations):
        gt_masks: Dict[str, List[Dict]] = {}
        gt_semantic: Dict[str, np.ndarray] = {}
        gt_sizes: Dict[str, Tuple[int, int]] = {}
        for stem, a in zip(self.index, annotations):
            assert os.path.splitext(a["filename"])[0] == stem
            h, w = a["size"]
            regions = list(a["regions"].values())
            merged = np.zeros((h, w), np.uint8) if self.with_semantic else None
            labels = []
            for r in regions:
                mask = rasterize.instance_mask(r["shape_attributes"], h, w)
                if not mask.any():
                    continue
                cid = self.class_to_ind[r["region_attributes"]]
                labels.append({"imageid": stem, "classid": cid,
                               "difficult": 0, "mask": mask})
                if merged is not None:
                    merged[mask] = cid + 1
            gt_masks[stem] = labels
            if merged is not None:
                gt_semantic[stem] = merged
            gt_sizes[stem] = (h, w)
        return gt_masks, gt_semantic, gt_sizes

    # ------------------------------------------------------------------
    def evaluate_detections(self, detdata: List[Dict],
                            collect_semantic: bool = False):
        """Score a full detection sweep.

        detdata: [{'imname', 'boxes' [D,6], 'masks' [D,S,S]}] aligned with
        ``self.index``.  Returns {'AP': [c], 'mAP', 'recall', 'precision',
        't_post_s'} plus per-image semantic maps when requested (for
        mIoU).  ``t_post_s`` is the host crop/resize/paste time, the stage
        the reference times apart from the device's predict.

        Entries may instead carry outputs pasted on the card
        (``ops.paste.paste_masks_batch``): 'full_masks' [D,H,W] bool or
        'full_masks_packed' [D,H,ceil(W/8)] uint8 (np.packbits rows, fed
        straight to the popcount IoU), plus 'valid' [D], 'semantic' [H,W]
        uint8, which skip ``detections_to_original``; or the IoU matrix
        scored on the card, 'iou' [D,G] with 'valid' [D] (and
        'confusion' [n,n] for ``miou_from_confusions``).
        """
        import time
        assert len(detdata) == len(self.index)
        per_class: Dict[int, List[Dict]] = {c: [] for c in
                                            range(self.cfg.num_class)}
        semantic_maps: Dict[str, np.ndarray] = {}
        t_post0 = time.time()
        for i, det in enumerate(detdata):
            stem = det["imname"]
            assert stem == self.index[i]
            h, w = self.gt_sizes[stem]
            if "iou" in det:                  # device-scored IoU matrix
                if collect_semantic and "confusion" not in det:
                    raise ValueError(
                        "collect_semantic: device-scored entries carry no "
                        "semantic map — use the device_paste/host sweep "
                        "route, or pass gt_semantic to run_split for "
                        "device confusion totals (miou_from_confusions)")
                # sweep route ``device_score``: columns are this image's GT
                # instances in self.gt_masks order; slice per class so the
                # row a detection carries lines up with voc_eval's per-class
                # GT records (identical float32 values to the mask routes)
                boxes = np.asarray(det["boxes"])
                iou = np.asarray(det["iou"])
                valid = np.asarray(det["valid"])
                gt_cls = np.asarray([o["classid"]
                                     for o in self.gt_masks[stem]], np.int64)
                cols = {c: np.where(gt_cls == c)[0]
                        for c in range(self.cfg.num_class)}
                for k in range(iou.shape[0]):
                    if not valid[k]:
                        continue
                    c = int(boxes[k, 4])
                    per_class[c].append(
                        {"imageid": stem, "score": float(boxes[k, 5]),
                         "iou_row": iou[k, cols[c]]})
                continue
            if "full_masks_packed" in det:    # pasted on the card, packed
                # stays packed all the way into voc_eval's popcount IoU
                boxes = np.asarray(det["boxes"])
                packed = np.asarray(det["full_masks_packed"])
                valid = np.asarray(det["valid"])
                assert packed.shape[1] == h and packed.shape[2] == -(-w // 8)
                for k in range(packed.shape[0]):
                    if not valid[k]:
                        continue
                    per_class[int(boxes[k, 4])].append(
                        {"imageid": stem, "score": float(boxes[k, 5]),
                         "mask_packed": packed[k]})
                if collect_semantic:
                    semantic_maps[stem] = np.asarray(det["semantic"])
                continue
            if "full_masks" in det:           # pasted on the card
                boxes = np.asarray(det["boxes"])
                full = np.asarray(det["full_masks"])
                valid = np.asarray(det["valid"])
                assert full.shape[1:] == (h, w)
                for k in range(full.shape[0]):
                    if not valid[k]:
                        continue
                    per_class[int(boxes[k, 4])].append(
                        {"imageid": stem, "score": float(boxes[k, 5]),
                         "mask": full[k]})
                if collect_semantic:
                    semantic_maps[stem] = np.asarray(det["semantic"])
                continue
            merged = np.zeros((h, w), np.uint8) if collect_semantic else None
            if np.sum(det["masks"]) != 0.0:
                insts = detections_to_original(
                    np.asarray(det["boxes"]), np.asarray(det["masks"]),
                    h, w, self.cfg.test_size, merged)
                for inst in insts:
                    per_class[inst["classid"]].append(
                        {"imageid": stem, "score": inst["score"],
                         "mask": inst["mask"]})
            if merged is not None:
                semantic_maps[stem] = merged
        # host crop/resize/binarize/paste time; ~0 when detdata came
        # pasted or scored on the card
        t_post = time.time() - t_post0

        aps, recalls, precisions = [], [], []
        for c in range(self.cfg.num_class):
            if not per_class[c]:
                recalls.append(0.0)
                precisions.append(0.0)
                aps.append(0.0)
                continue
            r, p, ap = voc_eval(per_class[c], self.gt_masks, self.index, c,
                                ovthresh=0.5, use_07_metric=False)
            recalls.append(r)
            precisions.append(p)
            aps.append(ap)

        result = {"AP": aps, "mAP": float(np.mean(aps)),
                  "recall": float(np.mean(recalls)),
                  "precision": float(np.mean(precisions)),
                  "t_post_s": t_post}
        if collect_semantic:
            result["semantic_maps"] = semantic_maps
        return result

    # ------------------------------------------------------------------
    def miou(self, pred_semantic: Dict[str, np.ndarray]):
        """4-class (background included) pixel IoU and mIoU from the
        confusion totals of the predicted semantic maps."""
        assert self.with_semantic, "Evaluator(with_semantic=True) required"
        n = self.cfg.num_class + 1
        conf = np.zeros((n, n), np.int64)     # conf[true, pred]
        for stem in self.index:
            t = self.gt_semantic[stem]
            p = pred_semantic[stem]
            assert t.shape == p.shape
            # one O(H*W) bincount pass per image over joint labels n*t+p
            joint = t.astype(np.int64).ravel() * n + p.astype(np.int64).ravel()
            conf += np.bincount(joint, minlength=n * n).reshape(n, n)
        return self._iou_from_confusion(conf)

    def miou_from_confusions(self, confusions: Dict[str, np.ndarray]):
        """mIoU from per-image [n,n] confusion totals computed on the card
        (``ops.paste.semantic_confusion`` in the sweep's ``device_score``
        route): integer-exact, so equal to ``miou`` on the fetched maps,
        with no per-pixel semantic map fetched."""
        assert self.with_semantic, "Evaluator(with_semantic=True) required"
        n = self.cfg.num_class + 1
        conf = np.zeros((n, n), np.int64)
        for stem in self.index:
            c = np.asarray(confusions[stem], np.int64)
            assert c.shape == (n, n)
            conf += c
        return self._iou_from_confusion(conf)

    @staticmethod
    def _iou_from_confusion(conf: np.ndarray):
        n = conf.shape[0]
        ious = []
        for c in range(n):
            inter = conf[c, c]
            union = conf[:, c].sum() + conf[c, :].sum() - inter
            ious.append(inter / union if union > 0 else 0.0)
        return {"iou": [float(x) for x in ious], "miou": float(np.mean(ious))}
