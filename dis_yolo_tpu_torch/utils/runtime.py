"""Runtime helpers (PyTorch counterpart of the parts of
``dis_yolo_tpu/utils/runtime.py`` the serving path needs)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def calibrate_threshold(model, images, cfg,
                        min_survivors: Optional[int] = None) -> float:
    """Detection threshold making the pipeline carry a full detection load.

    Benchmarks on untrained weights need a threshold that reproduces the
    candidate regime of a trained net at the reference's 0.25 cut: a
    near-zero threshold declares every anchor valid (a pathological NMS
    load that trips the exact full-candidate fallback), a high one empties
    the detection slots and flatters the masking stages.  Runs one
    forward, computes the class-specific confidence (sigmoid(obj) * max
    softmax class) and picks the smallest candidate count whose host
    greedy per-class NMS yields >= ``min_survivors`` (default
    ``cfg.max_detection``).  Returns that count's score as threshold.
    ``images`` must lie on the model's device.

    The forward runs in eval mode (running BN statistics, none updated),
    whatever mode the model is in; the model is handed back in the mode
    it came in.
    """
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.ops.decode import decode_all

    min_survivors = min_survivors or cfg.max_detection
    was_training = model.training
    try:
        raws = api.forward(model, images, next(model.parameters()).device)
    finally:
        model.train(was_training)
    preds = decode_all(raws[:3], cfg)
    confs, probs, boxes = [], [], []
    for p in preds:
        r = p.conf_logit.float().cpu().numpy()[..., 0]
        confs.append((1.0 / (1.0 + np.exp(-r))).reshape(-1))
        logits = p.class_logit.float().cpu().numpy()
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        prob = e / e.sum(axis=-1, keepdims=True)
        probs.append(prob.reshape(-1, prob.shape[-1]))
        cx = p.norm_coord.float().cpu().numpy().reshape(-1, 4)
        y1 = cx[:, 1] - cx[:, 3] / 2
        x1 = cx[:, 0] - cx[:, 2] / 2
        boxes.append(np.stack([y1, x1, y1 + cx[:, 3], x1 + cx[:, 2]], 1))
    prob = np.concatenate(probs)
    score = np.concatenate(confs) * prob.max(-1)
    cls = prob.argmax(-1)
    box = np.clip(np.concatenate(boxes), 0.0, 1.0)
    order = np.argsort(-score, kind="stable")

    def survivors(n):
        keep = []
        for i in order[:n]:
            a = box[i]
            ok = True
            for j in keep:
                if cls[j] != cls[i]:
                    continue
                b = box[j]
                ih = min(a[2], b[2]) - max(a[0], b[0])
                iw = min(a[3], b[3]) - max(a[1], b[1])
                if ih <= 0 or iw <= 0:
                    continue
                inter = ih * iw
                ua = ((a[2] - a[0]) * (a[3] - a[1])
                      + (b[2] - b[0]) * (b[3] - b[1]) - inter)
                if ua > 0 and inter / ua > cfg.iou_threshold:
                    ok = False
                    break
            if ok:
                keep.append(i)
                if len(keep) >= min_survivors:
                    return len(keep)
        return len(keep)

    n = 64
    while n < min(score.size, cfg.pre_nms_top_k):
        if survivors(n) >= min_survivors:
            break
        n *= 2
    n = min(n, score.size - 1)
    return float(np.sort(score)[::-1][n])
