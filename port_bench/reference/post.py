"""What follows DIS-YOLO's network when it serves, in plain float32:
anchor decoding, class-aware greedy NMS, the degenerate-box drop, the
position-sensitive mask assembly and the paste to the photo's size.

Frozen copies of the port's plain versions (``ops/decode.py``,
``ops/boxes.py``, ``ops/nms.py``, ``ops/mask_assembly.py``,
``ops/paste.py`` and the post-forward half of ``models/api.py``), with
the same operations in the same order, so that on the same inputs and
device they give the same bits.  Departures:

  * NMS is greedy select-and-suppress, round by round (the port's plain
    version of its kernel K2), where the port serves with a fixpoint
    iteration; both are exact greedy NMS, lowest index first on ties;
  * the mask assembly is the gather formulation with the sigmoid taken
    inside the box and 0 outside, which is what the port's kernel K1
    computes;
  * no higher-order control flow: the shortlist's fallback to the full
    candidate set is a Python ``if``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

NEG_INF = float("-inf")


# ------------------------------------------------------------- decoding
def _decode_scale(raw, scale_idx, anchors, net_hw):
    grid_h, grid_w = raw.shape[1], raw.shape[2]
    dev = raw.device
    a = raw.shape[3]
    conf_logit = raw[..., 4:5]
    class_logit = raw[..., 5:]
    pred_cxy = 1.0 / (1.0 + torch.exp(-raw[..., :2]))
    pred_twh = raw[..., 2:4]
    ys, xs = torch.meshgrid(
        torch.arange(grid_h, dtype=torch.float32, device=dev),
        torch.arange(grid_w, dtype=torch.float32, device=dev), indexing="ij")
    offsets = torch.stack([xs, ys], dim=-1)[None, :, :, None, :]
    grid_factor = torch.tensor([grid_w, grid_h], dtype=torch.float32,
                               device=dev)
    net_factor = torch.tensor([net_hw[1], net_hw[0]], dtype=torch.float32,
                              device=dev)
    anc = torch.as_tensor(anchors[a * scale_idx: a * scale_idx + a],
                          dtype=torch.float32, device=dev)
    box_xy = (offsets + pred_cxy) / grid_factor
    box_wh = torch.exp(pred_twh) * anc[None, None, None] / net_factor
    return conf_logit, class_logit, torch.cat([box_xy, box_wh], dim=-1)


def candidates(raws: Sequence[torch.Tensor], anchors):
    """Raw heads (stride 8 first) -> (conf [B,N], class_prob [B,N,C],
    boxes_cxcywh [B,N,4]) over every anchor of the three scales."""
    net_hw = (raws[2].shape[1] * 32, raws[2].shape[2] * 32)
    confs, probs, coords = [], [], []
    for i, raw in enumerate(raws[:3]):
        conf_logit, class_logit, norm = _decode_scale(raw.float(), i, anchors,
                                                      net_hw)
        b = raw.shape[0]
        confs.append(torch.sigmoid(conf_logit[..., 0]).reshape(b, -1))
        c = class_logit.shape[-1]
        probs.append(torch.softmax(class_logit, dim=-1).reshape(b, -1, c))
        coords.append(norm.reshape(b, -1, 4))
    return torch.cat(confs, 1), torch.cat(probs, 1), torch.cat(coords, 1)


# ---------------------------------------------------------------- boxes
def cxcywh_to_yxyx(boxes):
    xc, yc, w, h = boxes.unbind(-1)
    return torch.stack([yc - h / 2.0, xc - w / 2.0, yc + h / 2.0,
                        xc + w / 2.0], dim=-1)


def clip_boxes(boxes, window):
    wy1, wx1, wy2, wx2 = (window[..., i, None] for i in range(4))
    y1 = torch.minimum(torch.maximum(boxes[..., 0], wy1), wy2)
    x1 = torch.minimum(torch.maximum(boxes[..., 1], wx1), wx2)
    y2 = torch.minimum(torch.maximum(boxes[..., 2], wy1), wy2)
    x2 = torch.minimum(torch.maximum(boxes[..., 3], wx1), wx2)
    return torch.stack([y1, x1, y2, x2], dim=-1)


def _iou(boxes1, boxes2):
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


# ------------------------------------------------------------------ NMS
def _greedy(boxes, scores, classids, valid, iou_thresh, max_det, full):
    """Greedy class-aware NMS as ``max_det`` select-and-suppress rounds:
    kept indices [B, max_det], -1 padded, in descending score order.
    ``full`` computes the winner's IoU row each round instead of the
    whole matrix (the port's pass over every candidate)."""
    bsz, k = scores.shape
    rows = torch.arange(bsz, device=scores.device)
    idx = torch.arange(k, device=scores.device)
    if not full:
        iou = _iou(boxes, boxes)
        suppress = (iou > iou_thresh) & (classids[:, :, None]
                                         == classids[:, None, :])
    alive = valid.bool()
    picked = []
    for _ in range(max_det):
        s = torch.where(alive, scores, NEG_INF)
        j = torch.argmax(s, dim=-1)
        ok = s[rows, j] > NEG_INF
        if full:
            row = _iou(boxes[rows, j][:, None], boxes)[:, 0]
            sup = (row > iou_thresh) & (classids == classids[rows, j][:, None])
        else:
            sup = suppress[rows, j]
        alive = alive & ~sup & (idx[None] != j[:, None]) & ok[:, None]
        picked.append(torch.where(ok, j, -1))
    return torch.stack(picked, dim=-1)


def _top_k(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rows(picked, boxes, classid, score):
    safe = picked.clamp_min(0)
    det = torch.cat([
        torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4)),
        torch.gather(classid, 1, safe).float()[..., None],
        torch.gather(score, 1, safe)[..., None]], dim=-1)
    return torch.where((picked >= 0)[..., None], det, 0.0)


def detections(raws, windows, obj_thresh: float, anchors, iou_thresh: float,
               max_det: int, top_k: int) -> torch.Tensor:
    """Raw heads + windows [B,4] -> [B, max_det, 6] rows (y1, x1, y2,
    x2, class, score), score-sorted, zero padded, degenerate boxes
    dropped: what the port's ``predict`` returns as detections."""
    conf, class_prob, coord = candidates(raws, anchors)
    class_max, classid = torch.max(class_prob, dim=-1)
    score = conf * class_max
    classid = classid.to(torch.int32)
    boxes = clip_boxes(cxcywh_to_yxyx(coord), windows.float())
    valid = score > obj_thresh
    k = min(top_k, score.shape[1])
    top_score, top_idx = _top_k(torch.where(valid, score, -1.0), k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_class = torch.gather(classid, 1, top_idx)
    local = _greedy(top_boxes, top_score.contiguous(), top_class,
                    top_score > obj_thresh, iou_thresh, max_det, full=False)
    picked = torch.where(local >= 0,
                         torch.gather(top_idx, 1, local.clamp_min(0)), -1)
    dets = _rows(picked, boxes, classid, score)
    shortfall = torch.any(local < 0, dim=-1) & (valid.sum(-1) > k)
    if bool(shortfall.any()):
        full = _rows(_greedy(boxes, score, classid, valid, iou_thresh,
                             max_det, full=True), boxes, classid, score)
        dets = torch.where(shortfall[:, None, None], full, dets)
    s = raws[3].shape[1]
    boxes_px = torch.round(dets[..., :4] * s)
    nondegenerate = ((boxes_px[..., 2] - boxes_px[..., 0] > 0)
                     & (boxes_px[..., 3] - boxes_px[..., 1] > 0))
    keep = torch.any(dets[..., :4] != 0.0, dim=-1) & nondegenerate
    return dets * keep[..., None]


# -------------------------------------------------------- mask assembly
def _grid_lines(lo, hi, k):
    sub = (hi - lo) / k
    inner = [torch.round(lo + i * sub) for i in range(1, k)]
    return torch.stack([lo] + inner + [hi], dim=-1).to(torch.int32)


def _bins(size, lines, k):
    pos = torch.arange(size, dtype=torch.int32, device=lines.device)
    lines = lines[..., None]
    b = torch.zeros(lines.shape[:-2] + (size,), dtype=torch.int32,
                    device=lines.device)
    for i in range(1, k):
        b = b + (pos >= lines[..., i, :]).to(torch.int32)
    inside = (pos >= lines[..., 0, :]) & (pos < lines[..., k, :])
    return torch.clamp(b, max=k - 1), inside


def assemble(scoremaps: torch.Tensor, boxes_norm: torch.Tensor, k: int):
    """Score maps [B,S,S,k^2] + normalized yxyx boxes [B,D,4] -> masks
    [B,D,S,S]: inside each box rounded to score-map pixels, pixel (r, c)
    reads channel ``row_bin * k + col_bin`` through a sigmoid; 0
    outside.  A zero box gives an empty mask."""
    bsz, s = scoremaps.shape[0], scoremaps.shape[1]
    d = boxes_norm.shape[1]
    px = torch.round(boxes_norm.float() * s)
    gy = _grid_lines(px[..., 0], px[..., 2], k)
    gx = _grid_lines(px[..., 1], px[..., 3], k)
    row_bin, row_in = _bins(s, gy, k)
    col_bin, col_in = _bins(s, gx, k)
    out = torch.empty((bsz, d, s, s), dtype=torch.float32,
                      device=scoremaps.device)
    for i in range(d):          # one detection at a time keeps it small
        kidx = row_bin[:, i, :, None] * k + col_bin[:, i, None, :]
        inside = row_in[:, i, :, None] & col_in[:, i, None, :]
        logit = torch.gather(scoremaps.float(), -1,
                             kidx[..., None].long())[..., 0]
        out[:, i] = torch.where(inside, 1.0 / (1.0 + torch.exp(-logit)), 0.0)
    return out


# ----------------------------------------------------------------- paste
def letterbox_params(image_h, image_w, net_h, net_w):
    if (float(net_w) / image_w) < (float(net_h) / image_h):
        new_w = net_w
        new_h = (image_h * net_w) // image_w
    else:
        new_h = net_h
        new_w = (image_w * net_h) // image_h
    return (float((net_w - new_w) // 2) / net_w, float(new_w) / net_w,
            float((net_h - new_h) // 2) / net_h, float(new_h) / net_h)


def original_boxes(boxes_norm, image_h, image_w, net):
    """Normalized letterboxed yxyx -> int32 boxes in the photo's pixels."""
    x_off, x_scale, y_off, y_scale = letterbox_params(image_h, image_w,
                                                      net, net)
    y = torch.round((boxes_norm[..., [0, 2]] - y_off) / y_scale * image_h)
    x = torch.round((boxes_norm[..., [1, 3]] - x_off) / x_scale * image_w)
    y = torch.clamp(y, 0, image_h).to(torch.int32)
    x = torch.clamp(x, 0, image_w).to(torch.int32)
    return torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], dim=-1)


def _axis_matrix(out_size, lo_px, hi_px, crop_lo, crop_hi, mask_size):
    pos = torch.arange(out_size, dtype=torch.int32, device=lo_px.device)
    lo, hi = lo_px[..., None], hi_px[..., None]
    c_lo, c_hi = crop_lo[..., None], crop_hi[..., None]
    inside = (pos >= lo) & (pos < hi)
    box_len = torch.clamp_min(hi - lo, 1)
    crop_len = c_hi - c_lo
    dst = (pos - lo).float()
    src = (dst + 0.5) * crop_len.float() / box_len.float() - 0.5
    hi_tap = torch.clamp_min(crop_len - 1, 0)
    i0 = torch.minimum(torch.clamp_min(torch.floor(src).to(torch.int32), 0),
                       hi_tap)
    i1 = torch.minimum(torch.clamp_min(i0 + 1, 0), hi_tap)
    w = torch.clamp(src - i0.float(), 0.0, 1.0)
    i0 = torch.clamp(c_lo + i0, 0, mask_size - 1)
    i1 = torch.clamp(c_lo + i1, 0, mask_size - 1)
    inside = inside & (crop_len > 0)
    iota = torch.arange(mask_size, dtype=torch.int32, device=lo_px.device)
    m = ((iota == i0[..., None]) * (1.0 - w)[..., None]
         + (iota == i1[..., None]) * w[..., None])
    return m * inside[..., None]


def paste(masks: torch.Tensor, dets: torch.Tensor, image_h: int,
          image_w: int, net: int) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Masks [B,D,S,S] + detections [B,D,6] -> (bool [B,D,H0,W0] masks
    in the photo's pixels, valid [B,D], semantic map [B,H0,W0] uint8):
    crop each mask to its box, resize it bilinearly (half-pixel centres,
    edges clamped) as a product of two tap matrices in float32, keep
    > 0.5; later detections paint over earlier ones, class + 1."""
    s = masks.shape[-1]
    box_px = original_boxes(dets[..., :4], image_h, image_w, net)
    valid = (dets[..., 5] > 0.0) & (
        (box_px[..., 2] - box_px[..., 0]) * (box_px[..., 3] - box_px[..., 1])
        > 0)
    crop = torch.round(dets[..., :4].float() * s).to(torch.int32)
    rowm = _axis_matrix(image_h, box_px[..., 0], box_px[..., 2],
                        crop[..., 0], crop[..., 2], s)
    colm = _axis_matrix(image_w, box_px[..., 1], box_px[..., 3],
                        crop[..., 1], crop[..., 3], s)
    full = torch.matmul(torch.matmul(rowm, masks), colm.transpose(-1, -2))
    full = (full > 0.5) & valid[..., None, None]
    d = full.shape[-3]
    cls = torch.clamp(dets[..., 4].to(torch.int32), 0, 255)
    order = torch.arange(1, d + 1, dtype=torch.int32, device=cls.device)
    enc = ((order * 256 + cls) * valid.to(torch.int32))[..., None, None]
    win = torch.amax(torch.where(full, enc, 0), dim=-3)
    sem = torch.where(win > 0, (win & 255) + 1, 0).to(torch.uint8)
    return full, valid, sem
