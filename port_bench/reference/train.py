"""DIS-YOLO's training step in plain float32: the train-mode forward with
batch statistics, the YOLO loss, the mask loss, L2, the backward and
Adam, with the running statistics moved as Flax moves them.

Frozen copies of the port's plain forms (``models/layers.py`` train-mode
``ConvBN``, ``ops/decode.py``, ``losses/yolo_loss.py``,
``losses/mask_loss.py``, ``train/train_step.py``), rewritten for
reading; the network is ``net.Net``'s, its ``c`` in train mode.
Everything runs in float32 with TF32 off (``plain_float32``); the port
convolves in bfloat16.  ``hp`` holds the configuration's numbers as
plain values: ``anchors``, ``obj_threshold``, ``iou_threshold``,
``max_detection``, ``pre_nms_top_k``, ``k_map``, ``mask_scale``,
``l2_scale``, ``ignore_thresh``, ``object_scale``, ``noobject_scale``,
``class_scale``, ``coord_scale``, ``lr_boundaries``, ``lr_values``.

Departures:

  * the mask loss's proposals are the reference's decode and NMS
    (``post.py``, without serving's degenerate-box drop, as training
    takes them) run on the program's own raw outputs of that step, not
    on the reference's: which boxes NMS keeps is a discrete decision,
    and the reference follows the program's, as serving's ``det_diff``
    does;
  * the mask assembly is ``post.py``'s gather with the logits kept (no
    sigmoid) and autograd's scatter as its backward, where the port runs
    kernels K1 and K3;
  * BatchNorm normalizes as ``(y - mean) * (rsqrt(var + eps) * gamma) +
    beta`` on the biased variance ``max(E[y^2] - E[y]^2, 0)``, the
    port's form, on a float32 conv output.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from port_bench.reference import net as ref_net
from port_bench.reference import post as ref_post

BN_DECAY = 0.997
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
N_PROP, N_GT = 7, 3


# -------------------------------------------------------------- forward
class TrainNet(ref_net.Net):
    """``TrainNet(specs, weights)(images)`` -> the four raw outputs of a
    train-mode forward, differentiable in ``weights``; ``moments`` holds
    each BatchNorm layer's batch (mean, biased variance), detached."""

    def __init__(self, specs, weights: Dict[str, torch.Tensor]):
        super().__init__(specs, weights)
        self.moments: Dict[int, tuple] = {}

    def c(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        _, kind, _, _, _, stride = self.specs[idx]
        name = f"convolutional{idx}"
        w = self.w
        if kind == "bias":
            return ref_net._conv(x, w[f"{name}.conv.weight"],
                                 w[f"{name}.conv.bias"], stride)
        y = ref_net._conv(x, w[f"{name}.conv.weight"], None, stride)
        mean = y.mean((0, 2, 3))
        var = torch.clamp_min((y * y).mean((0, 2, 3)) - mean * mean, 0.0)
        self.moments[idx] = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + ref_net.BN_EPS) * w[f"{name}.bn.weight"]
        y = ((y - mean[:, None, None]) * mul[:, None, None]
             + w[f"{name}.bn.bias"][:, None, None])
        return torch.where(y > 0, y, ref_net.ALPHA * y)

    def __call__(self, images: torch.Tensor):
        # net.Net's topology, with autograd on (its __call__ is no_grad)
        return ref_net.Net.__call__.__wrapped__(self, images)


# ------------------------------------------------------------ YOLO loss
def _bce(labels, logits):
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def _offsets(h: int, w: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None, :, :, None, :]


def _iou_cxcywh(pred, true):
    p_min, p_max = pred[..., 0:2] - pred[..., 2:4] / 2.0, \
        pred[..., 0:2] + pred[..., 2:4] / 2.0
    t_min, t_max = true[..., 0:2] - true[..., 2:4] / 2.0, \
        true[..., 0:2] + true[..., 2:4] / 2.0
    inter_wh = (torch.minimum(p_max, t_max)
                - torch.maximum(p_min, t_min)).clamp_min(0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = (pred[..., 2] * pred[..., 3] + true[..., 2] * true[..., 3]
             - inter).clamp_min(1e-10)
    return torch.clamp(inter / union, 0.0, 1.0)


def yolo_loss(raws: Sequence[torch.Tensor], true_boxes: torch.Tensor,
              labels: Sequence[torch.Tensor], hp: dict
              ) -> Dict[str, torch.Tensor]:
    """conf, class and coord losses of the three heads (stride 8 first):
    raw heads [B, h, w, 3, 5 + C], true boxes [B, T, 5] normalized (xc,
    yc, w, h, class), label grids [B, h, w, 3, 5 + C]."""
    dev = raws[0].device
    net_w, net_h = raws[2].shape[2] * 32, raws[2].shape[1] * 32
    net_hw = torch.tensor([net_w, net_h], dtype=torch.float32, device=dev)
    true_xywh = true_boxes[:, None, None, None, :, :4]
    conf = cls = coord = torch.zeros((), device=dev)
    for i, raw in enumerate(raws[:3]):
        raw = raw.float()
        gh, gw = raw.shape[1], raw.shape[2]
        grid = torch.tensor([gw, gh], dtype=torch.float32, device=dev)
        anchors = torch.tensor(hp["anchors"][3 * i:3 * i + 3],
                               dtype=torch.float32, device=dev)
        conf_logit, class_logit = raw[..., 4:5], raw[..., 5:]
        cxy = 1.0 / (1.0 + torch.exp(-raw[..., :2]))
        twh = raw[..., 2:4]
        offs = _offsets(gh, gw, dev)
        box = torch.cat([(offs + cxy) / grid,
                         torch.exp(twh) * anchors[None, None, None] / net_hw],
                        -1)
        with torch.no_grad():
            best = _iou_cxcywh(box[..., None, :], true_xywh).max(-1).values
            ignore = (best < hp["ignore_thresh"]).float()[..., None]
        label = labels[i]
        obj = label[..., 4:5]
        bce = _bce(obj, conf_logit)
        obj_l = torch.mean(torch.sum(obj * bce * hp["object_scale"],
                                     dim=(1, 2, 3, 4)))
        noobj_l = torch.mean(torch.sum((1.0 - obj) * ignore * bce
                                       * hp["noobject_scale"],
                                       dim=(1, 2, 3, 4)))
        true_cls = torch.argmax(label[..., 5:], dim=-1)
        ce = (torch.logsumexp(class_logit, -1) - torch.gather(
            class_logit, -1, true_cls[..., None])[..., 0])[..., None]
        class_l = torch.mean(torch.sum(obj * ce * hp["class_scale"],
                                       dim=(1, 2, 3, 4)))
        true_cxy = label[..., 0:2] * grid - offs
        true_twh = torch.clamp(torch.log(
            torch.where(obj > 0, label[..., 2:4] * net_hw, 1.0)
            / anchors[None, None, None]), -1e2, 1e2)
        scale = torch.square((2.0 - label[..., 2] * label[..., 3])[..., None])
        xy_l = torch.mean(torch.sum(torch.square(obj * (cxy - true_cxy))
                                    * scale * hp["coord_scale"],
                                    dim=(1, 2, 3, 4)))
        wh_l = torch.mean(torch.sum(torch.square(obj * (twh - true_twh))
                                    * scale * hp["coord_scale"],
                                    dim=(1, 2, 3, 4)))
        conf = conf + (obj_l + noobj_l)
        cls = cls + class_l
        coord = coord + (xy_l + wh_l)
    return {"conf_loss": conf, "class_loss": cls, "coord_loss": coord}


# ------------------------------------------------------------ mask loss
def proposals(raws: Sequence[torch.Tensor], hp: dict) -> torch.Tensor:
    """The mask loss's proposals [B, D, 6]: ``post.detections``'s decode,
    shortlist and greedy class-aware NMS over the whole image, without
    serving's degenerate-box drop."""
    conf, class_prob, coord = ref_post.candidates(raws, hp["anchors"])
    class_max, classid = torch.max(class_prob, dim=-1)
    score = conf * class_max
    classid = classid.to(torch.int32)
    window = torch.tensor([[0.0, 0.0, 1.0, 1.0]], device=score.device)
    boxes = ref_post.clip_boxes(ref_post.cxcywh_to_yxyx(coord),
                                window.expand(score.shape[0], 4))
    thr, iou_thr, max_det = (hp["obj_threshold"], hp["iou_threshold"],
                             hp["max_detection"])
    valid = score > thr
    k = min(hp["pre_nms_top_k"], score.shape[1])
    top_score, top_idx = ref_post._top_k(torch.where(valid, score, -1.0), k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_class = torch.gather(classid, 1, top_idx)
    local = ref_post._greedy(top_boxes, top_score.contiguous(), top_class,
                             top_score > thr, iou_thr, max_det, full=False)
    picked = torch.where(local >= 0,
                         torch.gather(top_idx, 1, local.clamp_min(0)), -1)
    dets = ref_post._rows(picked, boxes, classid, score)
    shortfall = torch.any(local < 0, dim=-1) & (valid.sum(-1) > k)
    if bool(shortfall.any()):
        full = ref_post._rows(ref_post._greedy(boxes, score, classid, valid,
                                               iou_thr, max_det, full=True),
                              boxes, classid, score)
        dets = torch.where(shortfall[:, None, None], full, dets)
    return dets


def _random_take(u, n_take, valid):
    _, idx = ref_post._top_k(u - (~valid).float() * 1e6, n_take)
    return idx, torch.gather(valid, 1, idx)


def _tf1_taps(in_size: int, out_size: int):
    scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    src = torch.arange(out_size, dtype=torch.float32) * scale
    lo = torch.floor(src).long()
    frac = src - lo.float()
    hi = torch.clamp(lo + 1, max=in_size - 1)
    edge = hi == lo
    return (lo, hi, torch.where(edge, (1.0 - frac) + frac, 1.0 - frac),
            torch.where(edge, 0.0, frac))


def resize_masks(true_masks: torch.Tensor, size: int) -> torch.Tensor:
    """[B, T, H, W] bool -> {0, 1} float [B, T, size, size]: TF1's
    origin-aligned bilinear resize (``tf.image.resize_images``), rows
    then columns, then ``round``."""
    m = true_masks.float()
    for axis in (2, 3):
        lo, hi, w_lo, w_hi = (t.to(m.device) for t in
                              _tf1_taps(m.shape[axis], size))
        shape = [1, 1, 1, 1]
        shape[axis] = size
        m = (m.index_select(axis, lo) * w_lo.view(shape)
             + m.index_select(axis, hi) * w_hi.view(shape))
    return torch.round(m)


def assemble_logits(scoremaps: torch.Tensor, boxes_px: torch.Tensor, k: int):
    """Score maps [B, S, S, k^2] + rounded pixel boxes [B, R, 4] ->
    (logits [B, R, S, S], 0 outside each box; inside, bool)."""
    b, s = scoremaps.shape[0], scoremaps.shape[1]
    r = boxes_px.shape[1]
    row_bin, row_in = ref_post._bins(s, ref_post._grid_lines(
        boxes_px[..., 0], boxes_px[..., 2], k), k)
    col_bin, col_in = ref_post._bins(s, ref_post._grid_lines(
        boxes_px[..., 1], boxes_px[..., 3], k), k)
    kidx = row_bin[..., :, None] * k + col_bin[..., None, :]
    inside = row_in[..., :, None] & col_in[..., None, :]
    maps = scoremaps[:, None].expand(b, r, s, s, scoremaps.shape[-1])
    picked = torch.gather(maps, -1, kidx[..., None].long())[..., 0]
    return torch.where(inside, picked, 0.0), inside


def mask_loss(scoremaps, dets, true_boxes, masks_small, u_prop, u_gt,
              hp: dict) -> torch.Tensor:
    """The batch mean of each image's mask loss: 7 random valid
    proposals and 3 random true boxes as ROIs, positives at IoU >= 0.5
    against their best true box, BCE of the assembled logits against
    that box's mask inside the ROI, the mean over positive ROIs times
    ``mask_scale`` (0 without positives)."""
    s = scoremaps.shape[1]
    prop = dets[..., :4]
    prop_valid = torch.sum(torch.abs(prop), -1) > 0
    gt_valid = torch.sum(torch.abs(true_boxes[..., :4]), -1) > 0
    gt = ref_post.cxcywh_to_yxyx(true_boxes[..., :4])
    pidx, pval = _random_take(u_prop, N_PROP, prop_valid)
    gidx, gval = _random_take(u_gt, N_GT, gt_valid)
    rois = torch.cat([torch.gather(prop, 1, pidx[..., None].expand(-1, -1, 4)),
                      torch.gather(gt, 1, gidx[..., None].expand(-1, -1, 4))],
                     1)
    roi_valid = torch.cat([pval, gval], 1)
    overlaps = torch.where(gt_valid[:, None, :], ref_post._iou(rois, gt), -1.0)
    positive = roi_valid & (overlaps.max(-1).values >= 0.5)
    assigned = torch.gather(masks_small, 1, torch.argmax(overlaps, -1)[
        ..., None, None].expand(-1, -1, s, s))
    logits, inside = assemble_logits(scoremaps, torch.round(rois * float(s)),
                                     hp["k_map"])
    inside = inside.float()
    per_roi = (torch.sum(inside * _bce(assigned, logits), dim=(2, 3))
               / torch.sum(inside, dim=(2, 3)).clamp_min(1.0))
    n_pos = positive.float().sum(-1)
    mean_pos = torch.sum(per_roi * positive, -1) / n_pos.clamp_min(1.0)
    return torch.where(n_pos > 0, hp["mask_scale"] * mean_pos, 0.0).mean()


def l2_loss(weights: Dict[str, torch.Tensor], hp: dict) -> torch.Tensor:
    """``0.5 * l2_scale * sum(w^2)`` over the conv kernels and biases."""
    total = sum(torch.sum(torch.square(w)) for name, w in weights.items()
                if ".conv." in name)
    return 0.5 * hp["l2_scale"] * total


def losses(raws, batch: dict, dets, u_prop, u_gt, weights, hp: dict
           ) -> Dict[str, torch.Tensor]:
    """The step's loss terms of the raw outputs ``raws`` (differentiable
    where they are) on a batch of ``data.augment``'s form."""
    out = yolo_loss(raws, batch["true_boxes"],
                    [batch["labels_s8"], batch["labels_s16"],
                     batch["labels_s32"]], hp)
    small = resize_masks(batch["true_masks"], raws[3].shape[1])
    out["mask_loss"] = mask_loss(raws[3].float(), dets, batch["true_boxes"],
                                 small, u_prop, u_gt, hp)
    out["l2_loss"] = l2_loss(weights, hp)
    out["total_loss"] = (out["conf_loss"] + out["class_loss"]
                         + out["coord_loss"] + out["mask_loss"]
                         + out["l2_loss"])
    return out


# ----------------------------------------------------------------- Adam
def lr_at(hp: dict, count: int) -> float:
    idx = sum(count > b for b in hp["lr_boundaries"])
    return float(torch.tensor(hp["lr_values"][idx], dtype=torch.float32))


class Trainer:
    """The reference's training state: float32 weights and running
    statistics by the port's ``state_dict`` names, Adam's moments and
    count; every parameter trains (stage 2)."""

    def __init__(self, specs, state: Dict[str, torch.Tensor], hp: dict,
                 count: int = 0, mu=None, nu=None):
        self.specs, self.hp = specs, hp
        shapes = ref_net.param_shapes(specs)
        self.params = {n: state[n].float().clone() for n in shapes
                       if not n.endswith(("running_mean", "running_var"))}
        self.stats = {n: state[n].float().clone() for n in shapes
                      if n.endswith(("running_mean", "running_var"))}
        self.mu = mu or {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = nu or {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = count

    def forward(self, images: torch.Tensor):
        """Train-mode raw outputs with autograd, and the net (its
        ``moments``)."""
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in self.params.items()}
        net = TrainNet(self.specs, {**leaves, **self.stats})
        return net(images), net, leaves

    def step(self, batch: dict, dets, u_prop, u_gt) -> dict:
        """One step on ``batch`` with proposals ``dets``: returns the raw
        outputs, the loss terms and the gradients, after moving the
        weights by Adam and the running statistics by the batch's."""
        raws, net, leaves = self.forward(batch["images"])
        terms = losses(raws, batch, dets, u_prop, u_gt, leaves, self.hp)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            terms["total_loss"], [leaves[n] for n in names])))
        with torch.no_grad():
            for idx, (mean, var) in net.moments.items():
                name = f"convolutional{idx}.bn"
                rm, rv = self.stats[f"{name}.running_mean"], \
                    self.stats[f"{name}.running_var"]
                rm.mul_(BN_DECAY).add_((1.0 - BN_DECAY) * mean)
                rv.mul_(BN_DECAY).add_((1.0 - BN_DECAY) * var)
            if all(bool(torch.isfinite(g).all()) for g in grads.values()):
                self._adam(grads)
        return {"raws": tuple(r.detach() for r in raws),
                "terms": {k: v.detach() for k, v in terms.items()},
                "grads": grads}

    def _adam(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        c1 = float(1.0 - torch.tensor(ADAM_B1, dtype=torch.float32)
                   ** self.count)
        c2 = float(1.0 - torch.tensor(ADAM_B2, dtype=torch.float32)
                   ** self.count)
        lr = lr_at(self.hp, self.count)
        for n, g in grads.items():
            self.mu[n] = ADAM_B1 * self.mu[n] + (1.0 - ADAM_B1) * g
            self.nu[n] = ADAM_B2 * self.nu[n] + (1.0 - ADAM_B2) * g * g
            self.params[n] = self.params[n] - lr * (
                (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + ADAM_EPS))

