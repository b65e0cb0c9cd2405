"""Training step: train-mode forward, YOLO + mask + L2 loss, backward and
Adam with layer locks (PyTorch counterpart of
``dis_yolo_tpu/train/train_step.py``, the single-device step).

The total loss is conf + class + coord + mask + L2, where L2 is
``0.5 * l2_scale * sum(w^2)`` over the conv kernels and biases of the
*unlocked* layers (BN never).  The mask loss's ROI proposals are the NMS
output of the same forward, taken without gradient.

The optimizer is optax's chain written out in plain PyTorch, with the
same formulas and constants (``make_optimizer`` in the JAX package):

  * ``clip_by_global_norm(cfg.grad_clip_norm)`` when it is > 0;
  * ``scale_by_adam()``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias
    correction with the incremented count;
  * ``scale_by_schedule(-lr(count + 1))`` with the piecewise schedule of
    ``cfg.lr_boundaries`` / ``cfg.lr_values``;
  * parameters of ``cfg.locked_layers`` get a hard zero update and hold no
    moments;
  * with ``cfg.skip_nonfinite_updates``, ``apply_if_finite(...,
    max_consecutive_errors=100)``: a step whose gradient holds a
    non-finite value changes no parameter and no moment (it counts in
    ``total_notfinite``), unless more than 100 such steps come in a row;
    and the BN running statistics of a step that made any of them
    non-finite are put back (``_guard_stats``).

The finite check tests the same gradients as JAX's ``apply_if_finite``,
which wraps the whole ``multi_transform``: those of the locked layers
too.  So with ``skip_nonfinite_updates`` on (the default) and layers
locked, the step also takes the locked parameters' gradients, for the
check only (their update is zero either way); with it off, locked
parameters get no gradient at all (``requires_grad`` off).  The model,
its BN statistics and the moments are updated in place.  Not ported (refused by
``cfg.check_trainable()``): ``grad_accum > 1``, ``remat``, on-device
augmentation and corpus, multi-step dispatch and sync-BN.

Entry points: ``init_train_state`` and ``make_train_step`` run on CUDA
unless ``device="cpu"`` is passed, and raise when there is no card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.losses.mask_loss import (draw_uniforms,
                                                 mask_loss_per_image,
                                                 resize_gt_masks)
from dis_yolo_tpu_torch.losses.yolo_loss import yolo_loss
from dis_yolo_tpu_torch.models.api import _to_device, resolve_device
from dis_yolo_tpu_torch.models.dis_yolo import DISYolo
from dis_yolo_tpu_torch.models.layers import ConvBN
from dis_yolo_tpu_torch.ops import nms
from dis_yolo_tpu_torch.ops.decode import decode_all

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


def layer_id(name: str) -> int:
    """N of a ``convolutionalN.…`` parameter name, else -1."""
    head = name.split(".", 1)[0]
    if head.startswith("convolutional"):
        try:
            return int(head[len("convolutional"):])
        except ValueError:
            return -1
    return -1


def trainable_mask(names: Sequence[str], cfg: DISYoloConfig) -> Dict[str, bool]:
    """False for every parameter of a locked layer."""
    locked = set(cfg.locked_layers)
    return {n: layer_id(n) not in locked for n in names}


def l2_params_mask(names: Sequence[str], cfg: DISYoloConfig) -> Dict[str, bool]:
    """True for the conv kernels and biases of unlocked layers."""
    locked = set(cfg.locked_layers)
    return {n: layer_id(n) not in locked and ".conv." in n for n in names}


def lr_at(cfg: DISYoloConfig, step: int) -> float:
    """Piecewise learning rate: ``lr_values[i]`` while ``step <=
    lr_boundaries[i]``, the last value afterwards (float32, as the JAX
    schedule's table)."""
    idx = sum(step > b for b in cfg.lr_boundaries)
    return float(np.float32(cfg.lr_values[idx]))


def prepare_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Expand the loader's compact wire format: uint8 images -> f32/255,
    bit-packed ``masks_packed`` [B,T,S*S/8] (np.packbits, big-endian bit
    order) -> ``true_masks`` [B,T,S,S] bool."""
    batch = dict(batch)
    img = batch["images"]
    if img.dtype == torch.uint8:
        batch["images"] = img.float() / 255.0
    if "masks_packed" in batch:
        packed = batch.pop("masks_packed")
        s = batch["images"].shape[1]
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                              device=packed.device)
        bits = torch.bitwise_right_shift(packed[..., None], shifts) & 1
        batch["true_masks"] = bits.reshape(
            packed.shape[0], packed.shape[1], s, s).bool()
    return batch


def total_loss(model: DISYolo, batch: Dict[str, torch.Tensor],
               u_prop: torch.Tensor, u_gt: torch.Tensor):
    """(total, metrics) of one batch, the model in train mode.

    ``batch`` (the reference 7-tuple): images [B,H,W,3] f32, true_masks
    [B,T,H,W] bool, true_boxes [B,1,1,1,T,5], labels_s8 / labels_s16 /
    labels_s32 [B,h,w,A,5+C], windows [B,4].  ``u_prop`` [B,D] and
    ``u_gt`` [B,T] are the mask loss's ROI-pick uniforms.  The BN running
    statistics of unlocked layers move (in place).
    """
    cfg = model.cfg
    model.train()
    raw_s8, raw_s16, raw_s32, scoremaps = model(batch["images"])
    preds = decode_all([raw_s8, raw_s16, raw_s32], cfg)
    losses = yolo_loss(preds, batch["true_boxes"],
                       [batch["labels_s8"], batch["labels_s16"],
                        batch["labels_s32"]], cfg)

    true_boxes = batch["true_boxes"]
    if true_boxes.dim() == 6:
        true_boxes = true_boxes[:, 0, 0, 0]
    masks_small = resize_gt_masks(batch["true_masks"], scoremaps.shape[1])
    # proposals for the mask subnet: the assembly rounds the boxes, which
    # kills their gradient in the reference too
    with torch.no_grad():
        dets = nms.filter_detections(preds, batch["windows"], cfg,
                                     cfg.obj_threshold)
    per_image = mask_loss_per_image(scoremaps, dets, true_boxes, masks_small,
                                    u_prop, u_gt, cfg)
    m_loss = per_image.mean()

    l2_mask = l2_params_mask([n for n, _ in model.named_parameters()], cfg)
    l2 = torch.zeros((), dtype=torch.float32, device=scoremaps.device)
    for name, p in model.named_parameters():
        if l2_mask[name]:
            l2 = l2 + torch.sum(torch.square(p))
    l2 = 0.5 * cfg.l2_scale * l2

    total = (losses["conf_loss"] + losses["class_loss"] + losses["coord_loss"]
             + m_loss + l2)
    metrics = dict(losses)
    metrics.update(mask_loss=m_loss, l2_loss=l2, total_loss=total)
    return total, metrics


# --------------------------------------------------------------- optimizer

@dataclasses.dataclass
class AdamState:
    """optax's ``apply_if_finite(multi_transform(chain(clip, adam,
    schedule)))`` state, flattened: ``count`` is the number of applied
    updates (Adam's and the schedule's count); ``mu``/``nu`` the moments
    of the trainable parameters, by name."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0
    notfinite_count: int = 0
    total_notfinite: int = 0


def adam_init(params: Dict[str, torch.Tensor], cfg: DISYoloConfig) -> AdamState:
    """Zero moments for the trainable entries of ``params`` (name ->
    tensor); locked ones hold none."""
    mask = trainable_mask(list(params), cfg)
    names = [n for n in params if mask[n]]
    return AdamState(mu={n: torch.zeros_like(params[n]) for n in names},
                     nu={n: torch.zeros_like(params[n]) for n in names})


def adam_apply(state: AdamState, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], cfg: DISYoloConfig) -> bool:
    """One optimizer update, in place on ``params`` and ``state``.
    ``grads`` holds the trainable names (those of ``state.mu``) and may
    hold locked ones: every gradient given enters the finite check, as
    every leaf of the tree does in optax's ``apply_if_finite``, and only
    the trainable ones are applied.  Returns whether the update was
    applied (False: skipped as non-finite)."""
    names = list(state.mu)
    g = [grads[n].float() for n in names]
    if cfg.skip_nonfinite_updates:
        finite = bool(torch.stack([torch.isfinite(x).all()
                                   for x in grads.values()]).all()) \
            if grads else True
        state.notfinite_count = 0 if finite else state.notfinite_count + 1
        state.total_notfinite += 0 if finite else 1
        if not (finite or state.notfinite_count > MAX_CONSECUTIVE_ERRORS):
            return False
    if not names:
        state.count += 1
        return True
    if cfg.grad_clip_norm > 0:
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        trigger = norm < cfg.grad_clip_norm
        g = [torch.where(trigger, x, (x / norm) * cfg.grad_clip_norm)
             for x in g]
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    count = state.count + 1
    with torch.no_grad():
        # (1 - b) * g (^2) + b * moment, optax's update_moment
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - ADAM_B1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - ADAM_B2)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, g2)
        c1 = float(1.0 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count)
        c2 = float(1.0 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count)
        mu_hat = torch._foreach_div(mu, c1)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -lr_at(cfg, count))
        torch._foreach_add_([params[n] for n in names], updates)
    state.count = count
    return True


# --------------------------------------------------------------- the step

@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics, updated in place), the
    optimizer state and the step counter."""

    model: DISYolo
    opt: AdamState
    step: int = 0


def _check_model(model: DISYolo, device) -> torch.device:
    model.cfg.check_trainable()
    dev = resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"model on {next(model.parameters()).device}, "
                         f"expected {dev}")
    return dev


def init_train_state(model: DISYolo, device=None) -> TrainState:
    """Adam state with zero moments for ``model``'s trainable parameters
    (the locks of ``model.cfg``)."""
    _check_model(model, device)
    return TrainState(model, adam_init(dict(model.named_parameters()),
                                       model.cfg))


def make_train_step(model: DISYolo, device=None):
    """``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds numpy arrays or tensors on the device (the reference
    7-tuple, or uint8 images and ``masks_packed``; ``prepare_batch``);
    ``generator`` (a ``torch.Generator``) draws the mask loss's ROI picks.
    The locked layers' parameters keep ``requires_grad`` only when their
    gradients enter the finite check (``cfg.skip_nonfinite_updates``).
    ``metrics`` are detached scalar tensors on the device.
    """
    dev = _check_model(model, device)
    cfg = model.cfg
    mask = trainable_mask([n for n, _ in model.named_parameters()], cfg)
    params = dict(model.named_parameters())
    trainable = [n for n in params if mask[n]]
    # the gradients taken: the trainable ones, and the locked ones for the
    # finite check of apply_if_finite
    wanted = list(params) if cfg.skip_nonfinite_updates else trainable
    for name, p in params.items():
        p.requires_grad_(name in wanted)
    bns = [m for m in model.modules() if isinstance(m, ConvBN)]
    all_stats = [t for m in bns for t in (m.bn.running_mean, m.bn.running_var)]
    unlocked_stats = [t for m in bns if not m.lock
                      for t in (m.bn.running_mean, m.bn.running_var)]

    def step(state: TrainState, batch, generator: torch.Generator):
        if state.model is not model:
            raise ValueError("state was built for another model")
        batch = prepare_batch({k: _to_device(v, dev) for k, v in batch.items()})
        bsz = batch["images"].shape[0]
        n_gt = batch["true_boxes"].shape[-2]
        u_prop, u_gt = draw_uniforms(generator, bsz, cfg.max_detection, n_gt,
                                     dev)
        old = [t.clone() for t in unlocked_stats] \
            if cfg.skip_nonfinite_updates else None
        total, metrics = total_loss(model, batch, u_prop, u_gt)
        grads = torch.autograd.grad(total, [params[n] for n in wanted]) \
            if wanted else ()
        with torch.no_grad():
            if old is not None and not bool(torch.isfinite(torch.cat(
                    [t.reshape(-1) for t in all_stats])).all()):
                torch._foreach_copy_(unlocked_stats, old)
            adam_apply(state.opt, params, dict(zip(wanted, grads)), cfg)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
