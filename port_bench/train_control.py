"""The training cell's control and faults, planted in the port's step.

    python -m port_bench.control --workload s2-train-stage2-b16 \\
        --seeds 1,2,3 --graphs default,fp8,half,nomask --seconds 1

``control.py`` runs the training driver with one of these ``graph``
names; the driver plants it before set-up and keeps it for the whole
run.  Nothing here edits the port: each is a forward pre-hook on the
port's modules or a wrapper put in place of one of the step's own
functions (``train/train_step.py`` looks them up when it runs).

  * ``fp8``: the control, the nearest precision below the configured
    bfloat16: every convolution's input (``ConvBN`` and ``ConvBias``)
    rounded to float8 e4m3 with a power-of-two scale per tensor that
    puts its largest magnitude just under 448, the gradient passed
    straight through;
  * ``half``: half of the batch left out, the mean taken over the rest;
  * ``nomask``: the mask loss dropped from the total (the reported mask
    loss unchanged): an answer altered where it is produced;
  * ``frozen``: Adam skipped, so the step returns the parameters and the
    moments unchanged;
  * ``noaug``: the flips and photometric augmentation skipped;
  * ``bneval``: BatchNorm left in eval mode (running statistics, none
    moved) during the step.

The driver itself takes one more name, ``float32``: the port's own
float32 path (``compute_dtype``), a second witness beside the reference.
"""

from __future__ import annotations

from typing import Callable

import torch

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor power-of-two
    scale, in ``x``'s dtype; the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.exp2(torch.floor(torch.log2(E4M3_MAX / amax)))
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def _conv_modules(model):
    from dis_yolo_tpu_torch.models.layers import ConvBias, ConvBN
    return [m for m in model.modules() if isinstance(m, (ConvBN, ConvBias))]


def _hooks(handles) -> Callable[[], None]:
    def undo():
        for h in handles:
            h.remove()
    return undo


def _fp8(model):
    return _hooks([m.register_forward_pre_hook(
        lambda mod, args: (round_fp8(args[0]),) + tuple(args[1:]))
        for m in _conv_modules(model)])


def _bneval(model):
    from dis_yolo_tpu_torch.models.layers import ConvBN

    def eval_mode(mod, args):
        mod.training = False
    return _hooks([m.register_forward_pre_hook(eval_mode)
                   for m in model.modules() if isinstance(m, ConvBN)])


def _swap(name: str, make) -> Callable[[], None]:
    from dis_yolo_tpu_torch.train import train_step
    orig = getattr(train_step, name)
    setattr(train_step, name, make(orig))
    return lambda: setattr(train_step, name, orig)


def _half(model):
    def make(orig):
        def half(model, batch, u_prop, u_gt, params, *a, **kw):
            n = batch["images"].shape[0] // 2
            return orig(model, {k: v[:n] for k, v in batch.items()},
                        u_prop[:n], u_gt[:n], params, *a, **kw)
        return half
    return _swap("grads_and_aux", make)


def _nomask(model):
    def make(orig):
        def no_mask(*a, **kw):
            total, metrics = orig(*a, **kw)
            total = total - metrics["mask_loss"]
            return total, {**metrics, "total_loss": total}
        return no_mask
    return _swap("total_loss", make)


def _frozen(model):
    return _swap("adam_apply", lambda orig: lambda *a, **kw: True)


def _noaug(model):
    return _swap("augment_batch",
                 lambda orig: lambda batch, draws, *a, **kw: batch)


PLANTS = {"fp8": _fp8, "half": _half, "nomask": _nomask, "frozen": _frozen,
          "noaug": _noaug, "bneval": _bneval}


def plant(graph: str, model) -> Callable[[], None]:
    """Plant ``graph`` ("default" plants nothing); returns the undo."""
    if graph == "default":
        return lambda: None
    if graph not in PLANTS:
        raise ValueError(f"unknown graph {graph!r}; one of default, "
                         f"{', '.join(PLANTS)}")
    return PLANTS[graph](model)
