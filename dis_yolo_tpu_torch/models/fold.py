"""Inference-time BatchNorm folding on the port's state_dict (PyTorch
counterpart of ``dis_yolo_tpu/models/fold.py``).

Each ConvBN layer's BN affine and running statistics fold into its conv
kernel: ``inv = scale / sqrt(var + eps)`` per output channel, computed in
float32 in the JAX order (add eps, sqrt, divide, then multiply into the
kernel), so the folded weights equal the JAX package's bit for bit.

  * ``fold_batchnorm`` keeps the ConvBN structure: the kernel is scaled,
    BN becomes ``x + bias'`` (scale 1, mean 0, var 1 - eps), so the same
    model definition serves the folded weights (the JAX package's bench
    graph).
  * ``deploy_variables`` drops BN: every ConvBN layer becomes
    ``conv.weight`` + ``conv.bias`` for ``DISYolo(cfg.replace(deploy=True))``;
    the bias convs (59/67/75/79/82/85) pass through unchanged.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import torch

from dis_yolo_tpu_torch.models.layers import BN_EPS


def _bn_layers(sd: Mapping[str, torch.Tensor]) -> Tuple[str, ...]:
    """Names of the layers of ``sd`` that carry a BatchNorm."""
    return tuple(k[:-len(".bn.running_var")] for k in sd
                 if k.endswith(".bn.running_var"))


def _inv(sd: Mapping[str, torch.Tensor], layer: str) -> torch.Tensor:
    """scale / sqrt(var + eps), float32, [C].  The square root is taken in
    float64 and rounded once to float32, which is the correctly rounded
    float32 root that XLA computes (PyTorch's vectorized float32 sqrt on
    the CPU is off by an ulp for some inputs)."""
    var = sd[f"{layer}.bn.running_var"].float() + BN_EPS
    return sd[f"{layer}.bn.weight"].float() / torch.sqrt(var.double()).float()


def fold_batchnorm(sd: Mapping[str, torch.Tensor]
                   ) -> "OrderedDict[str, torch.Tensor]":
    """ConvBN state_dict -> the same keys with BN folded into the kernels."""
    out = OrderedDict((k, v.clone()) for k, v in sd.items())
    for layer in _bn_layers(sd):
        inv = _inv(sd, layer)
        w = f"{layer}.conv.weight"
        out[w] = sd[w].float() * inv[:, None, None, None]     # OIHW * [O]
        out[f"{layer}.bn.bias"] = (sd[f"{layer}.bn.bias"].float()
                                   - sd[f"{layer}.bn.running_mean"].float()
                                   * inv)
        out[f"{layer}.bn.weight"] = torch.ones_like(inv)
        out[f"{layer}.bn.running_mean"] = torch.zeros_like(inv)
        out[f"{layer}.bn.running_var"] = torch.ones_like(inv) - BN_EPS
    return out


def deploy_variables(sd: Mapping[str, torch.Tensor]
                     ) -> "OrderedDict[str, torch.Tensor]":
    """ConvBN state_dict -> deploy state_dict (``conv.weight`` and
    ``conv.bias`` per layer, no BN), for ``cfg.deploy=True``."""
    bn = set(_bn_layers(sd))
    out: Dict[str, torch.Tensor] = OrderedDict()
    for key, value in sd.items():
        layer, rest = key.split(".", 1)
        if layer not in bn:
            out[key] = value.clone()
        elif rest == "conv.weight":
            inv = _inv(sd, layer)
            out[key] = value.float() * inv[:, None, None, None]
            out[f"{layer}.conv.bias"] = (
                sd[f"{layer}.bn.bias"].float()
                - sd[f"{layer}.bn.running_mean"].float() * inv)
    return out
