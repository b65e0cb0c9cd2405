"""Weight bridge between the Flax ``{params, batch_stats}`` tree and a
PyTorch ``state_dict`` of ``DISYolo``.

The tree is nested dicts of numpy arrays (``jax.tree.map(np.asarray, v)``
of the JAX package's variables); the port never imports JAX to read it.

  ==============================================  ===========================
  Flax                                            state_dict
  ==============================================  ===========================
  params/convolutionalN/conv/kernel  [kh,kw,I,O]  convolutionalN.conv.weight
                                                  [O,I,kh,kw]
  params/convolutionalN/conv/bias    [O]          convolutionalN.conv.bias
  params/convolutionalN/bn/scale                  convolutionalN.bn.weight
  params/convolutionalN/bn/bias                   convolutionalN.bn.bias
  batch_stats/convolutionalN/bn/mean              convolutionalN.bn.running_mean
  batch_stats/convolutionalN/bn/var               convolutionalN.bn.running_var
  params/convolutionalN/w_q   int8 [kh,kw,I,O]    convolutionalN.w_q int8
                                                  [O,I,kh,kw]
  params/convolutionalN/{bias,inv_sx,s_out}       convolutionalN.{bias,
                                                  inv_sx,s_out}
  ==============================================  ===========================

Besides the ConvBN tree this carries the serving graphs' trees both ways:
the deploy tree (``{params}`` only, ``conv/{kernel, bias}`` per layer, also
the s2d stem's 3x3x12x128 and 2x2x128x64 kernels) and the int8 tree of
``quantize_deploy`` (``w_q``, ``bias``, scalar ``inv_sx``, ``s_out`` [O];
its unquantized layers in the deploy form).  A tree without
``batch_stats`` comes back without it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_PARAM_NAMES = {("bn", "scale"): "bn.weight", ("bn", "bias"): "bn.bias",
                ("conv", "bias"): "conv.bias"}
_STAT_NAMES = {"mean": "bn.running_mean", "var": "bn.running_var"}
_QUANT_LEAVES = ("w_q", "bias", "inv_sx", "s_out")


def _layer_order(name: str) -> int:
    return int(name[len("convolutional"):])


def state_dict_from_flax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``{params, batch_stats}`` (numpy leaves) -> ``DISYolo`` state_dict."""
    params, stats = tree["params"], tree.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for layer in sorted(params, key=_layer_order):
        for block, leaves in params[layer].items():
            if block == "w_q":                      # int8 HWIO -> OIHW
                sd[f"{layer}.w_q"] = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(leaves, np.int8).transpose(3, 2, 0, 1)))
                continue
            if block in _QUANT_LEAVES:
                sd[f"{layer}.{block}"] = torch.from_numpy(
                    np.array(leaves, np.float32))
                continue
            for leaf, value in leaves.items():
                value = np.asarray(value, np.float32)
                if (block, leaf) == ("conv", "kernel"):
                    sd[f"{layer}.conv.weight"] = torch.from_numpy(
                        np.ascontiguousarray(value.transpose(3, 2, 0, 1)))
                else:
                    sd[f"{layer}.{_PARAM_NAMES[(block, leaf)]}"] = \
                        torch.from_numpy(value.copy())
        if layer in stats:
            for leaf, value in stats[layer]["bn"].items():
                sd[f"{layer}.{_STAT_NAMES[leaf]}"] = torch.from_numpy(
                    np.asarray(value, np.float32).copy())
            sd[f"{layer}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``state_dict_from_flax``: numpy leaves, HWIO kernels."""
    inv_params = {v: k for k, v in _PARAM_NAMES.items()}
    inv_stats = {v: k for k, v in _STAT_NAMES.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, value in sd.items():
        layer, rest = key.split(".", 1)
        if rest == "bn.num_batches_tracked":
            continue
        if rest == "w_q":
            params.setdefault(layer, {})["w_q"] = np.ascontiguousarray(
                value.detach().cpu().numpy().transpose(2, 3, 1, 0))
            continue
        value = value.detach().cpu().float().numpy()
        if rest in _QUANT_LEAVES:
            params.setdefault(layer, {})[rest] = value
        elif rest == "conv.weight":
            params.setdefault(layer, {}).setdefault("conv", {})["kernel"] = \
                np.ascontiguousarray(value.transpose(2, 3, 1, 0))
        elif rest in inv_params:
            block, leaf = inv_params[rest]
            params.setdefault(layer, {}).setdefault(block, {})[leaf] = value
        else:
            stats.setdefault(layer, {}).setdefault("bn", {})[inv_stats[rest]] = value
    return {"params": params, "batch_stats": stats} if stats else \
        {"params": params}
