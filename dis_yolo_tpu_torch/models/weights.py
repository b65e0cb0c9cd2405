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
  ==============================================  ===========================
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_PARAM_NAMES = {("bn", "scale"): "bn.weight", ("bn", "bias"): "bn.bias",
                ("conv", "bias"): "conv.bias"}
_STAT_NAMES = {"mean": "bn.running_mean", "var": "bn.running_var"}


def _layer_order(name: str) -> int:
    return int(name[len("convolutional"):])


def state_dict_from_flax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``{params, batch_stats}`` (numpy leaves) -> ``DISYolo`` state_dict."""
    params, stats = tree["params"], tree.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for layer in sorted(params, key=_layer_order):
        for block, leaves in params[layer].items():
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
        value = value.detach().cpu().float().numpy()
        if rest == "conv.weight":
            params.setdefault(layer, {}).setdefault("conv", {})["kernel"] = \
                np.ascontiguousarray(value.transpose(2, 3, 1, 0))
        elif rest in inv_params:
            block, leaf = inv_params[rest]
            params.setdefault(layer, {}).setdefault(block, {})[leaf] = value
        else:
            stats.setdefault(layer, {}).setdefault("bn", {})[inv_stats[rest]] = value
    return {"params": params, "batch_stats": stats}
