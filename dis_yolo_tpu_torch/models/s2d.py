"""Space-to-depth stem: an exact rewrite of conv1 + conv2 (PyTorch
counterpart of ``dis_yolo_tpu/models/s2d.py``).

The input is repacked into 2x2 blocks and the stem's weights are
transformed so that the same function runs with 12 input and 128 output
channels at half resolution:

  x [B,3,576,576] --s2d--> x2 [B,12,288,288]       (a, b, ch) packing
  conv1' : 3x3/s1 12->128, SAME      == conv1, its 32-channel output at
                                        576^2 repacked as 128 channels
  conv2' : 2x2/s1 128->64, pad (0,1) == conv2 (3x3 stride 2), at its own
                                        288^2x64 output

The channel packing is the JAX package's: depth index ``(a*2 + b)*C + ch``
for the pixel at row offset ``a``, column offset ``b`` of its block.  The
port's activations are NCHW, so ``space_to_depth`` here takes and returns
NCHW tensors; on the NHWC view it equals the JAX function.  conv2' needs
the (0, 1) padding that ``layers.conv_same`` gives a 2-wide kernel at
stride 1, which is XLA's 'SAME'.

The kernel transform is numpy on HWIO arrays, a copy of the JAX
package's; ``s2d_stem_variables`` applies it to a deploy state_dict
(OIHW).  Inference only (deploy graph), and not with mask_stride 1, which
needs conv1's full-resolution output as a skip.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2] with (a, b, ch) channel packing."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)       # [B, C, i, a, j, b]
    x = x.permute(0, 3, 5, 1, 2, 4)                 # [B, a, b, C, i, j]
    return x.reshape(b, 4 * c, h // 2, w // 2)


def _pack(a: int, b: int, n: int) -> slice:
    """Channel slice of sub-position (a, b) in (a, b, ch)-packed depth."""
    i = (a * 2 + b) * n
    return slice(i, i + n)


def s2d_stem_kernels(w1: np.ndarray, b1: np.ndarray,
                     w2: np.ndarray, b2: np.ndarray):
    """(conv1 [3,3,C,F1], conv2 [3,3,F1,F2]) HWIO -> s2d-domain kernels.

    Returns (w1p [3,3,4C,4F1], b1p [4F1], w2p [2,2,4F1,F2], b2p [F2]).
    """
    w1, w2 = np.asarray(w1), np.asarray(w2)
    c, f1 = w1.shape[2], w1.shape[3]
    f2 = w2.shape[3]

    w1p = np.zeros((3, 3, 4 * c, 4 * f1), w1.dtype)
    for a in (0, 1):
        for b in (0, 1):
            for u in (-1, 0, 1):
                di, ap = divmod(a + u, 2)
                for v in (-1, 0, 1):
                    dj, bp = divmod(b + v, 2)
                    w1p[di + 1, dj + 1, _pack(ap, bp, c), _pack(a, b, f1)] \
                        = w1[u + 1, v + 1]
    b1p = np.concatenate([np.asarray(b1)] * 4)

    w2p = np.zeros((2, 2, 4 * f1, f2), w2.dtype)
    for u in range(3):
        di, ap = divmod(u, 2)
        for v in range(3):
            dj, bp = divmod(v, 2)
            w2p[di, dj, _pack(ap, bp, f1), :] = w2[u, v]
    return w1p, b1p, w2p, np.asarray(b2)


def s2d_stem_variables(deploy_sd: Mapping[str, torch.Tensor]
                       ) -> "OrderedDict[str, torch.Tensor]":
    """Deploy state_dict -> state_dict for ``cfg.s2d_stem=True``: the
    kernels and biases of convolutional1/2 replaced by their s2d-domain
    transforms, every other entry passed through."""
    def hwio(key):
        return deploy_sd[key].detach().cpu().float().numpy().transpose(2, 3, 1, 0)

    def numpy(key):
        return deploy_sd[key].detach().cpu().float().numpy()

    w1p, b1p, w2p, b2p = s2d_stem_kernels(
        hwio("convolutional1.conv.weight"), numpy("convolutional1.conv.bias"),
        hwio("convolutional2.conv.weight"), numpy("convolutional2.conv.bias"))
    new = {"convolutional1.conv.weight": w1p.transpose(3, 2, 0, 1),
           "convolutional1.conv.bias": b1p,
           "convolutional2.conv.weight": w2p.transpose(3, 2, 0, 1),
           "convolutional2.conv.bias": b2p}
    out = OrderedDict()
    for key, value in deploy_sd.items():
        out[key] = (torch.from_numpy(np.ascontiguousarray(new[key]))
                    .to(value.device) if key in new else value.clone())
    return out
