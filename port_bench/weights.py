"""Seeded weights for DIS-YOLO, made on the device in a few large draws.

Conv kernels are normal with variance 1 / fan-in (the head convs'
``HEAD_GAIN`` squared times that).  BatchNorm's scales are log-normal,
``exp(GAMMA_SPREAD z)``, so channel scales spread over an order of
magnitude as a trained network's do; the last BatchNorm of each
residual branch is scaled down by ``RES_GAMMA``, so the 23 residual
blocks do not compound into a chaotic map; the shifts are
``BN_SHIFT + 0.25 z``, the head convs' biases ``0.5 z``; the heads'
box-size channels are scaled to ``HEAD_WH_GAIN``, so boxes stay within
a few e-folds of their anchors (else a quarter of NMS's survivors were
degenerate boxes that the port drops).  The running statistics are
then set to the moments each layer sees on a batch of
the traffic's photos, in float32 (``reference.net.Net(calibrate=True)``):
random weights normalized as a trained network's are, so every layer's
activations keep unit scale and the scores and score maps spread.

Why these shapes matter: the check of ``correct`` holds the bfloat16
port against the float32 reference, and the control, the port's int8
graph, has to fail it.  Per-tensor int8 activations lose most where
channel scales differ, as they do in trained networks.  With scales
near 1 the int8 graph's error was only 2.1-2.4 times the bfloat16
one's on the card at 576^2, 2.9 times with a spread of 0.75; with 1.0
the control's smallest reading is 3.3-3.5 times the port's largest.  Both sides get
these weights: the port through ``load_state_dict``, the reference as
they are.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from port_bench.reference.net import Net, param_shapes

HEAD_GAIN = 1.5
HEAD_WH_GAIN = 0.25
HEADS = (59, 67, 75)
RES_GAMMA = 0.2
BN_SHIFT = 0.5
GAMMA_SPREAD = 1.0
# the last conv of each residual branch: x + conv_i(conv_{i-1}(x))
RESIDUAL_BRANCH_OUT = frozenset([4, 7, 9] + list(range(12, 27, 2))
                                + list(range(29, 44, 2))
                                + list(range(46, 53, 2)))


def make_weights(specs, seed: int, device, calib_images: torch.Tensor
                 ) -> "OrderedDict[str, torch.Tensor]":
    """Float32 weights by the port's ``state_dict`` names, on ``device``;
    ``calib_images`` [B, H, W, 3] set the BatchNorm statistics."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([seed, 2]).integers(2 ** 62)))
    shapes = param_shapes(specs)
    n_w = sum(int(np.prod(shapes[f"convolutional{s[0]}.conv.weight"]))
              for s in specs)
    n_bn = sum(s[3] for s in specs if s[1] == "cbn")
    n_bias = sum(s[3] for s in specs if s[1] == "bias")
    z_w = torch.randn(n_w, generator=gen, device=device)
    z_bn = torch.randn(2 * n_bn, generator=gen, device=device)
    z_b = torch.randn(n_bias, generator=gen, device=device)
    w: Dict[str, torch.Tensor] = OrderedDict()
    iw = ibn = ib = 0
    for idx, kind, cin, cout, k, _ in specs:
        name = f"convolutional{idx}"
        n = cout * cin * k * k
        gain = HEAD_GAIN if kind == "bias" else 1.0
        w[f"{name}.conv.weight"] = (z_w[iw:iw + n].view(cout, cin, k, k)
                                    * (gain / (cin * k * k) ** 0.5))
        if kind == "bias" and idx in HEADS:
            # box sizes within a few e-folds of their anchors
            w[f"{name}.conv.weight"].view(3, cout // 3, -1)[:, 2:4] *= \
                HEAD_WH_GAIN / HEAD_GAIN
        iw += n
        if kind == "bias":
            w[f"{name}.conv.bias"] = 0.5 * z_b[ib:ib + cout]
            ib += cout
            continue
        scale = RES_GAMMA if idx in RESIDUAL_BRANCH_OUT else 1.0
        w[f"{name}.bn.weight"] = scale * torch.exp(GAMMA_SPREAD
                                                   * z_bn[ibn:ibn + cout])
        w[f"{name}.bn.bias"] = BN_SHIFT + 0.25 * z_bn[n_bn + ibn:n_bn + ibn + cout]
        ibn += cout
        w[f"{name}.bn.running_mean"] = torch.zeros(cout, device=device)
        w[f"{name}.bn.running_var"] = torch.ones(cout, device=device)
    Net(specs, w, calibrate=True)(calib_images)
    return w


def program_state_dict(weights) -> "OrderedDict[str, torch.Tensor]":
    """The weights with the BatchNorm step counters a ``state_dict`` of
    ``nn.BatchNorm2d`` also holds."""
    sd = OrderedDict(weights)
    for key in list(weights):
        if key.endswith(".bn.running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    return sd
