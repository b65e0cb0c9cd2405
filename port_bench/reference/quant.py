"""DIS-YOLO's int8 serving graph in plain arithmetic: symmetric
post-training quantization with per-channel weights and per-tensor
activations (Krishnamoorthi, arXiv:1806.08342), over the network of
``net.py``.

The scheme, as the port's ``models/quant.py`` states it, written here
from that statement:

  * BatchNorm folded into each conv in float32: ``inv = gamma /
    sqrt(var + eps)``, kernel ``w * inv``, bias ``beta - mean * inv``;
  * per-output-channel weight scales ``s_w = max|w| / 127`` and weights
    ``clip(round(w / s_w), +-127)``, rounded half to even;
  * per-tensor activation scales ``s_x = absmax / 127``, the absmax of
    the layer's input over calibration images;
  * each int8 layer's input quantized as ``clip(round(x / s_x), +-127)``,
    rounded half to even;
  * the convolution of the integer values, summed exactly: in float64,
    where every product (at most 127^2) and every partial sum (at most
    9216 * 127^2 ~ 1.5e8) is an integer far below 2^53, so the order of
    summation cannot matter;
  * dequantized in float32 as ``acc * (s_x * s_w) + bias``, then rounded
    to bfloat16 and passed through the leaky ReLU.

Layers outside ``quant_layers`` (1-4 by default) and the bias head convs
(59, 67, 75, 82) are the folded float conv.  ``calibrate`` finds the
absmax of every int8 layer's input from a float32 folded forward.

Given the stem (``stem_layers``: the float layers before the first int8
one) a forward can take the program's own outputs of those layers
(``forced``), checking its own against them (``forced_err``), and compute
every later layer itself.  The reason: the card's bfloat16 convolutions
sum in an order this cannot follow, so a few of the stem's values differ
by a bfloat16 ulp, and on random weights the int8 layers carry such a
difference from rounding boundary to rounding boundary until the raw
outputs differ as much as int8 differs from float32 (a relative L2 of
0.6-0.7 at 576^2, where every int8 layer is exact on the program's own
input).

Departures from a scheme in exact arithmetic, each because the next
layer's quantization reads the rounded value (a value moved by one
rounding can cross a rounding boundary of the next quantization):

  * the graph's activations are bfloat16 between layers: the image is
    rounded to bfloat16; every layer's output is rounded to bfloat16
    before the leaky ReLU, which is computed on the bfloat16 value; each
    residual sum is rounded to bfloat16;
  * the float layers use their folded kernel and bias rounded to
    bfloat16, as the graph convolves them, and sum in float32 (the
    card's bfloat16 convolutions also sum in float32, in their own
    order);
  * the scales are float32 numbers: ``s_w`` is computed in float32
    (``max|w|`` over 127, at least 1e-12 / 127 for an all-zero
    channel), ``w / s_w`` is a float32 division, ``s_x`` is ``absmax /
    127`` rounded once to float32, and the dequant scale is the float32
    product ``s_x * s_w``; ``acc`` is rounded to float32 before the
    product, and the product and the bias sum are two float32 roundings.

  * the input is quantized in float32 arithmetic, as ``round(x * r)``
    with ``r = 1 / s_x`` rounded to float32 and the product rounded to
    float32: a bfloat16 input over a bfloat16 absmax often lands exactly
    on a half-integer, ``x / s_x = n + 1/2``, where an exact quotient
    rounds to even and the float32 product falls to either side (at 64
    px the exact quotient moved 0.8% of layer 5's inputs by one step).

Plain PyTorch: nothing of the port, no JAX; TF32 off
(``reference.plain_float32``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch
import torch.nn.functional as F

from port_bench.reference import plain_float32
from port_bench.reference.net import ALPHA, BN_EPS, Net, _conv, _same_pad

QUANT_LAYERS = tuple(range(5, 86))
QMAX = 127.0


def fold(weights: Mapping[str, torch.Tensor]) -> Dict[str, tuple]:
    """{layer index: (kernel, bias)} of every conv, float32, BatchNorm
    folded.  The root is the correctly rounded float32 one (taken in
    float64 and rounded once)."""
    out = {}
    for key in weights:
        if not key.endswith(".conv.weight"):
            continue
        name = key[:-len(".conv.weight")]
        idx = int(name[len("convolutional"):])
        w = weights[key].float()
        if f"{name}.conv.bias" in weights:
            out[idx] = (w, weights[f"{name}.conv.bias"].float())
            continue
        var = weights[f"{name}.bn.running_var"].float() + BN_EPS
        root = torch.sqrt(var.double()).float()
        inv = weights[f"{name}.bn.weight"].float() / root
        out[idx] = (w * inv[:, None, None, None],
                    weights[f"{name}.bn.bias"].float()
                    - weights[f"{name}.bn.running_mean"].float() * inv)
    return out


def weight_scales(kernel: torch.Tensor) -> torch.Tensor:
    """s_w [Cout], float32: each output channel's largest magnitude over
    127."""
    amax = kernel.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
    return amax / torch.tensor(QMAX, dtype=torch.float32,
                               device=kernel.device)


def quantize_weights(kernel: torch.Tensor, s_w: torch.Tensor
                     ) -> torch.Tensor:
    """The integer kernel, as float64 values in [-127, 127]."""
    q = torch.round(kernel / s_w[:, None, None, None])
    return q.clamp(-QMAX, QMAX).double()


def act_scale(absmax: float):
    """(s_x, 1 / s_x), each rounded once to float32 from ``absmax /
    127`` taken in float64."""
    s_x = max(float(absmax), 1e-12) / QMAX
    return (torch.tensor(s_x, dtype=torch.float32),
            torch.tensor(1.0 / s_x, dtype=torch.float32))


def quantize_input(x: torch.Tensor, inv_s_x: torch.Tensor) -> torch.Tensor:
    """The integer input ``clip(round(x / s_x), +-127)`` as float64
    values, the quotient taken as the float32 product ``x * (1 / s_x)``
    and rounded to the nearest integer, half to even."""
    q = torch.round(x.float() * inv_s_x.to(x.device))
    return q.clamp(-QMAX, QMAX).double()


def accumulate(x_int: torch.Tensor, w_int: torch.Tensor, stride: int
               ) -> torch.Tensor:
    """The exact integer conv (XLA's 'SAME' padding) of NCHW integer
    values with an OIHW integer kernel, both float64: an unfold and one
    float64 matrix product.  Returns NCHW float64 integers."""
    b, _, h, w = x_int.shape
    cout, cin, k, _ = w_int.shape
    ph, pw = _same_pad(h, k, stride), _same_pad(w, k, stride)
    xp = F.pad(x_int, (pw[0], pw[1], ph[0], ph[1]))
    ho, wo = -(-h // stride), -(-w // stride)
    cols = F.unfold(xp, k, stride=stride)               # [B, Cin k k, L]
    acc = w_int.reshape(cout, cin * k * k) @ cols       # [B, Cout, L]
    return acc.reshape(b, cout, ho, wo)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _leaky(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y > 0, y, ALPHA * y)


class Int8Net(Net):
    """``Int8Net(specs, weights, act_absmax)(images)`` -> the four raw
    outputs, NHWC float32, as ``Net`` returns them.  ``weights`` are the
    BatchNorm-form float32 weights ``Net`` takes; ``act_absmax`` maps
    ``convolutional<i>`` to the absmax that sets layer i's ``s_x``.
    ``forced`` {layer index: NCHW output} (the
    stem's, from the program) are the outputs those layers pass on;
    ``forced_err`` then holds the relative L2 gap of this module's own
    output of each, on the same input."""

    def __init__(self, specs, weights: Mapping[str, torch.Tensor],
                 act_absmax: Mapping[str, float],
                 quant_layers: Iterable[int] = QUANT_LAYERS):
        plain_float32()
        super().__init__(specs, dict(weights))
        folded = fold(weights)
        self.layers = {}
        self.forced: Dict[int, torch.Tensor] = {}
        self.forced_err: Dict[int, float] = {}
        quant_layers = set(quant_layers)
        for idx, kind, _, _, _, _ in specs:
            kernel, bias = folded[idx]
            if kind == "cbn" and idx in quant_layers:
                s_w = weight_scales(kernel)
                s_x, inv_s_x = (t.to(kernel.device) for t in act_scale(
                    act_absmax[f"convolutional{idx}"]))
                self.layers[idx] = ("int8", quantize_weights(kernel, s_w),
                                    inv_s_x, s_x * s_w, bias)
            else:
                self.layers[idx] = ("float", _bf16(kernel).float(),
                                    _bf16(bias).float())

    def c(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        kind, *p = self.layers[idx]
        stride = self.specs[idx][5]
        if kind == "int8":
            w_int, inv_s_x, scale, bias = p
            x_int = quantize_input(x, inv_s_x)
            acc = accumulate(x_int, w_int, stride)
            y = (acc.float() * scale[:, None, None]
                 + bias[:, None, None])
        else:
            y = _conv(x.float(), p[0], p[1], stride)
        y = _bf16(y)
        if self.specs[idx][1] != "bias":
            y = _leaky(y)
        if idx in self.forced:
            given = self.forced[idx]
            d = (y.double() - given.double()).norm()
            self.forced_err[idx] = float(
                d / given.double().norm().clamp_min(1e-30))
            return given.to(y.dtype)
        return y

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, forced=None):
        # the graph's input cast; ``Net`` permutes and runs the layers,
        # whose outputs are bfloat16, so each residual sum rounds to it
        self.forced, self.forced_err = dict(forced or {}), {}
        outs = super().__call__(_bf16(images).float())
        return tuple(o.float() for o in outs)


def stem_layers(specs, quant_layers: Iterable[int] = QUANT_LAYERS):
    """The float BatchNorm layers before the first int8 one (1-4 by
    default)."""
    first = min(set(quant_layers))
    return tuple(s[0] for s in specs if s[1] == "cbn" and s[0] < first)


class _Calibration(Net):
    """The float32 folded forward, recording each int8 layer's input
    absmax."""

    def __init__(self, specs, weights, quant_layers):
        super().__init__(specs, dict(weights))
        self.folded = fold(weights)
        quant_layers = set(quant_layers)
        self.quant = {s[0] for s in specs
                      if s[1] == "cbn" and s[0] in quant_layers}
        self.absmax: Dict[str, float] = {}

    def c(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        if idx in self.quant:
            self.absmax[f"convolutional{idx}"] = float(x.abs().max())
        kernel, bias = self.folded[idx]
        y = _conv(x, kernel, bias, self.specs[idx][5])
        return y if self.specs[idx][1] == "bias" else _leaky(y)


def calibrate(specs, weights: Mapping[str, torch.Tensor],
              images: torch.Tensor,
              quant_layers: Iterable[int] = QUANT_LAYERS
              ) -> Dict[str, float]:
    """{``convolutional<i>``: absmax of layer i's input} over ``images``
    [B, H, W, 3] from the float32 folded forward, for every int8 layer."""
    plain_float32()
    net = _Calibration(specs, weights, quant_layers)
    net(images)
    return net.absmax


def scale_gap(program: Mapping[str, float], reference: Mapping[str, float]
              ) -> float:
    """The worst layer's relative gap between two sets of activation
    scales (or absmaxes), ``|p - r| / r``; infinite where a layer of the
    reference is missing."""
    worst = 0.0
    for name in reference:
        if name not in program:
            return float("inf")
        r = float(reference[name])
        worst = max(worst, abs(float(program[name]) - r) / max(r, 1e-30))
    return worst
