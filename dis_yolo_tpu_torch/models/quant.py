"""Post-training int8 quantization of the deploy graph (PyTorch
counterpart of ``dis_yolo_tpu/models/quant.py``).

Scheme (symmetric PTQ, the JAX package's):
  * weights: per-output-channel int8, ``s_w[c] = max|w[.., c]| / 127``;
  * activations: per-tensor int8, ``s_x = calibrated absmax / 127``, from
    running images through the ``quant_calibrate`` graph, whose
    ``QuantConv`` layers run the float conv and record their input's
    absmax and ``calib_pct`` percentile;
  * the conv is exactly s8 x s8 -> s32, then dequantized in float32:
    ``y = conv_s32 * (s_x * s_w) + bias``, cast to the compute dtype,
    leaky ReLU.

The int8 conv is not one of the JAX package's Pallas kernels (XLA's
``conv_general_dilated`` with an int32 result computes it there), so it
is a stock call here: the int8 input is padded ('SAME', in the int8
domain, where 0 stays 0) and unfolded into an im2col matrix, and
``torch._int_mm`` multiplies it with the [Cout, kh*kw*Cin] weights into
int32.  On an H100 a profiler trace shows that GEMM as CUTLASS's sm80
int8 tensor-core kernels (``cutlass_80_tensorop_i16832gemm_s8_*``), not
Hopper's own.  The sums are exact; a float32 conv would not be (a
3x3x1024 layer sums up to 9216 * 127^2 ~ 1.5e8 per output, past 2^24).
The im2col matrix costs kh*kw times the layer's int8 input in device
memory.

Spans and counters (``utils/profiling.py``): each int8 layer's forward
is four spans, ``quant.quantize``, ``quant.im2col``, ``quant.int_mm``
and ``quant.dequant``; while spans are on it also counts
``quant.layers``, ``quant.im2col_bytes`` and ``quant.int_mm_ops``.

Height sharding (``layers.height_sharded``, ``parallel/spatial.py``):
``QuantConv`` quantizes its rows, then takes its halo from the rows'
owners as int8 (``layers.halo_rows``; quantizing is elementwise, so
that is the int8 of the exchanged float rows, at a quarter of float32's
bytes), and convolves the rows, already padded, with only the width
padded.  A rank without rows convolves ``kernel`` zero rows and keeps no
output.  The calibration graph runs sharded too, but keeps no
``records``: a rank's statistics are not the image's (JAX's sharded
forward records none either), so ``calibrate_deploy`` stays a
one-process call.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dis_yolo_tpu_torch.models.layers import (_same_pad, conv_same, halo_rows,
                                              leaky_relu)
from dis_yolo_tpu_torch.utils import profiling
from dis_yolo_tpu_torch.utils.profiling import span


def quantize_input(x: torch.Tensor, inv_sx: torch.Tensor) -> torch.Tensor:
    """NCHW activations -> NHWC int8 ``clip(round(x * inv_sx), +-127)``,
    rounding half to even in float32."""
    x = x.permute(0, 2, 3, 1).float() * inv_sx
    return torch.clamp(torch.round(x), -127.0, 127.0).to(torch.int8)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
              pad_rows: bool = True) -> torch.Tensor:
    """Exact s8 x s8 -> s32 conv with XLA 'SAME' padding: x_q [B,H,W,Cin]
    int8 (NHWC), w_q [Cout,Cin,kh,kw] int8 -> [B,Ho,Wo,Cout] int32.
    ``pad_rows=False``: the rows of x_q already hold their padding (a
    height-sharded layer's halo), so only the width is padded.

    im2col in (kh, kw, Cin) order, then ``torch._int_mm``.  Its CUDA
    rules (M > 16 rows, K and N multiples of 8) are met by zero padding,
    which adds nothing to the sums."""
    b, h, w, cin = x_q.shape
    cout, _, kh, kw = w_q.shape
    ph = _same_pad(h, kh, stride) if pad_rows else (0, 0)
    pw = _same_pad(w, kw, stride)
    ho, wo = (h + ph[0] + ph[1] - kh) // stride + 1, -(-w // stride)
    unfold = not (kh == kw == 1 and stride == 1)
    with span("quant.im2col"):
        if unfold:
            xp = F.pad(x_q, (0, 0, pw[0], pw[1], ph[0], ph[1]))
            taps = [xp[:, i:i + (ho - 1) * stride + 1:stride,
                       j:j + (wo - 1) * stride + 1:stride, :]
                    for i in range(kh) for j in range(kw)]
            cols = torch.cat(taps, dim=-1).reshape(b * ho * wo,
                                                   kh * kw * cin)
        else:
            cols = x_q.reshape(b * h * w, cin)
        w_nk = w_q.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
        m, k = cols.shape
        k8, n8 = -(-k // 8) * 8, -(-cout // 8) * 8
        cols = _pad_to(_pad_to(cols, 1, k8), 0, 17).contiguous()
        w_nk = _pad_to(_pad_to(w_nk, 1, k8), 0, n8).contiguous()
    if profiling.on():
        profiling.count("quant.im2col_bytes", m * k if unfold else 0)
        profiling.count("quant.int_mm_ops", 2 * m * k * cout)
    with span("quant.int_mm"):
        acc = torch._int_mm(cols, w_nk.t())
        return acc[:m, :cout].reshape(b, ho, wo, cout)


def record_input_scale(x: torch.Tensor, pct: float) -> Dict[str, torch.Tensor]:
    """The calibration statistics of one layer's input x (NCHW): absmax,
    and the k-th largest |x| of a strided <= 1M-element subsample of the
    NHWC-raveled |x| with ``k = max(1, round(n_sample * (1 - pct/100)))``
    (JAX's order: the subsample depends on the ravel order)."""
    ax = x.permute(0, 2, 3, 1).float().abs().reshape(-1)
    sample = ax[::max(1, ax.numel() // (1 << 20))]
    kth = max(1, round(sample.numel() * (1.0 - pct / 100.0)))
    return {"in_absmax": ax.max(),
            "in_pct": torch.topk(sample, kth).values[-1]}


class QuantConv(nn.Module):
    """int8 conv + float32 dequant epilogue + bias + leaky ReLU.

    Quantized mode holds ``w_q`` [O,I,kh,kw] int8, ``bias`` [O],
    ``inv_sx`` (scalar) and ``s_out`` [O] float32 (from
    ``quantize_deploy``).  Calibration mode (``calibrate=True``) holds the
    deploy conv's ``conv.weight``/``conv.bias``, runs the float conv and
    keeps its input's statistics in ``records``.  ``height_shard`` (None
    outside ``layers.height_sharded``) is the row partition it runs on
    (the module docstring)."""

    height_shard = None

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, alpha: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 calibrate: bool = False, calib_pct: float = 99.9):
        super().__init__()
        self.stride = stride
        self.alpha = alpha
        self.dtype = dtype
        self.calibrate = calibrate
        self.calib_pct = calib_pct
        self.records: Dict[str, torch.Tensor] = {}
        if calibrate:
            self.conv = nn.Conv2d(cin, features, kernel, stride, bias=True)
        else:
            self.register_buffer("w_q", torch.zeros(
                (features, cin, kernel, kernel), dtype=torch.int8))
            self.register_buffer("bias", torch.zeros(features))
            self.register_buffer("inv_sx", torch.ones(()))
            self.register_buffer("s_out", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = self.height_shard
        if self.calibrate:
            self.records = {} if shard is not None \
                else record_input_scale(x, self.calib_pct)
            y = conv_same(x.to(self.dtype), self.conv.weight.to(self.dtype),
                          self.conv.bias.to(self.dtype), self.stride, shard)
            return leaky_relu(y.to(self.dtype), self.alpha)
        if profiling.on():
            profiling.count("quant.layers")
        acc = self.accumulate(x)
        with span("quant.dequant"):
            y = (acc.float() * self.s_out + self.bias).permute(0, 3, 1, 2)
            return leaky_relu(y.to(self.dtype), self.alpha)

    def accumulate(self, x: torch.Tensor) -> torch.Tensor:
        """The int32 accumulator [B, Ho, Wo, Cout] of NCHW ``x``: this
        rank's output rows under a height shard."""
        with span("quant.quantize"):
            x_q = quantize_input(x, self.inv_sx)
        if self.height_shard is None:
            return int8_conv(x_q, self.w_q, self.stride)
        rows, empty = halo_rows(x_q.permute(0, 3, 1, 2), self.w_q.shape[-1],
                                self.stride, self.height_shard)
        acc = int8_conv(rows.permute(0, 2, 3, 1), self.w_q, self.stride,
                        pad_rows=False)
        return acc[:, :0] if empty else acc


def calibrate_deploy(model: nn.Module, deploy_sd: Mapping[str, torch.Tensor],
                     images, use_pct: bool = False) -> Dict[str, float]:
    """Run calibration images through the float path of the
    ``cfg.replace(quant=True, quant_calibrate=True)`` model, loaded with
    the deploy state_dict; returns {layer name: activation scale
    numerator}, the input absmax or (``use_pct``) its
    ``cfg.quant_calib_pct`` percentile.  ``images`` [B,H,W,3] (numpy, or
    a tensor on the model's device)."""
    model.load_state_dict(deploy_sd)
    dev = next(model.parameters()).device
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    model.eval()
    with torch.no_grad():
        model(images)
    key = "in_pct" if use_pct else "in_absmax"
    return {name: float(mod.records[key])
            for name, mod in model.named_children()
            if isinstance(mod, QuantConv)}


def quantize_deploy(deploy_sd: Mapping[str, torch.Tensor],
                    act_absmax: Mapping[str, float]
                    ) -> "OrderedDict[str, torch.Tensor]":
    """Deploy state_dict + calibration stats -> int8 state_dict.

    Layers named in ``act_absmax`` become ``w_q``/``bias``/``inv_sx``/
    ``s_out``, computed in numpy float32 on HWIO kernels exactly as the
    JAX package computes them; the rest (the stem and the bias head convs
    by default) pass through."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, value in deploy_sd.items():
        layer, rest = key.split(".", 1)
        if layer not in act_absmax:
            out[key] = value.clone()
            continue
        if rest != "conv.weight":
            continue
        w = value.detach().cpu().float().numpy().transpose(2, 3, 1, 0)
        b = deploy_sd[f"{layer}.conv.bias"].detach().cpu().float().numpy()
        s_w = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(axis=0),
                         1e-12) / 127.0                      # [Cout]
        s_x = max(act_absmax[layer], 1e-12) / 127.0
        w_q = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
        leaves = {"w_q": np.ascontiguousarray(w_q.transpose(3, 2, 0, 1)),
                  "bias": b,
                  "inv_sx": np.asarray(1.0 / s_x, np.float32),
                  "s_out": np.asarray(s_x * s_w, np.float32)}
        for name, leaf in leaves.items():
            out[f"{layer}.{name}"] = torch.from_numpy(
                np.array(leaf)).to(value.device)
    return out
