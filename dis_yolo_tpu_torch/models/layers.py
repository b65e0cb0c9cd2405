"""Conv/BN/leaky-ReLU building blocks (PyTorch counterpart of
``dis_yolo_tpu/models/layers.py``).

Tensors are NCHW inside the network; the model's public outputs keep the
JAX package's NHWC layout.  Numerics follow the JAX blocks step by step:

  * the conv runs in the compute dtype (bf16 on the card), with Flax's
    ``'SAME'`` padding: a stride-2 3x3 conv on an even side pads (0, 1),
    not PyTorch's symmetric (1, 1);
  * BatchNorm runs in float32 on the conv output cast up, eps 1e-5, and
    the result is cast back to the compute dtype before the leaky ReLU;
  * BatchNorm follows Flax, not ``nn.BatchNorm2d``, in training: the
    batch variance is the biased ``max(E[x^2] - E[x]^2, 0)`` over
    (N, H, W) in float32, and the running statistics move as
    ``0.997 * old + 0.003 * batch`` with that biased variance (PyTorch's
    own train mode would store the unbiased one);
  * a locked layer (``lock=True``, the reference's transfer-learning
    freeze) normalizes with its running statistics and leaves them
    untouched even in train mode;
  * ``remat=True`` recomputes conv/BN/activation in the backward
    (``torch.utils.checkpoint``), the running statistics moved once;
  * sync-BN (Flax ``BatchNorm(axis_name=...)``, the mesh train step's):
    inside ``sync_batch_norm(model, mesh)`` the batch moments ``E[x]``
    and ``E[x^2]`` are averaged over the mesh before the variance is
    formed, so every rank normalizes with the global batch's statistics
    and moves its running statistics alike; the backward averages their
    cotangents the same way (``parallel.distributed.all_reduce_mean``).

The serving graphs add ``DeployConv`` (conv + bias + leaky, BN folded
away) and ``CommutedConcatConvBN`` (the decoder's concat 1x1 run before
the upsample); ``models/quant.py`` holds the int8 ``QuantConv``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dis_yolo_tpu_torch.parallel.distributed import all_reduce_mean

BN_DECAY = 0.997                 # Flax's momentum: new = decay*old + ...
BN_MOMENTUM = 1.0 - BN_DECAY     # nn.BatchNorm2d's convention
BN_EPS = 1e-5


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.maximum(alpha * x, x)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
    return x.reshape(b, c, 2 * h, 2 * w)


def _same_pad(size: int, kernel: int, stride: int):
    """(low, high) padding of XLA's 'SAME' along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias, stride: int):
    """Conv2d with Flax 'SAME' padding (asymmetric where XLA's is)."""
    k = weight.shape[-1]
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride, 0)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, mesh=None):
    """Flax ``BatchNorm(use_running_average=False)`` on an NCHW float32
    tensor: normalize with the biased batch statistics, over the mesh's
    global batch when a ``mesh`` is given (``axis_name``).  Returns (out,
    mean, var); ``update_running_stats`` moves ``bn``'s statistics."""
    mean = x.mean((0, 2, 3))
    sq = (x * x).mean((0, 2, 3))
    if mesh is not None:
        # Flax pmeans both moments, then forms the variance
        mean, sq = all_reduce_mean(torch.stack([mean, sq]), mesh).unbind(0)
    var = torch.clamp_min(sq - mean * mean, 0.0)
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    out = (x - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]
    return out, mean, var


def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """Flax's running-statistics update (in place, outside autograd)."""
    with torch.no_grad():
        bn.running_mean.mul_(BN_DECAY).add_((1.0 - BN_DECAY) * mean)
        bn.running_var.mul_(BN_DECAY).add_((1.0 - BN_DECAY) * var)


class ConvBN(nn.Module):
    """3x3/1x1 conv (no bias) + BatchNorm + leaky-ReLU.

    ``bn`` is an ``nn.BatchNorm2d`` for its parameter and buffer names
    (the weight bridge maps them); in train mode its statistics follow
    Flax (``batch_norm_train``), and a locked layer always normalizes
    with the running statistics.

    ``remat`` (``nn.remat(ConvBN)`` in JAX): in a train-mode forward that
    records gradients, conv/BN/activation run under
    ``torch.utils.checkpoint`` and are recomputed in the backward, so only
    the block's input is kept.  The recomputed function returns the batch
    moments and moves no statistic: the running statistics move once,
    outside it.

    ``bn_mesh`` (None outside ``sync_batch_norm``) is the mesh whose
    global batch a train-mode forward normalizes over.
    """

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, alpha: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, lock: bool = False,
                 remat: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.stride = stride
        self.alpha = alpha
        self.dtype = dtype
        self.lock = lock
        self.remat = remat
        self.bn_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            y, moments = checkpoint(self._conv_bn_act, x, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            y, moments = self._conv_bn_act(x)
        if moments is not None:
            update_running_stats(self.bn, *moments)
        return y

    def _conv_bn_act(self, x: torch.Tensor):
        x = conv_same(x.to(self.dtype), self.conv.weight.to(self.dtype), None,
                      self.stride)
        return self._bn_act(x)

    def _bn_act(self, x: torch.Tensor):
        """BatchNorm in float32 (float64 in a float64 model) on the conv
        output, back to the compute dtype, leaky ReLU.  Returns (out, the
        batch moments, or None where the running statistics normalize)."""
        bn = self.bn
        moments = None
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training and not self.lock:
            x, mean, var = batch_norm_train(x, bn, self.bn_mesh)
            moments = (mean, var)
        else:
            x = F.batch_norm(x, bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, BN_EPS)
        return leaky_relu(x.to(self.dtype), self.alpha), moments


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, mesh):
    """While the block runs, every ``ConvBN`` of ``model`` (the commuted
    fusion nodes too) normalizes a train-mode batch over ``mesh``'s
    global batch; ``mesh`` None changes nothing."""
    layers = [m for m in model.modules() if isinstance(m, ConvBN)] \
        if mesh is not None else []
    for layer in layers:
        layer.bn_mesh = mesh
    try:
        yield
    finally:
        for layer in layers:
            layer.bn_mesh = None


class CommutedConcatConvBN(ConvBN):
    """ConvBN 1x1 over ``concat([skip, up2(small)])`` without building the
    concat: the kernel is split by input rows at ``cs`` (the skip's
    channels) and the ``small`` branch's 1x1 runs BEFORE the nearest
    upsample (a 1x1 conv commutes with nearest duplication).  Its
    parameters are the ConvBN's it replaces (``conv.weight`` [O, cs+cu,
    1, 1], ``bn.*``), so one state_dict drives both graphs.  The two
    partial sums are added in the compute dtype, as in JAX."""

    def __init__(self, cin: int, features: int, alpha: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, lock: bool = False):
        super().__init__(cin, features, 1, 1, alpha, dtype, lock)

    def forward(self, skip: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
        k = self.conv.weight.to(self.dtype)
        cs = skip.shape[1]
        out_s = conv_same(skip.to(self.dtype), k[:, :cs], None, 1)
        out_u = conv_same(small.to(self.dtype), k[:, cs:], None, 1)
        y, moments = self._bn_act(out_s + upsample2x_nearest(out_u))
        if moments is not None:
            update_running_stats(self.bn, *moments)
        return y


class DeployConv(nn.Module):
    """Inference-only fused block: conv + folded-BN bias + leaky ReLU, all
    in the compute dtype (no BatchNorm, no float32 round trip).  Weights
    from ``models.fold.deploy_variables``."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, alpha: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, bias=True)
        self.stride = stride
        self.alpha = alpha
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_same(x.to(self.dtype), self.conv.weight.to(self.dtype),
                      self.conv.bias.to(self.dtype), self.stride)
        return leaky_relu(x, self.alpha)


class ConvBias(nn.Module):
    """1x1 head conv with bias, no BN, no activation (layers 59/67/75/82)."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 1, bias=True)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x.to(self.dtype), self.conv.weight.to(self.dtype),
                         self.conv.bias.to(self.dtype), 1)
