"""Fused position-sensitive mask assembly + sigmoid: CUDA kernel K1.

Counterpart of ``dis_yolo_tpu/ops/pallas_assembly.py``'s forward
(``assemble_masks_batch_pallas``); the kernel is ``csrc/assembly.cu``,
whose header says what it replaces and what bounds it.

Semantics are the Pallas kernel's, not the JAX gather path's: inside the
box each pixel is sigmoid(score map channel of its k x k bin); outside it
is an exact 0 (the gather path's sigmoid maps it to 0.5).  With
``apply_sigmoid=False`` the output is the raw logits, 0 outside.

``assemble_masks_batch_cuda`` launches the kernel for CUDA tensors and
runs the plain PyTorch version, ``assemble_masks_batch_plain``, only for
CPU tensors; anything else raises.  ``assemble_masks_batch_cuda.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from dis_yolo_tpu_torch.ops import _build
from dis_yolo_tpu_torch.ops.mask_assembly import _assemble_px

MAX_K = 16


def assemble_masks_batch_plain(scoremaps: torch.Tensor,
                               boxes_norm: torch.Tensor, k: int,
                               apply_sigmoid: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1: [B,S,S,k*k] + [B,D,4] -> [B,D,S,S]."""
    s = scoremaps.shape[1]
    boxes_px = torch.round(boxes_norm.float() * s)
    logits, inside = _assemble_px(scoremaps.float(), boxes_px, k)
    if not apply_sigmoid:
        return logits
    return torch.where(inside, 1.0 / (1.0 + torch.exp(-logits)), 0.0)


def _check(scoremaps: torch.Tensor, boxes_norm: torch.Tensor, k: int) -> None:
    if scoremaps.dim() != 4 or scoremaps.shape[1] != scoremaps.shape[2] \
            or scoremaps.shape[3] != k * k:
        raise ValueError(f"scoremaps must be [B,S,S,{k * k}], "
                         f"got {tuple(scoremaps.shape)}")
    if boxes_norm.dim() != 3 or boxes_norm.shape[0] != scoremaps.shape[0] \
            or boxes_norm.shape[2] != 4:
        raise ValueError(f"boxes_norm must be [B,D,4] with B="
                         f"{scoremaps.shape[0]}, got {tuple(boxes_norm.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def assemble_masks_batch_cuda(scoremaps: torch.Tensor,
                              boxes_norm: torch.Tensor, k: int,
                              apply_sigmoid: bool = True) -> torch.Tensor:
    """[B,S,S,k*k] f32 score maps + [B,D,4] normalized yxyx boxes ->
    [B,D,S,S] f32 masks (sigmoid inside the box, 0 outside)."""
    _check(scoremaps, boxes_norm, k)
    devices = {scoremaps.device, boxes_norm.device}
    if devices == {torch.device("cpu")}:
        return assemble_masks_batch_plain(scoremaps, boxes_norm, k,
                                          apply_sigmoid)
    if len(devices) != 1 or scoremaps.device.type != "cuda":
        raise ValueError("assemble_masks_batch_cuda needs both tensors on "
                         f"one CUDA device (or both on the CPU), got {devices}")
    for name, t in (("scoremaps", scoremaps), ("boxes_norm", boxes_norm)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
    bsz, s = scoremaps.shape[0], scoremaps.shape[1]
    d = boxes_norm.shape[1]
    out = torch.empty((bsz, d, s, s), dtype=torch.float32,
                      device=scoremaps.device)
    fn = _build.load("assembly")
    with torch.cuda.device(scoremaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(scoremaps.data_ptr(), boxes_norm.data_ptr(), out.data_ptr(),
                 bsz, d, s, k, int(apply_sigmoid), stream)
    _build.check(err, "assembly kernel launch")
    assemble_masks_batch_cuda.launches += 1
    return out


assemble_masks_batch_cuda.launches = 0
