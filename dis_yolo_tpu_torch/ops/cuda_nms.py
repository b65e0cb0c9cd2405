"""Fused class-aware greedy NMS: CUDA kernel K2.

Counterpart of ``dis_yolo_tpu/ops/pallas_nms.py`` (``nms_pallas``); the
kernel is ``csrc/nms.cu``, whose header says what it replaces and what
bounds it.  One launch serves the whole batch, one block per image.

``nms_cuda`` launches the kernel for CUDA tensors and runs the plain
PyTorch version, ``ops.nms._select_suppress_nms``, only for CPU tensors;
anything else raises.  ``nms_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from dis_yolo_tpu_torch.ops import _build

MAX_K = 1024


def nms_cuda(boxes: torch.Tensor, scores: torch.Tensor,
             classids: torch.Tensor, valid: torch.Tensor, max_det: int = 30,
             iou_thresh: float = 0.3) -> torch.Tensor:
    """boxes [B,K,4] yxyx f32 (score-sorted desc), scores [B,K] f32,
    classids [B,K] int32, valid [B,K] bool -> picked indices [B,max_det]
    int64, -1 padded, in descending-score order."""
    bsz, k = scores.shape
    if boxes.shape != (bsz, k, 4) or classids.shape != (bsz, k) \
            or valid.shape != (bsz, k):
        raise ValueError("nms_cuda expects boxes [B,K,4], scores/classids/"
                         f"valid [B,K]; got {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(classids.shape)}, "
                         f"{tuple(valid.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"nms_cuda supports 1 <= K <= {MAX_K}, got K={k}")
    tensors = {"boxes": boxes, "scores": scores, "classids": classids,
               "valid": valid}
    devices = {t.device for t in tensors.values()}
    if devices == {torch.device("cpu")}:
        from dis_yolo_tpu_torch.ops.nms import _select_suppress_nms
        return _select_suppress_nms(boxes, scores, classids, valid,
                                    iou_thresh, max_det)
    if len(devices) != 1 or boxes.device.type != "cuda":
        raise ValueError("nms_cuda needs every tensor on one CUDA device "
                         f"(or all on the CPU), got {devices}")
    want = {"boxes": torch.float32, "scores": torch.float32,
            "classids": torch.int32, "valid": torch.bool}
    for name, t in tensors.items():
        if t.dtype != want[name] or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want[name]}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    out = torch.empty((bsz, max_det), dtype=torch.int64, device=boxes.device)
    fn = _build.load("nms")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), classids.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), bsz, k, max_det,
                 float(iou_thresh), stream)
    _build.check(err, "nms kernel launch")
    nms_cuda.launches += 1
    return out


nms_cuda.launches = 0
