"""K1 (mask assembly) and K2 (NMS), the two kernels of the serving graph,
and K5 (the mask paste of ``ops/paste.py``), as ``torch.library`` custom
operators: ``dis_yolo::assemble_masks``, ``dis_yolo::nms`` and
``dis_yolo::paste_masks``.

Each operator has three registrations:

  * CUDA: checks dtype, layout and alignment, launches the hand-written
    kernel (``csrc/assembly.cu``, ``csrc/nms.cu``, ``csrc/paste.cu``,
    through ``ctypes``) on the current stream and counts the launch (the
    counters ``kernel.k1``, ``kernel.k2`` and ``kernel.k5`` of
    ``utils/profiling.py``).  A build or launch error raises; nothing
    gives way to the plain version on CUDA;
  * CPU: the kernel's plain PyTorch version (K5's is the dense route of
    ``ops/paste.py``, ``paste_masks_plain``, registered there);
  * fake: the output's exact shape and dtype (``[B,D,S,S]`` float32,
    ``[B,max_det]`` int64, ``[B,D,H0,W0]`` bool and ``[B,H0,W0]`` uint8),
    so ``torch.export`` records each call as one node of the graph
    without running it.

The wrappers ``assemble_masks_batch_cuda``, ``nms_cuda`` and
``paste_masks_cuda`` check shapes and placement and call the operators,
so eager code and an exported graph take the same path, and the launch
counters count the launches of a loaded artifact too.
``ops.cuda_assembly`` calls K1's wrapper for the single-image
assembly and the training forward.  A program that loads an artifact
(``export.load_artifact``) needs this module imported and nothing else
of the package: it imports no model code.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dis_yolo_tpu_torch.ops import _build
from dis_yolo_tpu_torch.ops.mask_assembly import _assemble_px
from dis_yolo_tpu_torch.utils.profiling import count

MAX_K = 16              # K1, K3, K4: k x k bins
NMS_MAX_K = 1024        # K2: candidates per image


def on_cpu(name: str, tensors) -> bool:
    """True for CPU tensors (the plain version runs); raises unless all
    lie on one CUDA device."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} needs its tensors on one CUDA device "
                         f"(or all on the CPU), got {devices}")
    return False


def check_f32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")


# ------------------------------------------------------------- K1: assembly
def assemble_masks_batch_plain(scoremaps: torch.Tensor,
                               boxes_norm: torch.Tensor, k: int,
                               apply_sigmoid: bool = True,
                               pixel_boxes: bool = False,
                               planes: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1: [B,S,S,k*k] + [B,D,4] -> [B,D,S,S].
    ``pixel_boxes``: the boxes are already rounded score-map pixels;
    ``planes``: the score maps are channel planes [B,k*k,S,S]."""
    if planes:
        scoremaps = scoremaps.permute(0, 2, 3, 1)
    s = scoremaps.shape[1]
    boxes_px = (boxes_norm.float() if pixel_boxes
                else torch.round(boxes_norm.float() * s))
    logits, inside = _assemble_px(
        scoremaps.to(torch.promote_types(scoremaps.dtype, torch.float32)),
        boxes_px, k)
    if not apply_sigmoid:
        return logits
    return torch.where(inside, 1.0 / (1.0 + torch.exp(-logits)), 0.0)


def _check_assembly(scoremaps: torch.Tensor, boxes_norm: torch.Tensor,
                    k: int, planes: bool = False) -> None:
    shape = tuple(scoremaps.shape)
    if planes:
        ok = len(shape) == 4 and shape[2] == shape[3] and shape[1] == k * k
    else:
        ok = len(shape) == 4 and shape[1] == shape[2] and shape[3] == k * k
    if not ok:
        want = f"[B,{k * k},S,S]" if planes else f"[B,S,S,{k * k}]"
        raise ValueError(f"scoremaps must be {want}, got {shape}")
    if boxes_norm.dim() != 3 or boxes_norm.shape[0] != scoremaps.shape[0] \
            or boxes_norm.shape[2] != 4:
        raise ValueError(f"boxes_norm must be [B,D,4] with B="
                         f"{scoremaps.shape[0]}, got {tuple(boxes_norm.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


@torch.library.custom_op("dis_yolo::assemble_masks", mutates_args=(),
                         device_types="cuda")
def _assemble_masks_op(scoremaps: torch.Tensor, boxes: torch.Tensor, k: int,
                       apply_sigmoid: bool, pixel_boxes: bool,
                       planes: bool) -> torch.Tensor:
    on_cpu("dis_yolo::assemble_masks", (scoremaps, boxes))
    check_f32(scoremaps=scoremaps, boxes_norm=boxes)
    bsz, s = scoremaps.shape[0], scoremaps.shape[2]
    d = boxes.shape[1]
    out = torch.empty((bsz, d, s, s), dtype=torch.float32,
                      device=scoremaps.device)
    fn = _build.load("assembly")
    with torch.cuda.device(scoremaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(scoremaps.data_ptr(), boxes.data_ptr(), out.data_ptr(),
                 bsz, d, s, k, int(apply_sigmoid), int(pixel_boxes),
                 int(planes), stream)
    _build.check(err, "assembly kernel launch")
    count("kernel.k1")
    return out


@_assemble_masks_op.register_kernel("cpu")
def _(scoremaps, boxes, k, apply_sigmoid, pixel_boxes, planes):
    return assemble_masks_batch_plain(scoremaps, boxes, k, apply_sigmoid,
                                      pixel_boxes, planes)


@_assemble_masks_op.register_fake
def _(scoremaps, boxes, k, apply_sigmoid, pixel_boxes, planes):
    s = scoremaps.shape[2]
    return scoremaps.new_empty((scoremaps.shape[0], boxes.shape[1], s, s),
                               dtype=torch.float32)


def assemble_masks_batch_cuda(scoremaps: torch.Tensor,
                              boxes_norm: torch.Tensor, k: int,
                              apply_sigmoid: bool = True,
                              pixel_boxes: bool = False,
                              planes: bool = False) -> torch.Tensor:
    """K1: [B,S,S,k*k] f32 score maps + [B,D,4] normalized yxyx boxes ->
    [B,D,S,S] f32 masks (sigmoid inside the box, 0 outside).  With
    ``pixel_boxes`` the boxes are already rounded score-map pixels (the
    training forward) and are not rounded again; with ``planes`` the
    score maps are channel planes [B,k*k,S,S] (K4's output).  CPU
    tensors run the plain version; other placements raise."""
    _check_assembly(scoremaps, boxes_norm, k, planes)
    on_cpu("assemble_masks_batch_cuda", (scoremaps, boxes_norm))
    return torch.ops.dis_yolo.assemble_masks(scoremaps, boxes_norm, k,
                                             apply_sigmoid, pixel_boxes,
                                             planes)



# ------------------------------------------------------------------ K2: NMS
@torch.library.custom_op("dis_yolo::nms", mutates_args=(),
                         device_types="cuda")
def _nms_op(boxes: torch.Tensor, scores: torch.Tensor,
            classids: torch.Tensor, valid: torch.Tensor, max_det: int,
            iou_thresh: float) -> torch.Tensor:
    tensors = {"boxes": boxes, "scores": scores, "classids": classids,
               "valid": valid}
    on_cpu("dis_yolo::nms", tensors.values())
    want = {"boxes": torch.float32, "scores": torch.float32,
            "classids": torch.int32, "valid": torch.bool}
    for name, t in tensors.items():
        if t.dtype != want[name] or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want[name]}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    bsz, k = scores.shape
    out = torch.empty((bsz, max_det), dtype=torch.int64, device=boxes.device)
    fn = _build.load("nms")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), classids.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), bsz, k, max_det,
                 float(iou_thresh), stream)
    _build.check(err, "nms kernel launch")
    count("kernel.k2")
    return out


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
              classids: torch.Tensor, valid: torch.Tensor, max_det: int,
              iou_thresh: float) -> torch.Tensor:
    """Plain PyTorch version of K2: ``ops.nms._select_suppress_nms``
    (imported when called: ``ops/nms.py`` imports this module)."""
    from dis_yolo_tpu_torch.ops import nms
    return nms._select_suppress_nms(boxes, scores, classids, valid,
                                    iou_thresh, max_det)


@_nms_op.register_kernel("cpu")
def _(boxes, scores, classids, valid, max_det, iou_thresh):
    return nms_plain(boxes, scores, classids, valid, max_det, iou_thresh)


@_nms_op.register_fake
def _(boxes, scores, classids, valid, max_det, iou_thresh):
    return boxes.new_empty((scores.shape[0], max_det), dtype=torch.int64)


def nms_cuda(boxes: torch.Tensor, scores: torch.Tensor,
             classids: torch.Tensor, valid: torch.Tensor, max_det: int = 30,
             iou_thresh: float = 0.3) -> torch.Tensor:
    """K2: boxes [B,K,4] yxyx f32 (score-sorted desc), scores [B,K] f32,
    classids [B,K] int32, valid [B,K] bool -> picked indices [B,max_det]
    int64, -1 padded, in descending-score order.  CPU tensors run the
    plain version (``ops.nms._select_suppress_nms``); other placements
    raise."""
    bsz, k = scores.shape
    if boxes.shape != (bsz, k, 4) or classids.shape != (bsz, k) \
            or valid.shape != (bsz, k):
        raise ValueError("nms_cuda expects boxes [B,K,4], scores/classids/"
                         f"valid [B,K]; got {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(classids.shape)}, "
                         f"{tuple(valid.shape)}")
    if not 1 <= k <= NMS_MAX_K:
        raise ValueError(f"nms_cuda supports 1 <= K <= {NMS_MAX_K}, "
                         f"got K={k}")
    on_cpu("nms_cuda", (boxes, scores, classids, valid))
    return torch.ops.dis_yolo.nms(boxes, scores, classids, valid, max_det,
                                  float(iou_thresh))


# --------------------------------------------------------------- K5: paste
_PASTE_DTYPES = {"masks": torch.float32, "i0": torch.int32,
                 "i1": torch.int32, "w": torch.float32, "inside": torch.bool,
                 "valid": torch.bool, "cls": torch.int32}


def _paste_outputs(masks: torch.Tensor, out_h: int, out_w: int,
                   semantic: bool):
    """Empty (full, sem) for ``dis_yolo::paste_masks``: sem is
    [B,H0,W0] with ``semantic`` and [B,0,0] without."""
    bsz, d = masks.shape[0], masks.shape[1]
    full = masks.new_empty((bsz, d, out_h, out_w), dtype=torch.bool)
    sem = masks.new_empty((bsz, out_h, out_w) if semantic else (bsz, 0, 0),
                          dtype=torch.uint8)
    return full, sem


@torch.library.custom_op("dis_yolo::paste_masks", mutates_args=(),
                         device_types="cuda")
def paste_masks_op(masks: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor,
                   w: torch.Tensor, inside: torch.Tensor, valid: torch.Tensor,
                   cls: torch.Tensor, out_h: int, out_w: int, semantic: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    tensors = dict(masks=masks, i0=i0, i1=i1, w=w, inside=inside,
                   valid=valid, cls=cls)
    on_cpu("dis_yolo::paste_masks", tensors.values())
    for name, t in tensors.items():
        if t.dtype != _PASTE_DTYPES[name] or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous "
                             f"{_PASTE_DTYPES[name]}, got {t.dtype} "
                             f"contiguous={t.is_contiguous()}")
    full, sem = _paste_outputs(masks, out_h, out_w, semantic)
    bsz, d, s = masks.shape[0], masks.shape[1], masks.shape[-1]
    fn = _build.load("paste")
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors.values()), full.data_ptr(),
                 sem.data_ptr() if semantic else None, bsz, d, s, out_h,
                 out_w, i0.shape[-1], stream)
    _build.check(err, "paste kernel launch")
    count("kernel.k5")
    return full, sem


@paste_masks_op.register_fake
def _(masks, i0, i1, w, inside, valid, cls, out_h, out_w, semantic):
    return _paste_outputs(masks, out_h, out_w, semantic)


def paste_masks_cuda(masks: torch.Tensor, taps, valid: torch.Tensor,
                     cls: torch.Tensor, out_h: int, out_w: int,
                     semantic: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5: masks [..., D, S, S] f32 (K1's output), ``taps`` the tap tables
    (i0, i1 int32, w f32, inside bool) of ``paste.paste_taps``, each
    [..., D, 2, L] with L >= max(out_h, out_w), valid [..., D] bool, cls
    [..., D] int32 in [0, 255] -> (bool masks [..., D, out_h, out_w], the
    semantic map [..., out_h, out_w] uint8 with ``semantic``, else None).
    CPU tensors run the plain version (``paste.paste_masks_plain``,
    registered by ``ops/paste.py``); other placements raise."""
    if len(taps) != 4:
        raise ValueError("paste_masks_cuda: taps must be the four tables "
                         "(i0, i1, w, inside)")
    lead, d, s = masks.shape[:-3], masks.shape[-3], masks.shape[-1]
    n = taps[0].shape[-1]
    shapes = {"masks": (masks, lead + (d, s, s)), "valid": (valid, lead + (d,)),
              "cls": (cls, lead + (d,)),
              **{f"taps[{i}]": (t, lead + (d, 2, n)) for i, t in enumerate(taps)}}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"paste_masks_cuda: {name} must be {want}, "
                             f"got {tuple(t.shape)}")
    if n < max(out_h, out_w):
        raise ValueError(f"paste_masks_cuda: the tables hold {n} positions, "
                         f"fewer than the photo's {out_h} x {out_w}")
    on_cpu("paste_masks_cuda", (masks, *taps, valid, cls))
    bsz = math.prod(lead)

    def flat(t):
        return t.reshape((bsz,) + t.shape[len(lead):]).contiguous()

    full, sem = torch.ops.dis_yolo.paste_masks(
        flat(masks), *map(flat, taps), flat(valid), flat(cls), out_h, out_w,
        semantic)
    full = full.reshape(lead + full.shape[1:])
    return full, sem.reshape(lead + sem.shape[1:]) if semantic else None
