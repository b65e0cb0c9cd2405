"""Batched mask paste to original image resolution (PyTorch counterpart of
``dis_yolo_tpu/ops/paste.py``).

Per detection: inverse-letterbox the box to original pixels, crop the
score-map-sized sigmoid mask by the normalized box, bilinear-resize the
crop to the box (cv2 INTER_LINEAR half-pixel mapping, edge clamping),
binarize at > 0.5 and paste; then the per-class semantic map, where later
detections overwrite earlier ones.

Both routes share the tap tables (``paste_taps``: per output row and
column, the two source indices, the weight and the inside flag, both axes
in one set of operations).  On the CPU the resize keeps the JAX package's
dense form (``paste_dense``): two interpolation matrices with two non-zero
taps per row and two float32 matrix products, which need full float32
(the route refuses TF32 matmuls on CUDA).  On CUDA kernel K5
(``csrc/paste.cu``) reads the tables and computes the same bits per
pixel, summing the taps as cuBLAS's float32 products sum them, with
``> 0.5``, the validity mask and the semantic map in one pass.

The scoring helpers of the device-scored evaluation sweep
(``eval/sweep.py``) live here too: ``pack_mask_bits`` /
``unpack_mask_bits`` (``np.packbits`` rows, big bit order),
``mask_iou_single`` / ``mask_iou_batch`` (the det-vs-GT mask IoU matrix)
and ``semantic_confusion`` (per-image confusion totals).  Their products
contract 0/1 operands in float32 with float32 results: every product is
exact and every sum an integer below 2^24, so the counts are exact and
the IoU is bit-identical to the host popcount
(``eval/voc_eval.packed_overlaps``).  (A product of two bfloat16 tensors
would *return* bfloat16 and round any count above 256.)
"""

from __future__ import annotations

from typing import Tuple

import torch

from dis_yolo_tpu_torch.ops import custom_ops
from dis_yolo_tpu_torch.utils.profiling import count, span


def letterbox_params(image_h: int, image_w: int, net_h: int, net_w: int
                     ) -> Tuple[float, float, float, float]:
    """Static (x_off, x_scale, y_off, y_scale) of the letterbox window."""
    if (float(net_w) / image_w) < (float(net_h) / image_h):
        new_w = net_w
        new_h = (image_h * net_w) // image_w
    else:
        new_h = net_h
        new_w = (image_w * net_h) // image_h
    return (float((net_w - new_w) // 2) / net_w, float(new_w) / net_w,
            float((net_h - new_h) // 2) / net_h, float(new_h) / net_h)


def correct_boxes_device(boxes_norm: torch.Tensor, image_h: int, image_w: int,
                         net_h: int, net_w: int) -> torch.Tensor:
    """[..., (y1,x1,y2,x2)] normalized letterboxed -> int32 original px."""
    x_off, x_scale, y_off, y_scale = letterbox_params(image_h, image_w,
                                                      net_h, net_w)
    y = torch.round((boxes_norm[..., [0, 2]] - y_off) / y_scale * image_h)
    x = torch.round((boxes_norm[..., [1, 3]] - x_off) / x_scale * image_w)
    if boxes_norm.is_cuda:
        # each list index above goes to the card with a stream sync
        count("sync.paste", 2)
    y = torch.clamp(y, 0, image_h).to(torch.int32)
    x = torch.clamp(x, 0, image_w).to(torch.int32)
    return torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], dim=-1)


def _axis_taps(out_size: int, lo_px: torch.Tensor, hi_px: torch.Tensor,
               crop_lo: torch.Tensor, crop_hi: torch.Tensor, mask_size: int):
    """Per-output-pixel source taps along one axis, for [...] boxes.

    Returns (i0, i1, w, inside), each [..., out_size]: the absolute
    score-map indices of the two taps, the lerp weight of tap 1 and the
    inside-box indicator.  Every step is elementwise, so a position's taps
    do not depend on what else is computed beside them.
    """
    pos = torch.arange(out_size, dtype=torch.int32, device=lo_px.device)
    lo, hi = lo_px[..., None], hi_px[..., None]
    c_lo, c_hi = crop_lo[..., None], crop_hi[..., None]
    inside = (pos >= lo) & (pos < hi)
    box_len = torch.clamp_min(hi - lo, 1)
    crop_len = c_hi - c_lo                        # may be <= 0: degenerate
    dst = (pos - lo).float()
    src = (dst + 0.5) * crop_len.float() / box_len.float() - 0.5
    hi_tap = torch.clamp_min(crop_len - 1, 0)
    i0 = torch.minimum(torch.clamp_min(torch.floor(src).to(torch.int32), 0),
                       hi_tap)
    i1 = torch.minimum(torch.clamp_min(i0 + 1, 0), hi_tap)
    w = torch.clamp(src - i0.float(), 0.0, 1.0)
    i0 = torch.clamp(c_lo + i0, 0, mask_size - 1)
    i1 = torch.clamp(c_lo + i1, 0, mask_size - 1)
    return i0, i1, w, inside & (crop_len > 0)


def _axis_matrix(taps, mask_size: int) -> torch.Tensor:
    """Dense one-axis interpolation matrices [..., out_size, mask_size]
    from ``_axis_taps``' tables: row p holds output pixel p's two bilinear
    tap weights (zeros outside the pasted box); coinciding taps sum to
    (1-w) + w."""
    i0, i1, w, inside = taps
    iota = torch.arange(mask_size, dtype=torch.int32, device=i0.device)
    m = ((iota == i0[..., None]) * (1.0 - w)[..., None]
         + (iota == i1[..., None]) * w[..., None])
    return m * inside[..., None]


def _check_precision(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("mask paste needs float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def paste_taps(dets: torch.Tensor, mask_size: int, image_h: int,
               image_w: int, net_size: int):
    """The arithmetic both routes share: dets [..., D, 6] -> (valid
    [..., D], taps), ``taps`` the tables (i0, i1, w, inside) of
    ``_axis_taps`` for both axes at once, each [..., D, 2, L]: axis 0 the
    photo's rows, axis 1 its columns, positions up to L = max(image_h,
    image_w) (``axis_tables`` cuts each axis to its length).

    Validity drops zero-score padding rows and boxes degenerate in
    original pixels.
    """
    box_px = correct_boxes_device(dets[..., :4], image_h, image_w,
                                  net_size, net_size)
    valid = (dets[..., 5] > 0.0) & (
        (box_px[..., 2] - box_px[..., 0])
        * (box_px[..., 3] - box_px[..., 1]) > 0)
    # crop window in score-map pixels
    crop = torch.round(dets[..., :4].float() * mask_size).to(torch.int32)
    taps = _axis_taps(max(image_h, image_w), box_px[..., :2], box_px[..., 2:],
                      crop[..., :2], crop[..., 2:], mask_size)
    return valid, taps


def axis_tables(taps, axis: int, size: int):
    """One axis of ``paste_taps``' tables: (i0, i1, w, inside), each
    [..., D, size] (axis 0 rows, 1 columns)."""
    return tuple(t[..., axis, :size] for t in taps)


def paste_dense(masks: torch.Tensor, taps, valid: torch.Tensor,
                image_h: int, image_w: int) -> torch.Tensor:
    """The dense route, the CPU's and the oracle K5 is held against:
    crop, bilinear resize, > 0.5 and paste as rowM [H0,S] @ mask [S,S] @
    colM.T [S,W0] in float32, then the validity mask."""
    s = masks.shape[-1]
    rowm = _axis_matrix(axis_tables(taps, 0, image_h), s)     # [..., H0, S]
    colm = _axis_matrix(axis_tables(taps, 1, image_w), s)     # [..., W0, S]
    _check_precision(masks)
    full = torch.matmul(torch.matmul(rowm, masks),
                        colm.transpose(-1, -2)) > 0.5
    # the float32 products and the tap matrices are freed before the
    # masking allocates its output: they set the paste's peak memory
    del rowm, colm
    return full & valid[..., None, None]


def _class_ids(classids: torch.Tensor) -> torch.Tensor:
    return torch.clamp(classids.to(torch.int32), 0, 255)


def paste_masks_plain(masks: torch.Tensor, taps, valid: torch.Tensor,
                      cls: torch.Tensor, image_h: int, image_w: int,
                      semantic: bool):
    """K5's plain version, the CPU route: the dense paste (span
    ``paste.gemm``) and, with ``semantic``, the semantic map (span
    ``paste.semantic``) -> (full, sem or None).  ``cls`` [..., D] int32
    in [0, 255]."""
    with span("paste.gemm"):
        full = paste_dense(masks, taps, valid, image_h, image_w)
    if not semantic:
        return full, None
    with span("paste.semantic"):
        return full, merged_semantic_single(full, cls, valid)


@custom_ops.paste_masks_op.register_kernel("cpu")
def _(masks, i0, i1, w, inside, valid, cls, out_h, out_w, semantic):
    full, sem = paste_masks_plain(masks, (i0, i1, w, inside), valid, cls,
                                  out_h, out_w, semantic)
    if sem is None:
        sem = full.new_empty((full.shape[0], 0, 0), dtype=torch.uint8)
    return full, sem


def _paste(masks: torch.Tensor, dets: torch.Tensor, image_h: int,
           image_w: int, net_size: int, semantic: bool):
    with span("paste.taps"):
        valid, taps = paste_taps(dets, masks.shape[-1], image_h, image_w,
                                 net_size)
        cls = _class_ids(dets[..., 4])
    if not masks.is_cuda:
        # called directly, not through the operator, so that the CPU
        # route's spans sit beside ``paste.taps`` under the caller
        full, sem = paste_masks_plain(masks, taps, valid, cls, image_h,
                                      image_w, semantic)
        return full, valid, sem
    with span("paste.k5"):
        full, sem = custom_ops.paste_masks_cuda(
            masks, taps, valid, cls, image_h, image_w, semantic)
    return full, valid, sem


def paste_masks_single(masks: torch.Tensor, dets: torch.Tensor,
                       image_h: int, image_w: int, net_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masks [..., D, S, S] sigmoid + dets [..., D, 6] -> (full-res bool
    masks [..., D, image_h, image_w], valid [..., D]): crop, bilinear
    resize, > 0.5 and paste.  The tables of both axes are the span
    ``paste.taps`` (``utils/profiling.py``); on CUDA kernel K5 pastes
    (``custom_ops.paste_masks_cuda``, the span ``paste.k5``), on the CPU
    the dense route (``paste_masks_plain``, the span ``paste.gemm``).
    """
    full, valid, _ = _paste(masks, dets, image_h, image_w, net_size, False)
    return full, valid


def merged_semantic_single(full_masks: torch.Tensor, classids: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Semantic map [..., H, W] uint8 from [..., D, H, W] masks: paint
    classid+1 per detection in order, later detections overwrite earlier.

    One max-reduction: enc = (d+1)*256 + cls orders by detection index
    first, and the winner's class is enc & 255.
    """
    d = full_masks.shape[-3]
    cls = _class_ids(classids)
    order = torch.arange(1, d + 1, dtype=torch.int32, device=cls.device)
    enc = ((order * 256 + cls) * valid.to(torch.int32))[..., None, None]
    win = torch.amax(torch.where(full_masks, enc, 0), dim=-3)
    return torch.where(win > 0, (win & 255) + 1, 0).to(torch.uint8)


def paste_masks_batch(masks: torch.Tensor, dets: torch.Tensor,
                      image_h: int, image_w: int, net_size: int):
    """[B,D,S,S] + [B,D,6] -> (bool [B,D,H0,W0], valid [B,D],
    semantic [B,H0,W0] uint8).  On CUDA K5 writes the semantic map in the
    same pass as the masks; on the CPU it is the span
    ``paste.semantic``."""
    return _paste(masks, dets, image_h, image_w, net_size, True)


def pack_mask_bits(m: torch.Tensor) -> torch.Tensor:
    """``np.packbits(m, axis=-1)`` (bitorder 'big'): bool [..., W] ->
    uint8 [..., ceil(W/8)], the last byte's pad bits zero."""
    w = m.shape[-1]
    pad = -w % 8
    if pad:
        m = torch.nn.functional.pad(m.to(torch.uint8), (0, pad))
    m8 = m.reshape(m.shape[:-1] + ((w + pad) // 8, 8)).to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=m.device)
    return torch.bitwise_left_shift(m8, shifts).sum(-1).to(torch.uint8)


def unpack_mask_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of ``pack_mask_bits``: uint8 [..., ceil(W/8)] -> bool
    [..., W] (``np.unpackbits(..., count=W)``)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = torch.bitwise_right_shift(packed[..., None], shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return bits[..., :width].to(torch.bool)


def _count_products(a: torch.Tensor, b: torch.Tensor,
                    chunk: int = 4096) -> torch.Tensor:
    """a [..., M, P] x b [..., N, P] (float32 0/1) -> [..., M, N] float32
    counts, exact below 2^24.  The contraction is cut into chunks of
    ``chunk`` pixels, one batched product per chunk, summed after: a
    single product with a contraction as long as a 720 x 960 image runs
    on a handful of thread blocks on the card."""
    p = a.shape[-1]
    c = -(-p // chunk)
    if c > 1:
        pad = c * chunk - p
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, pad))
        a = a.unflatten(-1, (c, chunk)).transpose(-2, -3)    # [..., c, M, k]
        b = b.unflatten(-1, (c, chunk)).transpose(-2, -3)    # [..., c, N, k]
        return torch.matmul(a, b.transpose(-1, -2)).sum(-3)
    return torch.matmul(a, b.transpose(-1, -2))


def mask_iou_single(full_masks: torch.Tensor, gt_packed: torch.Tensor,
                    gt_areas: torch.Tensor) -> torch.Tensor:
    """Det-vs-GT mask IoU matrix: full_masks bool [..., D, H, W] (pasted
    detections), gt_packed uint8 [..., G, H, ceil(W/8)], gt_areas float32
    [..., G] (exact pixel counts) -> float32 [..., D, G].

    Bit-identical to ``eval.voc_eval.packed_overlaps``: the intersections
    are float32 products of 0/1 operands (exact, sums below 2^24), and
    the final division sees the same integers.
    """
    w = full_masks.shape[-1]
    gt = unpack_mask_bits(gt_packed, w)                       # [..., G, H, W]
    det_f = full_masks.flatten(-2).to(torch.float32)          # [..., D, HW]
    gt_f = gt.flatten(-2).to(torch.float32)                   # [..., G, HW]
    inter = _count_products(det_f, gt_f)                      # [..., D, G]
    det_area = full_masks.flatten(-2).sum(-1, dtype=torch.int32).to(
        torch.float32)
    union = det_area[..., :, None] + gt_areas[..., None, :] - inter
    # empty/empty pairs (union 0) are never read: zero-area GTs are
    # dropped at rasterization and zero-area detections are invalid
    return inter / torch.clamp_min(union, 1.0)


def mask_iou_batch(full_masks: torch.Tensor, gt_packed: torch.Tensor,
                   gt_areas: torch.Tensor) -> torch.Tensor:
    """``mask_iou_single`` over a batch: [B,D,H,W] x [B,G,H,Wb] x [B,G]
    -> [B,D,G]."""
    return mask_iou_single(full_masks, gt_packed, gt_areas)


def semantic_confusion(pred_sem: torch.Tensor, gt_sem: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Confusion totals of semantic maps [..., H, W] -> int32 [..., n, n]
    with conf[true, pred] = |{px: gt == true and pred == pred}|, equal to
    the host bincount (``Evaluator.miou``): one-hot planes contracted in
    float32, exact below 2^24 pixels."""
    labels = torch.arange(n, dtype=torch.int32, device=pred_sem.device)
    t1 = (gt_sem.flatten(-2).to(torch.int32)[..., None, :]
          == labels[:, None]).to(torch.float32)                # [..., n, HW]
    p1 = (pred_sem.flatten(-2).to(torch.int32)[..., None, :]
          == labels[:, None]).to(torch.float32)
    return _count_products(t1, p1).to(torch.int32)
