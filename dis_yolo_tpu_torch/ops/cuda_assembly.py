"""Position-sensitive mask assembly on CUDA: kernels K1 (forward, with
sigmoid), K3 (backward) and K4 (channel extraction), and the
differentiable assembly of training.

Counterparts of ``dis_yolo_tpu/ops/pallas_assembly.py``: K1
(``csrc/assembly.cu``) of ``assemble_masks_batch_pallas`` and of the
training forward ``_assembly_px``, K3 (``csrc/assembly_bwd.cu``) of the
custom-VJP backward ``_assembly_bwd``, K4 (``csrc/extract.cu``) of
``_extract_planes``; each source's header says what it replaces and what
bounds it.  ``assemble_masks_cuda`` is the single-image
``assemble_masks_pallas``: its ``use_extract`` route runs K4 and then K1
on the channel planes, the default route K1 on the NHWC map; both give
the same bits.  The TPU's VMEM and layout knobs (``_extract_fits``,
``force_tiled``, ``operand_barrier``) do not change the result and are
not copied: K4 runs at every S whenever it is asked to.

Semantics are the Pallas kernel's, not the JAX gather path's: inside the
box each pixel is sigmoid(score map channel of its k x k bin); outside it
is an exact 0 (the gather path's sigmoid maps it to 0.5).  With
``apply_sigmoid=False`` the output is the raw logits, 0 outside.

Each wrapper (K1's ``custom_ops.assemble_masks_batch_cuda``,
``assemble_bwd_cuda``, ``extract_planes_cuda``) launches its kernel for
CUDA tensors and runs its plain PyTorch version only for CPU tensors;
anything else raises; each launch counts as ``kernel.k1``, ``kernel.k3``
or ``kernel.k4`` (``utils/profiling.py``).  K1's wrapper and
plain version live in ``ops.custom_ops``, where K1 is the custom
operator ``dis_yolo::assemble_masks`` (in all three modes), so that an
exported serving graph holds it.
``assemble_masks_trainable`` is the ``torch.autograd.Function`` of the
training path: K1 forward in pixel-box mode, K3 backward.
"""

from __future__ import annotations

import torch

from dis_yolo_tpu_torch.ops import _build, custom_ops
from dis_yolo_tpu_torch.ops.custom_ops import MAX_K, check_f32, on_cpu
from dis_yolo_tpu_torch.ops.mask_assembly import assemble_bwd_plain
from dis_yolo_tpu_torch.utils.profiling import count

__all__ = ("MAX_K", "MAX_ROIS", "extract_planes_plain",
           "extract_planes_cuda", "assemble_masks_cuda", "assemble_bwd_cuda",
           "assemble_masks_trainable")

MAX_ROIS = 256          # K3 keeps every ROI's grid lines in shared memory


def extract_planes_plain(sm2d: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of K4: [B,S,S*k*k] -> [B,k*k,S,S] float32
    (a view, a permute and a cast)."""
    b, s = sm2d.shape[0], sm2d.shape[1]
    return sm2d.view(b, s, s, k * k).permute(0, 3, 1, 2).float().contiguous()


def extract_planes_cuda(sm2d: torch.Tensor, k: int) -> torch.Tensor:
    """K4: head output [B,S,S*k*k] (bf16 or f32) -> channel planes
    [B,k*k,S,S] f32, ``out[b,ch,r,c] = sm2d[b,r,c*k*k+ch]``, exact
    (``extract_planes_plain`` on the CPU)."""
    if sm2d.dim() != 3 or sm2d.shape[2] != sm2d.shape[1] * k * k:
        raise ValueError(f"sm2d must be [B,S,S*{k * k}], "
                         f"got {tuple(sm2d.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if on_cpu("extract_planes_cuda", (sm2d,)):
        return extract_planes_plain(sm2d, k)
    if sm2d.dtype not in (torch.bfloat16, torch.float32) \
            or not sm2d.is_contiguous():
        raise ValueError("sm2d must be contiguous bfloat16 or float32, got "
                         f"{sm2d.dtype} contiguous={sm2d.is_contiguous()}")
    bsz, s = sm2d.shape[0], sm2d.shape[1]
    out = torch.empty((bsz, k * k, s, s), dtype=torch.float32,
                      device=sm2d.device)
    fn = _build.load("extract")
    with torch.cuda.device(sm2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sm2d.data_ptr(), out.data_ptr(), bsz, s, k * k,
                 int(sm2d.dtype == torch.bfloat16), stream)
    _build.check(err, "extract kernel launch")
    count("kernel.k4")
    return out


def assemble_masks_cuda(scoremap: torch.Tensor, boxes_norm: torch.Tensor,
                        k: int, apply_sigmoid: bool = True,
                        use_extract: bool = False) -> torch.Tensor:
    """One image: scoremap [S,S,k*k] + boxes_norm [D,4] yxyx -> [D,S,S]
    (``assemble_masks_pallas``).  bf16 and f32 score maps pass through to
    the kernel operand, other dtypes are cast to f32.  ``use_extract``
    runs K4 on the free [S, S*k*k] reshape and K1 on its channel planes;
    otherwise K1 reads the NHWC map cast to f32.  Same values either way."""
    s = scoremap.shape[0]
    if scoremap.dtype not in (torch.bfloat16, torch.float32):
        scoremap = scoremap.float()
    boxes = boxes_norm.float().contiguous()[None]
    if use_extract:
        sm2d = scoremap.contiguous().reshape(1, s, s * k * k)
        planes = extract_planes_cuda(sm2d, k)
        out = custom_ops.assemble_masks_batch_cuda(planes, boxes, k,
                                                   apply_sigmoid, planes=True)
    else:
        out = custom_ops.assemble_masks_batch_cuda(
            scoremap.float().contiguous()[None], boxes, k, apply_sigmoid)
    return out[0]


def assemble_bwd_cuda(boxes_px: torch.Tensor, g: torch.Tensor,
                      k: int) -> torch.Tensor:
    """K3: rounded px boxes [B,R,4] + upstream gradient [B,R,S,S] f32 ->
    score-map gradient [B,S,S,k*k] f32 (``assemble_bwd_plain`` on the
    CPU)."""
    if g.dim() != 4 or g.shape[2] != g.shape[3] \
            or boxes_px.shape != (g.shape[0], g.shape[1], 4):
        raise ValueError("assemble_bwd_cuda expects boxes_px [B,R,4] and g "
                         f"[B,R,S,S], got {tuple(boxes_px.shape)}, "
                         f"{tuple(g.shape)}")
    if not 1 <= k <= MAX_K or g.shape[1] > MAX_ROIS:
        raise ValueError(f"assemble_bwd_cuda supports 1 <= k <= {MAX_K} and "
                         f"R <= {MAX_ROIS}, got k={k}, R={g.shape[1]}")
    if on_cpu("assemble_bwd_cuda", (boxes_px, g)):
        return assemble_bwd_plain(boxes_px.float(), g, k)
    check_f32(boxes_px=boxes_px, g=g)
    bsz, r, s = g.shape[0], g.shape[1], g.shape[2]
    out = torch.empty((bsz, s, s, k * k), dtype=torch.float32, device=g.device)
    fn = _build.load("assembly_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes_px.data_ptr(), g.data_ptr(), out.data_ptr(), bsz, r, s,
                 k, stream)
    _build.check(err, "assembly backward kernel launch")
    count("kernel.k3")
    return out


class _AssembleTrainable(torch.autograd.Function):
    """Logits of the ROIs' assembled masks, differentiable in the score
    maps: K1 forward on pixel boxes, K3 backward (the custom VJP of
    ``assemble_masks_trainable`` in the JAX package)."""

    @staticmethod
    def forward(ctx, scoremaps, boxes_px, k):
        boxes_px = boxes_px.float().contiguous()
        ctx.save_for_backward(boxes_px)
        ctx.k = k
        # float32 (the kernels' type; a float64 model's CPU run stays in
        # float64)
        dtype = torch.promote_types(scoremaps.dtype, torch.float32)
        return custom_ops.assemble_masks_batch_cuda(
            scoremaps.to(dtype).contiguous(), boxes_px, k,
            apply_sigmoid=False, pixel_boxes=True)

    @staticmethod
    def backward(ctx, g):
        (boxes_px,) = ctx.saved_tensors
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        g_sm = assemble_bwd_cuda(boxes_px, g.contiguous(), ctx.k)
        # rounding killed the boxes' gradient in the gather formulation
        return g_sm, torch.zeros_like(boxes_px), None


def assemble_masks_trainable(scoremaps: torch.Tensor, boxes_px: torch.Tensor,
                             k: int) -> torch.Tensor:
    """[B,S,S,k*k] score maps (+grad) + [B,R,4] rounded yxyx px boxes
    (zero gradient) -> [B,R,S,S] logits, 0 outside each box."""
    return _AssembleTrainable.apply(scoremaps, boxes_px, k)
