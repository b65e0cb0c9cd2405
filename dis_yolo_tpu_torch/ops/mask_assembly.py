"""Position-sensitive mask assembly as a closed-form gather (PyTorch
counterpart of ``dis_yolo_tpu/ops/mask_assembly.py``).

Per box, already rounded to score-map pixels, each axis is split into k
bins with grid lines ``g0 = lo, g_i = round(lo + i*(hi-lo)/k), g_k = hi``
(round = ties-to-even); pixel (r, c) inside the box takes channel
``row_bin*k + col_bin`` of the ``[S, S, k*k]`` score map.  Outside the box
the logit is 0.  The batch and box dimensions are written out (no vmap).
"""

from __future__ import annotations

import torch


def _grid_lines(lo: torch.Tensor, hi: torch.Tensor, k: int) -> torch.Tensor:
    """Bin edges [..., k+1] per axis; lo/hi [...] are already-rounded floats."""
    sub = (hi - lo) / k
    inner = [torch.round(lo + i * sub) for i in range(1, k)]
    return torch.stack([lo] + inner + [hi], dim=-1).to(torch.int32)


def bin_index_1d(size: int, lines: torch.Tensor, k: int):
    """Per-pixel bin id [..., size] and inside indicator [..., size] for
    grid lines [..., k+1]."""
    pos = torch.arange(size, dtype=torch.int32, device=lines.device)
    lines = lines[..., None]
    b = torch.zeros(lines.shape[:-2] + (size,), dtype=torch.int32,
                    device=lines.device)
    for i in range(1, k):
        b = b + (pos >= lines[..., i, :]).to(torch.int32)
    inside = (pos >= lines[..., 0, :]) & (pos < lines[..., k, :])
    return torch.clamp(b, max=k - 1), inside


def _assemble_px(scoremaps: torch.Tensor, boxes_px: torch.Tensor, k: int):
    """[B,S,S,k*k] + rounded px boxes [B,D,4] -> (logits [B,D,S,S], inside)."""
    bsz, s = scoremaps.shape[0], scoremaps.shape[1]
    d = boxes_px.shape[1]
    gy = _grid_lines(boxes_px[..., 0], boxes_px[..., 2], k)      # [B,D,k+1]
    gx = _grid_lines(boxes_px[..., 1], boxes_px[..., 3], k)
    row_bin, row_in = bin_index_1d(s, gy, k)                     # [B,D,S]
    col_bin, col_in = bin_index_1d(s, gx, k)
    kidx = row_bin[..., :, None] * k + col_bin[..., None, :]     # [B,D,S,S]
    inside = row_in[..., :, None] & col_in[..., None, :]
    sm = scoremaps[:, None].expand(bsz, d, s, s, scoremaps.shape[-1])
    picked = torch.gather(sm, -1, kidx[..., None].long())[..., 0]
    return torch.where(inside, picked, 0.0), inside


def assemble_bwd_plain(boxes_px: torch.Tensor, g: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Gradient of ``_assemble_px``'s logits w.r.t. the score maps:
    rounded px boxes [B,R,4] + upstream gradient [B,R,S,S] ->
    [B,S,S,k*k], ``out[..., ky*k+kx] = sum_d g[d] * row_d[ky] x col_d[kx]``.

    ROI by ROI in ascending ``d``, starting from zeros, as the TPU
    backward kernel accumulates (``_assembly_bwd_kernel``), so the sums
    round in the same order.  The plain version of kernel K3 and its CPU
    path.
    """
    bsz, r, s = g.shape[0], g.shape[1], g.shape[2]
    kk = k * k
    gy = _grid_lines(boxes_px[..., 0], boxes_px[..., 2], k)      # [B,R,k+1]
    gx = _grid_lines(boxes_px[..., 1], boxes_px[..., 3], k)
    row_bin, row_in = bin_index_1d(s, gy, k)                     # [B,R,S]
    col_bin, col_in = bin_index_1d(s, gx, k)
    channels = torch.arange(kk, dtype=torch.int32, device=g.device)
    dtype = torch.promote_types(g.dtype, torch.float32)
    out = torch.zeros((bsz, s, s, kk), dtype=dtype, device=g.device)
    for d in range(r):
        kidx = row_bin[:, d, :, None] * k + col_bin[:, d, None, :]  # [B,S,S]
        inside = row_in[:, d, :, None] & col_in[:, d, None, :]
        hit = (kidx[..., None] == channels) & inside[..., None]
        out = out + torch.where(hit, g[:, d, :, :, None].to(dtype), 0.0)
    return out


def assemble_mask_single(scoremap: torch.Tensor, box_yxyx_px: torch.Tensor,
                         k: int) -> torch.Tensor:
    """One instance-mask logit map: scoremap [S,S,k*k], box [4] rounded
    px -> [S,S] logits (zero outside the box)."""
    return _assemble_px(scoremap[None], box_yxyx_px[None, None], k)[0][0, 0]


def box_inside_mask(box_yxyx_px: torch.Tensor, size: int) -> torch.Tensor:
    """Inside-box indicator [..., S, S] (float32) = sum of all k^2 cell
    masks, for rounded px boxes [..., 4]."""
    pos = torch.arange(size, dtype=torch.float32, device=box_yxyx_px.device)
    rows = (pos >= box_yxyx_px[..., 0, None]) & (pos < box_yxyx_px[..., 2, None])
    cols = (pos >= box_yxyx_px[..., 1, None]) & (pos < box_yxyx_px[..., 3, None])
    return (rows[..., :, None] & cols[..., None, :]).float()


def assemble_masks(scoremap: torch.Tensor, boxes_norm: torch.Tensor,
                   k: int) -> torch.Tensor:
    """One image: scoremap [S,S,k*k] + normalized yxyx boxes [D,4] ->
    [D,S,S] logits (all-zero padding rows give empty masks)."""
    return assemble_masks_batch(scoremap[None], boxes_norm[None], k,
                                apply_sigmoid=False)[0]


def assemble_masks_batch(scoremaps: torch.Tensor, boxes_norm: torch.Tensor,
                         k: int, apply_sigmoid: bool = True) -> torch.Tensor:
    """[B,S,S,k*k] + [B,D,4] -> [B,D,S,S].

    Like the JAX gather path, ``apply_sigmoid`` maps every pixel through
    the sigmoid, so pixels outside the box read sigmoid(0) = 0.5; the
    serving path (``ops.cuda_assembly``) writes exact 0 there instead.
    """
    s = scoremaps.shape[1]
    boxes_px = torch.round(boxes_norm.float() * s)
    out, _ = _assemble_px(scoremaps, boxes_px, k)
    if apply_sigmoid:
        out = torch.sigmoid(out)
    return out
