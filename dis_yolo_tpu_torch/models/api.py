"""High-level model API: create / init / forward / end-to-end predict
(PyTorch counterpart of ``dis_yolo_tpu/models/api.py``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request it raises, so a
run never drifts to the CPU.  On CUDA the mask assembly launches its
hand-written kernel K1 (the custom operator ``dis_yolo::assemble_masks``
of ``ops.custom_ops``) and, with ``cfg.use_pallas_nms``, so does NMS
(K2, ``dis_yolo::nms``); on the CPU both run their plain PyTorch
versions.  ``cfg.use_pallas_assembly=False`` assembles with the JAX
package's gather formulation instead (``ops.mask_assembly``): the
sigmoid of every pixel, so 0.5 outside the box on valid rows, and 0 on
padding rows.

The serving graphs (``deploy``, ``quant``, ``quant_calibrate``,
``s2d_stem``, ``decoder_commute``) run through the same entry points with
weights from ``models.fold``, ``models.s2d`` and ``models.quant``.
``predict`` assembles from the NHWC score maps, as the JAX package's
``predict`` does (it never sets ``use_extract``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models.dis_yolo import DISYolo
from dis_yolo_tpu_torch.models.layers import ConvBias, ConvBN, DeployConv
from dis_yolo_tpu_torch.models.quant import QuantConv
from dis_yolo_tpu_torch.ops import mask_assembly, nms
from dis_yolo_tpu_torch.ops.custom_ops import assemble_masks_batch_cuda
from dis_yolo_tpu_torch.ops.decode import decode_all


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when CUDA is asked for
    (explicitly or by default) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the port's plain PyTorch path on the CPU")
    return dev


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """numpy arrays are copied to ``dev``; tensors must already be there."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if x.device.type != dev.type:
        raise ValueError(f"tensor on {x.device}, expected {dev}")
    return x


def _model_device(model: DISYolo) -> torch.device:
    return next(model.parameters()).device


def create_model(cfg: DISYoloConfig, device=None) -> DISYolo:
    """``DISYolo`` in eval mode on ``device`` (weights not initialized the
    Flax way: see ``init_model``, or load a bridged state_dict)."""
    dev = resolve_device(device)
    return DISYolo(cfg).to(dev).eval()


def init_model(cfg: DISYoloConfig, seed: int = 0, device=None) -> DISYolo:
    """``create_model`` with Flax's initializers drawn from a seeded CPU
    ``torch.Generator`` (so a seed gives the same weights on every
    device): xavier-uniform conv kernels, zero biases, BN scale 1, bias 0,
    mean 0, var 1.  An int8 layer keeps the JAX package's initial values
    (``w_q`` and ``bias`` 0, ``inv_sx`` and ``s_out`` 1)."""
    model = create_model(cfg, device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in sorted(model._modules,
                           key=lambda n: int(n[len("convolutional"):])):
            layer = model._modules[name]
            if isinstance(layer, QuantConv) and not layer.calibrate:
                continue
            w = layer.conv.weight
            cout, cin, kh, kw = w.shape
            bound = (6.0 / (kh * kw * (cin + cout))) ** 0.5
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                  generator=gen))
            if isinstance(layer, (ConvBias, DeployConv, QuantConv)):
                layer.conv.bias.zero_()
            elif isinstance(layer, ConvBN):
                layer.bn.reset_parameters()
    return model


def forward(model: DISYolo, images, device=None):
    """Raw network outputs (raw_s8, raw_s16, raw_s32, scoremaps), in eval
    mode (running BN statistics) even for a model that was training."""
    dev = resolve_device(device)
    if _model_device(model).type != dev.type:
        raise ValueError(f"model on {_model_device(model)}, expected {dev}")
    model.eval()
    with torch.no_grad():
        return model(_to_device(images, dev))


def predict(model: DISYolo, images, windows,
            obj_thresh: Optional[float] = None, device=None, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full inference: images [B,H,W,3], windows [B,4] ->
    (detections [B,D,6] zero-padded, masks [B,D,S,S] sigmoid inside the
    box, 0 outside and for padding rows).

    With a ``mesh`` (``parallel.sharding.Mesh``; JAX's
    ``make_jitted_predict(mesh=...)``), ``images`` and ``windows`` are
    the global batch and each rank predicts its rows (``Mesh.rows``) on
    ``mesh.device`` with its replica of the model: the outputs are that
    rank's rows and stay on it.  Every step is per image, so nothing is
    exchanged."""
    if mesh is not None:
        rows = mesh.rows(images.shape[0])
        images, windows = images[rows], windows[rows]
        device = mesh.device
    raws = forward(model, images, device)
    return predict_from_outputs(model.cfg, raws, windows, obj_thresh, device)


def predict_from_outputs(cfg: DISYoloConfig, raws: Sequence, windows,
                         obj_thresh: Optional[float] = None, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The post-forward half of ``predict``: raw head outputs -> detections
    + assembled masks (decode, NMS, degenerate-box drop, assembly).

    ``cfg.use_pallas_assembly`` picks the assembly: K1 (exact 0 outside
    each box), or the gather formulation times validity (0.5 outside the
    box on valid rows, as the JAX package's jnp route)."""
    dev = resolve_device(device)
    raws = [_to_device(r, dev) for r in raws]
    windows = _to_device(windows, dev).float()
    # the mask-assembly pixel quantization is square-only; letterbox first
    if raws[3].shape[1] != raws[3].shape[2]:
        raise ValueError("predict requires square inputs (letterbox first); "
                         f"got score maps {tuple(raws[3].shape)}")
    with torch.no_grad():
        preds = decode_all(raws[:3], cfg)
        dets = nms.filter_detections(preds, windows, cfg, obj_thresh)
        # drop degenerate boxes whose rounded score-map extent is
        # non-positive (the reference's keep_ix)
        s = raws[3].shape[1]
        boxes_px = torch.round(dets[..., :4] * s)
        nondegenerate = ((boxes_px[..., 2] - boxes_px[..., 0] > 0)
                         & (boxes_px[..., 3] - boxes_px[..., 1] > 0))
        valid = torch.any(dets[..., :4] != 0.0, dim=-1) & nondegenerate
        dets = dets * valid[..., None]
        if cfg.use_pallas_assembly:
            # invalid rows now hold a zero box, which K1 assembles to an
            # all-zero mask: the gather route's `masks * valid` is not
            # needed
            masks = assemble_masks_batch_cuda(raws[3].float().contiguous(),
                                              dets[..., :4].contiguous(),
                                              cfg.k_map, apply_sigmoid=True)
        else:
            masks = mask_assembly.assemble_masks_batch(
                raws[3].float(), dets[..., :4], cfg.k_map)
            masks = masks * valid[..., None, None]
    return dets, masks
