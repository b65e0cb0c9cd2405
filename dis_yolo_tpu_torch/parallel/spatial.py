"""Spatial partitioning: the image height split over the ranks of an
``sp`` axis (the counterpart of ``dis_yolo_tpu/parallel/spatial.py``).

In the JAX package three jitted wrappers put sharding constraints on the
images ``[dp?, H:sp, W, C]`` and on the replicated outputs, and GSPMD
partitions the one-device program: it inserts every conv's halo
exchange and its transpose, reduces BatchNorm's moments across shards
and gathers around the per-image tail, so the step is the one-device
math by construction.

PyTorch has no such partitioner (DTensor's convolution shards only the
last dimension, at stride 1), so the port builds what GSPMD built, one
process per device as in data parallelism:

  * a ``dp x sp`` grid of processes (``sharding.Mesh2D``), a process
    group per row and per column;
  * a row partition at the coarsest stride, 32, that every finer stride
    scales, so a rank's rows stay its own through the stride-2 convs,
    the upsamples and the skip concats (``sharding.HeightShard``);
  * at every conv, the rows its window needs from their owners and SAME's
    zeros only at the image's edges (``distributed.exchange_rows``: the
    backward returns the halo's cotangent to its owner);
  * train-mode BatchNorm summing ``x``, ``x^2`` and the count over the
    whole grid (``layers.batch_norm_train``), so unequal shards weigh by
    their rows;
  * the four raw outputs gathered whole on every sp rank
    (``distributed.all_gather_rows``; its backward keeps the rank's own
    slice, so the loss that every sp rank computes counts once);
  * the gradients summed over sp and averaged over dp in the step's one
    packed all-reduce (``train_step._mean_over_mesh``).

Every function takes global arrays, as the jitted JAX functions do, and
each rank takes its block: its dp rows of the batch and its sp rows of
the height.  The outputs are whole and equal on every rank (JAX's
``P()``).  They run on ``mesh.device``; a rank that owns no row of the
height still joins every collective.  Every graph and knob that JAX's
spatial functions take runs here: the serving graphs (deploy, s2d stem,
commuted decoder, int8: ``QuantConv`` exchanges int8 halo rows; the
calibration graph keeps no statistics), each ``mask_stride``, and in the
step ``remat`` (the recomputation runs the blocks' collectives again)
and ``grad_accum`` (microbatches of the global batch, as GSPMD splits
JAX's one-device program).
"""

from __future__ import annotations

from typing import Optional

import torch

from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.api import _to_device
from dis_yolo_tpu_torch.models.dis_yolo import DISYolo
from dis_yolo_tpu_torch.models.layers import height_sharded
from dis_yolo_tpu_torch.parallel.sharding import Mesh2D
from dis_yolo_tpu_torch.train import train_step as ts


def _check(model: DISYolo, mesh: Mesh2D) -> None:
    if not isinstance(mesh, Mesh2D):
        raise TypeError(f"spatial partitioning needs a Mesh2D, got {mesh!r}")
    if next(model.parameters()).device.type != mesh.device.type:
        raise ValueError(f"model on {next(model.parameters()).device}, "
                         f"mesh on {mesh.device}")


def spatial_forward(model: DISYolo, mesh: Mesh2D):
    """``run(images) -> (raw_s8, raw_s16, raw_s32, scoremaps)``: the eval
    forward of the global batch ``images`` [B, H, W, 3], each rank on its
    dp rows and its sp rows of the height; the outputs whole on every
    rank."""
    _check(model, mesh)

    def run(images):
        images = _to_device(images, mesh.device)
        model.eval()
        rows = mesh.dp.rows(images.shape[0])
        with torch.no_grad(), height_sharded(model, mesh,
                                             images.shape[1:3]) as shard:
            raws = model(images[rows, shard.image_rows()])
            return tuple(shard.gather_batch(r) for r in raws)

    return run


def spatial_predict(model: DISYolo, mesh: Mesh2D,
                    obj_thresh: Optional[float] = None):
    """``run(images, windows) -> (detections, masks)``: the conv stack
    height-sharded (``spatial_forward``), then decode, NMS, the
    degenerate-box drop and the assembly (K1 on the card) whole on every
    rank (``api.predict_from_outputs``; JAX's replicated tail)."""
    forward = spatial_forward(model, mesh)

    def run(images, windows):
        return api.predict_from_outputs(model.cfg, forward(images), windows,
                                        obj_thresh, mesh.device)

    return run


def spatial_train_step(model: DISYolo, mesh: Mesh2D):
    """``step(state, batch, generator, aug_generator=None) -> (state,
    metrics)``: the ``dp x sp`` training step on the global ``batch``
    (``train_step.make_train_step`` with a ``Mesh2D``).  Its loss,
    BatchNorm moments and gradients are the one-process step's on the
    global batch; the state stays replicated, bit-equal on every rank."""
    _check(model, mesh)
    return ts.make_train_step(model, mesh=mesh)
