"""Serving export: the predict graph as a self-contained artifact (the
counterpart of ``dis_yolo_tpu/export.py``).

``torch.export`` traces the whole inference program (forward -> decode
-> NMS -> assembly, ``models/api.predict``) with the model's weights
inside, into an ``ExportedProgram``.  NMS's fixpoint loop and its
shortfall fallback are graph operators (``ops/nms.py``); kernels K1 and
K2 are the custom operators ``dis_yolo::assemble_masks`` and
``dis_yolo::nms`` (``ops/custom_ops.py``), one node each.  Loading and
serving needs torch and ``ops.custom_ops`` only: no model code, no
checkpoint, no graph rebuild.

Artifact layout (``<path>.pt2`` + ``<path>.json``):

- the ``ExportedProgram``, written by ``torch.export.save``;
- a JSON sidecar with the JAX package's keys (``format_version``,
  ``in_shapes`` and ``out_shapes`` with a dynamic batch written as its
  name, ``obj_thresh``, ``config``), and ``torch_version`` and
  ``device`` where the JAX package has ``jax_version`` and
  ``platforms``.

Two of the JAX package's refusals have no cause here.  Its Pallas
assembly exists only on a TPU and cannot lower under a symbolic batch,
so it refuses ``pallas=True`` off the TPU and with a symbolic batch.  K1
is a custom operator with a CPU and a CUDA registration that takes the
batch at launch, so the port's artifacts keep K1 on every device and at
a dynamic batch; ``pallas=False`` exports the gather formulation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

# registers dis_yolo::assemble_masks and dis_yolo::nms, which an
# exported graph calls
from dis_yolo_tpu_torch.ops import custom_ops  # noqa: F401

FORMAT_VERSION = 1
TRACE_BATCH = 2         # a dimension traced at 1 is specialized to 1


class _Serve(torch.nn.Module):
    """forward + ``predict_from_outputs``: (images [B,S,S,3] f32, windows
    [B,4] f32) -> (detections [B,D,6], masks [B,D,S',S'])."""

    def __init__(self, model, cfg, obj_thresh, device):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.obj_thresh = obj_thresh
        self.device = device

    def forward(self, images, windows):
        from dis_yolo_tpu_torch.models import api
        raws = self.model(images)
        return api.predict_from_outputs(self.cfg, raws, windows,
                                        self.obj_thresh, self.device)


def export_predict(cfg, model, batch_size: "int | str" = 1,
                   obj_thresh: Optional[float] = None, device=None,
                   pallas: Optional[bool] = None
                   ) -> "torch.export.ExportedProgram":
    """Trace forward + ``predict_from_outputs`` with ``model``'s weights
    inside (deploy-folded for ``cfg.deploy``, int8 for ``cfg.quant``).

    ``device`` (default ``cuda``) is where the model lies and the
    artifact runs.  ``batch_size`` may be a name (e.g. ``"b"``): the
    artifact then serves any batch size (the reference graph's ``[None,
    ...]`` image placeholder); it is traced at ``TRACE_BATCH``.  The
    image size stays static.  ``pallas`` picks the assembly: K1 (True),
    the gather formulation (False), or, by default, K1 when ``device`` is
    CUDA and ``cfg.use_pallas_assembly`` is set.
    """
    from dis_yolo_tpu_torch.models import api

    dev = api.resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"model on {next(model.parameters()).device}, "
                         f"expected {dev}")
    if pallas is None:
        pallas = dev.type == "cuda" and cfg.use_pallas_assembly
    run_cfg = cfg.replace(use_pallas_assembly=bool(pallas))
    symbolic = isinstance(batch_size, str)
    b = TRACE_BATCH if symbolic else int(batch_size)
    size = cfg.test_size
    images = torch.zeros((b, size, size, 3), dtype=torch.float32, device=dev)
    windows = torch.tensor([[0.0, 0.0, 1.0, 1.0]] * b, device=dev)
    dynamic = None
    if symbolic:
        dim = torch.export.Dim(batch_size, min=1)
        dynamic = {"images": {0: dim}, "windows": {0: dim}}
    model.eval()
    with torch.no_grad():
        ep = torch.export.export(
            _Serve(model, run_cfg, obj_thresh, dev),
            (images, windows), dynamic_shapes=dynamic)
    _drop_metadata_asserts(ep)
    # torch.export keeps no Dim names; save_artifact writes this one
    ep.batch_dim_name = batch_size if symbolic else None
    return ep


_ASSERT_METADATA = torch.ops.aten._assert_tensor_metadata.default


def _drop_metadata_asserts(ep: "torch.export.ExportedProgram") -> int:
    """Erase the ``aten._assert_tensor_metadata`` nodes (they have no
    users) from every graph of ``ep``; returns how many.  ``torch.export``
    writes one per dtype cast it traces (262 at full width), each a host
    dispatch on every call of the loaded program that re-checks the
    dtype of a tensor the graph itself made; the inputs' guards stay."""
    n = 0
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in list(gm.graph.nodes):
                if node.target is _ASSERT_METADATA:
                    gm.graph.erase_node(node)
                    n += 1
            gm.recompile()
    return n


def _shapes(nodes, names: Dict[str, str]):
    return [[d if isinstance(d, int) else names.get(str(d), str(d))
             for d in n.meta["val"].shape] for n in nodes]


def save_artifact(ep: "torch.export.ExportedProgram", path: str, cfg,
                  obj_thresh: Optional[float] = None,
                  extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<path>.pt2`` + ``<path>.json``; returns the blob path."""
    blob_path = path + ".pt2"
    os.makedirs(os.path.dirname(os.path.abspath(blob_path)), exist_ok=True)
    torch.export.save(ep, blob_path)
    inputs = [n for n in ep.graph.nodes if n.op == "placeholder"
              and n.name in ep.graph_signature.user_inputs]
    outputs = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    names = {}
    batch = getattr(ep, "batch_dim_name", None)
    if batch is not None:
        names[str(inputs[0].meta["val"].shape[0])] = batch
    meta = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": inputs[0].meta["val"].device.type,
        "in_shapes": _shapes(inputs, names),
        "out_shapes": _shapes(outputs, names),
        "obj_thresh": obj_thresh,
        "config": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(cfg).items()},
    }
    meta.update(extra_meta or {})
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return blob_path


def load_artifact(path: str) -> Tuple[Callable, Dict[str, Any]]:
    """Load ``<path>.pt2`` (+ ``.json``) -> (callable, meta dict).

    The callable is ``run(images [B,S,S,3] f32, windows [B,4] f32) ->
    (detections [B,D,6], masks [B,D,S',S'])`` on the artifact's device,
    without gradients; inputs of other shapes than the exported ones
    raise.  Needs torch and ``ops.custom_ops`` only."""
    module = torch.export.load(path + ".pt2").module()
    module.requires_grad_(False)
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)

    def run(images: torch.Tensor, windows: torch.Tensor):
        with torch.no_grad():
            return module(images, windows)

    return run, meta
