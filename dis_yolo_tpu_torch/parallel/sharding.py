"""The data-parallel mesh and the placement of batches and replicated
state (the counterpart of ``dis_yolo_tpu/parallel/sharding.py``).

A ``Mesh`` is one process's view of a 1-D ``dp`` axis: the process
group, this process's rank and the group's size, and its device.  A
global batch of B rows splits into equal contiguous parts in rank order
(``Mesh.rows``), as ``NamedSharding(P("dp"))`` splits it over a JAX
mesh; a ``[K, B, ...]`` block of K steps splits along dim 1.  Replicated
state (the model, the optimizer) lives whole on every rank and is kept
equal by computing the same update everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from dis_yolo_tpu_torch.parallel.distributed import broadcast_


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``group`` None is the default process group (or none at all: a
    one-process mesh, whose collectives are identities)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    axis_name: str = "dp"

    def rows(self, n: int) -> slice:
        """This rank's rows of a global dimension of ``n``; raises
        ValueError when the mesh does not divide it."""
        if n % self.size:
            raise ValueError(f"global batch {n} not divisible by the mesh's "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(device=None, axis_name: str = "dp",
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of ``group`` (default: every process) on this process's
    device: ``device`` as given, else the current CUDA device (raises
    without a card).  Without a process group, a one-process mesh."""
    if device is None or torch.device(device) == torch.device("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "for a mesh of CPU processes")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if dist.is_initialized():
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        rank, size = 0, 1
    return Mesh(group, rank, size, device, axis_name)


def _rows_of(mesh: Mesh, x, dim: int):
    x = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    index = [slice(None)] * dim + [mesh.rows(x.shape[dim])]
    return x[tuple(index)].to(mesh.device)


def shard_batch(mesh: Mesh, batch: Dict) -> Dict[str, torch.Tensor]:
    """This rank's rows (dim 0) of a global batch, on its device."""
    return {k: _rows_of(mesh, v, 0) for k, v in batch.items()}


def shard_stacked(mesh: Mesh, block: Dict) -> Dict[str, torch.Tensor]:
    """This rank's rows (dim 1) of a ``[K, B, ...]`` block of K steps, on
    its device: dim 0 is the steps, unsharded."""
    return {k: _rows_of(mesh, v, 1) for k, v in block.items()}


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, mesh)
    return module
