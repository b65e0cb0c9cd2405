"""The meshes and the placement of batches, image rows and replicated
state (the counterpart of ``dis_yolo_tpu/parallel/sharding.py``).

A ``Mesh`` is one process's view of a 1-D ``dp`` axis: the process
group, this process's rank and the group's size, and its device.  A
global batch of B rows splits into equal contiguous parts in rank order
(``Mesh.rows``), as ``NamedSharding(P("dp"))`` splits it over a JAX
mesh; a ``[K, B, ...]`` block of K steps splits along dim 1.  Replicated
state (the model, the optimizer) lives whole on every rank and is kept
equal by computing the same update everywhere.

A ``Mesh2D`` is one process's view of a ``dp x sp`` grid of processes
(``make_mesh_2d``): a ``Mesh`` for its row of the grid (``sp``: the
ranks that share its images and split their height), one for its column
(``dp``: the ranks that share its height rows and split the batch) and
one for the whole grid (``world``).  World rank ``d * sp + s`` is grid
position (d, s), JAX's ``devices.reshape(dp, sp)`` of a ``("dp", "sp")``
mesh.  A 1-D ``sp`` mesh is the case dp = 1.

The image height splits at the network's coarsest stride
(``ROW_STRIDE``, 32; ``row_partition``): a rank that owns rows [a, b) of
the stride-32 grid owns rows [a * 32 / s, b * 32 / s) of every stride-s
tensor, so its rows stay its own through the stride-2 convs, the 2x
upsamples and the skip concats.  Rows that do not divide go to the first
ranks; a rank may own none.  ``HeightShard`` is that partition for one
image size, with the halo exchange and the gather of the raw outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from dis_yolo_tpu_torch.parallel.distributed import (all_gather_rows,
                                                     broadcast_,
                                                     exchange_rows,
                                                     gather_exact)

ROW_STRIDE = 32


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


# ------------------------------------------------------ spatial partitioning

@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This process's place in a ``dp x sp`` grid: its column ``dp``,
    its row ``sp`` and the whole grid ``world`` (module docstring)."""

    dp: Mesh
    sp: Mesh
    world: Mesh

    @property
    def device(self) -> torch.device:
        return self.world.device


def make_mesh_2d(dp: int, sp: int, device=None) -> Mesh2D:
    """The ``dp x sp`` grid of every process of the default group (their
    number must be ``dp * sp``; one process without a group is the 1 x 1
    grid).  Every process must call it, with the same sizes: each row's
    and each column's group is made on every process, in the same
    order."""
    world = make_mesh(device, "world")
    if world.size != dp * sp:
        raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} processes, "
                         f"got {world.size}")
    d, s = divmod(world.rank, sp)
    if world.size == 1:
        one = lambda name: Mesh(None, 0, 1, world.device, name)
        return Mesh2D(one("dp"), one("sp"), world)
    rows = [dist.new_group([r * sp + c for c in range(sp)])
            for r in range(dp)]
    cols = [dist.new_group([r * sp + c for r in range(dp)])
            for c in range(sp)]
    return Mesh2D(Mesh(cols[s], d, dp, world.device, "dp"),
                  Mesh(rows[d], s, sp, world.device, "sp"), world)


def row_partition(rows: int, size: int):
    """[(start, stop)] of each of ``size`` ranks over ``rows`` rows, in
    rank order: the first ``rows % size`` ranks take one row more, so the
    ranks without a row are the last ones."""
    base, extra = divmod(rows, size)
    out, at = [], 0
    for r in range(size):
        n = base + (r < extra)
        out.append((at, at + n))
        at += n
    return out


@dataclasses.dataclass(frozen=True)
class HeightShard:
    """The row partition of images of ``height`` x ``width`` over
    ``mesh.sp`` (module docstring), with the exchanges of the layers that
    run on it.  A tensor's stride is read from its width, which is never
    split."""

    mesh: Mesh2D
    height: int
    width: int

    def __post_init__(self):
        if self.height % ROW_STRIDE or self.width % ROW_STRIDE:
            raise ValueError(f"spatial partitioning needs image sides that "
                             f"are multiples of {ROW_STRIDE}, got "
                             f"{self.height} x {self.width}")

    def ranges(self, width: int):
        """(global rows, [(start, stop)] of every sp rank) of a tensor
        whose width is ``width``."""
        stride = self.width // width
        scale = ROW_STRIDE // stride
        parts = row_partition(self.height // ROW_STRIDE, self.mesh.sp.size)
        return self.height // stride, [(a * scale, b * scale)
                                        for a, b in parts]

    def image_rows(self) -> slice:
        """This rank's rows of the image."""
        a, b = self.ranges(self.width)[1][self.mesh.sp.rank]
        return slice(a, b)

    def exchange(self, x: torch.Tensor, top: int, bot: int) -> torch.Tensor:
        """This rank's rows of NCHW ``x`` with ``top`` rows above and
        ``bot`` below from their owners, zeros beyond the image (a conv's
        SAME padding of the global height).  A rank without rows gets
        none."""
        height, ranges = self.ranges(x.shape[3])
        return exchange_rows(x, self.mesh.sp, ranges, height, top, bot)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The whole of NHWC ``y`` (dim 1 split by rows) on every sp rank,
        differentiably (``all_gather_rows``)."""
        return all_gather_rows(y, self.mesh.sp, self.ranges(y.shape[2])[1])

    def gather_batch(self, y: torch.Tensor) -> torch.Tensor:
        """The dp ranks' rows of dim 0 concatenated, outside autograd."""
        return torch.cat(gather_exact(y, self.mesh.dp), 0)
