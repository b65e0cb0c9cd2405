"""Multi-process initialization, per-process data sharding and the
collectives of data parallelism (the counterpart of
``dis_yolo_tpu/parallel/distributed.py``).

The JAX package runs one controller per host over all of its chips.  The
port runs one process per device, PyTorch's idiom:
``python -m torch.distributed.run --nproc-per-node N ...`` starts the
processes and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, which
``initialize`` reads.  The backend:

  * ``nccl`` when every rank of a host has a card of its own;
  * ``gloo`` on the CPU;
  * ``gloo`` when ranks share a card: NCCL refuses two ranks on one
    device, and gloo's ``all_reduce`` takes CUDA tensors (it stages them
    through host memory), so the math stays on the card.

A failed NCCL start raises; it never turns into gloo.

Each process feeds its own rows of the global batch: row r of a global
batch of B on N processes belongs to process ``r // (B / N)``, so the
processes' rows concatenated in process order are the global batch.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def choose_backend(device_type: str, ranks_per_host: int,
                   cards: int) -> str:
    """``nccl`` when each of a host's ranks has a card of its own, else
    ``gloo`` (the CPU, or ranks sharing a card)."""
    if device_type == "cuda" and ranks_per_host <= cards:
        return "nccl"
    return "gloo"


def initialize(device="cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> Optional[str]:
    """Join the process group of a multi-process run; returns the backend.

    The arguments default to torchrun's environment (``env://``).  A
    single process (``WORLD_SIZE`` unset or 1, and no ``init_method``) is
    a no-op that returns None, as the JAX package's ``initialize`` is for
    one process.  On CUDA the rank's card is ``LOCAL_RANK`` modulo the
    host's card count, made the current device.  A one-element
    ``all_reduce`` right after the start makes a broken group raise here,
    not at the first step.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return None
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = torch.device(device)
    cards = 0
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run data parallelism on the CPU")
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        dev = torch.device("cuda", local_rank % cards)
    if backend is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
        backend = choose_backend(dev.type, per_host, cards)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    dist.all_reduce(torch.ones((1,), device=dev))
    print(f"torch.distributed: rank {rank} of {world_size}, backend "
          f"{backend}, device {dev}", flush=True)
    return backend


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def per_host_batch_size(global_batch: int) -> int:
    """This process's rows of a global batch; raises ValueError when the
    processes do not divide it."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def assembly_plan(process_index: int, process_count: int,
                  local_shape) -> Tuple[tuple, Tuple[int, int]]:
    """The planning half of ``host_local_to_global``, with one device per
    process: (the global shape, the [start, stop) rows of the global
    batch that this process's local rows are).  Process order is row
    order."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process {process_index} of {process_count}")
    rows = local_shape[0]
    global_shape = (rows * process_count,) + tuple(local_shape[1:])
    return global_shape, (process_index * rows, (process_index + 1) * rows)


def host_local_to_global(mesh, host_batch: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Each process's local rows (``per_host_batch_size`` of them) as
    tensors on its device: its part of the global batch.  The rows stay
    on their process; the global batch is the processes' rows in process
    order (``assembly_plan``)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in host_batch.items()}


def replicate_to_global(mesh, tensors: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Values that every process computed alike (say, a state made from
    the same seed), on this process's device, checked equal to rank 0's:
    raises ValueError on the first that differs."""
    out = {k: torch.as_tensor(v).to(mesh.device) for k, v in tensors.items()}
    for key, value in out.items():
        first = value.clone()
        broadcast_(first, mesh)
        if not torch.equal(first, value):
            raise ValueError(f"{key}: rank {mesh.rank}'s value differs from "
                             "rank 0's")
    return out


# ------------------------------------------------------------ collectives

def broadcast_(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's ``tensor`` on every rank, in place."""
    if mesh.size > 1:
        dist.broadcast(tensor, dist.get_global_rank(mesh.group, 0)
                       if mesh.group is not None else 0, group=mesh.group)
    return tensor


def _mean_(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """In place: the sum over the mesh divided by its size (``pmean``).
    The divisor is a tensor: PyTorch divides by a Python scalar as a
    multiply by its reciprocal on CUDA."""
    if dist.is_initialized():
        dist.all_reduce(tensor, group=mesh.group)
    if mesh.size > 1:
        tensor.div_(torch.full((), mesh.size, dtype=tensor.dtype,
                               device=tensor.device))
    return tensor


def all_reduce_mean_(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """``pmean`` in place, outside autograd."""
    with torch.no_grad():
        return _mean_(tensor, mesh)


class _AllReduceMean(torch.autograd.Function):
    """``pmean`` whose backward is ``pmean`` of the cotangent: the
    transpose JAX takes under ``shard_map(check_vma=False)``, which the
    JAX package's mesh step uses.  With the gradient averaged once more
    after the backward, the step's gradient is the one-process gradient
    of the global batch."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _mean_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return _mean_(grad.clone(memory_format=torch.contiguous_format),
                      ctx.mesh), None


def all_reduce_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable ``pmean`` over the mesh (``_AllReduceMean``)."""
    return _AllReduceMean.apply(x, mesh)
