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

Spatial partitioning (``parallel/spatial.py``) adds three differentiable
collectives: ``all_reduce_sum`` (train-mode BatchNorm's moment sums),
``exchange_rows`` (the halo rows a conv window needs from the ranks that
own them) and ``all_gather_rows`` (the raw outputs, whole on every rank).
The last two move their payload bit for bit as int32 words through an
all-reduce in which each rank fills only its own slot (``gather_exact``):
gloo takes int32 all-reduces on the CPU and on CUDA (it stages CUDA
tensors through host memory), NCCL takes them too, and adding zeros to an
integer is exact whatever the payload's dtype.  A failed collective
raises; none falls back to another device or to one process.
"""

from __future__ import annotations

import datetime
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
               rank: Optional[int] = None,
               timeout_s: Optional[float] = None) -> Optional[str]:
    """Join the process group of a multi-process run; returns the backend.

    The arguments default to torchrun's environment (``env://``).  A
    single process (``WORLD_SIZE`` unset or 1, and no ``init_method``) is
    a no-op that returns None, as the JAX package's ``initialize`` is for
    one process.  On CUDA the rank's card is ``LOCAL_RANK`` modulo the
    host's card count, made the current device.  A one-element
    ``all_reduce`` right after the start makes a broken group raise here,
    not at the first step.  ``timeout_s`` bounds each collective's wait
    (PyTorch's default when None): a rank whose peers never join a
    collective raises instead of waiting on.
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
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=None if timeout_s is None
        else datetime.timedelta(seconds=timeout_s))
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


def _sum_(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """In place: the sum over the mesh (``psum``); a one-rank mesh is the
    identity."""
    if mesh.size > 1:
        dist.all_reduce(tensor, group=mesh.group)
    return tensor


def all_reduce_sum_(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """``psum`` in place, outside autograd."""
    with torch.no_grad():
        return _sum_(tensor, mesh)


class _AllReduceSum(torch.autograd.Function):
    """``psum`` whose backward is ``psum`` of the cotangent: every rank's
    outputs depend on the sum, so the sum's cotangent is the sum of the
    ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.clone(memory_format=torch.contiguous_format),
                          ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable ``psum`` over the mesh (``_AllReduceSum``)."""
    return _AllReduceSum.apply(x, mesh)


def gather_exact(t: torch.Tensor, mesh) -> list:
    """Every rank's ``t`` (the same shape and dtype on every rank), bit for
    bit, as a list in rank order; the rank's own entry is ``t`` itself.
    One all-reduce of int32 words in which each rank fills its own slot."""
    if mesh.size == 1:
        return [t]
    nbytes = t.numel() * t.element_size()
    words = max(1, -(-nbytes // 4))
    buf = torch.zeros((mesh.size, words), dtype=torch.int32, device=t.device)
    if nbytes:
        buf[mesh.rank].view(torch.uint8)[:nbytes].copy_(
            t.contiguous().reshape(-1).view(torch.uint8))
    dist.all_reduce(buf, group=mesh.group)
    out = [buf[q].view(torch.uint8)[:nbytes].view(t.dtype).view(t.shape)
           for q in range(mesh.size)]
    out[mesh.rank] = t
    return out


def _owner(ranges, row: int) -> int:
    for q, (a, b) in enumerate(ranges):
        if a <= row < b:
            return q
    raise ValueError(f"row {row} has no owner in {ranges}")


class _ExchangeRows(torch.autograd.Function):
    """This rank's rows ``[a, b)`` (dim 2 of NCHW) -> rows ``[a - top,
    b + bot)`` of the global tensor of ``height`` rows, zeros outside it
    (SAME's padding).  Forward: each rank offers its first and last
    ``max(top, bot)`` rows; each takes the ones it needs from their owners.
    Backward: each rank offers the cotangent of its halo rows, and each
    owner adds the parts that fall in its rows to its own, in rank order.
    A rank without rows takes and gives nothing, but joins both
    collectives."""

    @staticmethod
    def forward(ctx, x, mesh, ranges, height, top, bot):
        ctx.args = (mesh, ranges, top, bot)
        a, b = ranges[mesh.rank]
        n_rows, m = b - a, max(top, bot)
        bsz, ch, _, w = x.shape
        edge = x.new_zeros((2, bsz, ch, m, w))
        k = min(m, n_rows)
        if k:
            edge[0, :, :, :k] = x[:, :, :k]
            edge[1, :, :, m - k:] = x[:, :, n_rows - k:]
        edges = gather_exact(edge, mesh)
        if not n_rows:
            return x.new_zeros((bsz, ch, 0, w))
        zero = x.new_zeros((bsz, ch, 1, w))

        def row(g):
            if not 0 <= g < height:
                return zero
            q = _owner(ranges, g)
            qa, qb = ranges[q]
            if g - qa < m:
                return edges[q][0, :, :, g - qa:g - qa + 1]
            if qb - g > m:
                raise ValueError(f"row {g} lies deeper than the halo {m} "
                                 f"inside rank {q}'s rows {ranges[q]}")
            return edges[q][1, :, :, m - (qb - g):m - (qb - g) + 1]
        return torch.cat([row(g) for g in range(a - top, a)] + [x]
                         + [row(g) for g in range(b, b + bot)], 2)

    @staticmethod
    def backward(ctx, grad):
        mesh, ranges, top, bot = ctx.args
        a, b = ranges[mesh.rank]
        n_rows = b - a
        bsz, ch, _, w = grad.shape
        halo = grad.new_zeros((top + bot, bsz, ch, w))
        if n_rows:
            halo[:top] = grad[:, :, :top].permute(2, 0, 1, 3)
            halo[top:] = grad[:, :, top + n_rows:].permute(2, 0, 1, 3)
        halos = gather_exact(halo, mesh)
        dx = grad[:, :, top:top + n_rows].clone(
            memory_format=torch.contiguous_format)
        for q, (qa, qb) in enumerate(ranges):
            if q == mesh.rank or qa == qb:
                continue
            wanted = list(range(qa - top, qa)) + list(range(qb, qb + bot))
            for j, g in enumerate(wanted):
                if a <= g < b:
                    dx[:, :, g - a] += halos[q][j]
        return dx, None, None, None, None, None


def exchange_rows(x: torch.Tensor, mesh, ranges, height: int, top: int,
                  bot: int) -> torch.Tensor:
    """Differentiable halo exchange over ``mesh`` (``_ExchangeRows``):
    ``ranges[q]`` are rank q's rows of the global dim 2 of ``height``
    rows, contiguous in rank order."""
    if not (top or bot):
        return x
    return _ExchangeRows.apply(x, mesh, ranges, height, top, bot)


class _AllGatherRows(torch.autograd.Function):
    """The ranks' rows (dim 1) concatenated in rank order, on every rank.
    Every rank computes the same loss from the whole tensor, so the
    backward keeps this rank's slice of its own cotangent: the loss counts
    once, not once per rank."""

    @staticmethod
    def forward(ctx, x, mesh, ranges):
        a, b = ranges[mesh.rank]
        ctx.rows = (a, b)
        longest = max(qb - qa for qa, qb in ranges)
        pad = x.new_zeros((x.shape[0], longest) + tuple(x.shape[2:]))
        pad[:, :b - a] = x
        parts = gather_exact(pad, mesh)
        return torch.cat([p[:, :qb - qa] for p, (qa, qb) in
                          zip(parts, ranges)], 1)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.rows
        return grad[:, a:b].contiguous(), None, None


def all_gather_rows(x: torch.Tensor, mesh, ranges) -> torch.Tensor:
    """Differentiable gather of the ranks' rows of dim 1
    (``_AllGatherRows``)."""
    return _AllGatherRows.apply(x, mesh, ranges)
