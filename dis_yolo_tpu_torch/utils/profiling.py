"""Profiling hooks (the counterpart of ``dis_yolo_tpu/utils/profiling.py``):

  * ``trace(logdir)``: a ``torch.profiler`` window (CPU, and the card's
    kernels where there is one), written to ``logdir/trace.json`` for
    Perfetto or ``chrome://tracing``;
  * ``chain_scan_time``: the device time of one call of ``body``, from N
    data-dependent calls between two CUDA events (each call's input
    depends on the previous output, so none can be skipped or overlap),
    the median over repeats, in ms per call.  On the CPU the same chain
    is timed with the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def chain_scan_time(body: Callable, x0: torch.Tensor, n: int = 20,
                    repeats: int = 3, args: tuple = ()) -> float:
    """Median ms per call of ``body(x, *args)`` over chains of ``n``
    calls, after one warm chain.  A tiny multiple of each output's sum is
    folded into the next call's input (in the input's dtype), so every
    call depends on the one before."""
    cuda = x0.is_cuda

    def chain():
        x = x0
        for _ in range(n):
            out = body(x, *args)
            if isinstance(out, (tuple, list)):
                out = out[0]
            x = x0 + (out.float().sum() * 1e-20).to(x0.dtype)
        return x

    chain()
    times = []
    for _ in range(repeats):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            chain()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            chain()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)) / n
