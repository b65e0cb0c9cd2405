"""The traced sub-window: a ``torch.profiler`` run over a few of the
timed path's calls, reduced to what the per-layer metrics read.

The profiler's trace is written to a temporary file under ``TMPDIR``,
read back and deleted.  From it:

  * device activity: kernels, copies and memsets on the card, each with
    the host call that launched it (the ``correlation`` id of its
    CUDA runtime or driver call);
  * spans: the ``record_function`` ranges the drivers open around each
    call into a layer of the program; a device operation belongs to the
    outermost span whose host interval holds its launch;
  * busy time: the union of the device intervals inside the window, not
    their sum, so overlapping operations count once;
  * idle gaps: the holes in that union, each labelled by the span and
    the innermost host operation that were running when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "profiled_window"


@dataclass
class Trace:
    """Device activity of the profiled window, in seconds."""

    window_s: float
    busy_s: float
    calls: int
    # (start, duration, name, span, category) of every device operation
    ops: List[Tuple[float, float, str, Optional[str], str]] = \
        field(default_factory=list)
    gaps: Dict[str, float] = field(default_factory=dict)

    def kernels(self):
        return [op for op in self.ops if op[4] == "kernel"]

    def span_device_s(self, span: str) -> float:
        """Device seconds of the operations launched inside ``span``."""
        return sum(op[1] for op in self.ops if op[3] == span)

    def named_device_s(self, substring: str) -> Tuple[float, int]:
        """Device seconds and count of kernels whose name holds
        ``substring``."""
        hits = [op[1] for op in self.kernels() if substring in op[2]]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for op in self.ops:
            key = op[2][:120]
            by_name[key] = by_name.get(key, 0.0) + op[1]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def reduce_events(events: list, calls: int) -> Trace:
    """Chrome-trace events of one profiled window -> ``Trace``.  Times in
    the trace are microseconds; the window is the ``WINDOW_SPAN``
    annotation the driver opens around the profiled calls."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise RuntimeError(f"expected one {WINDOW_SPAN!r} span in the "
                           f"trace, found {len(window)}")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    host_tid = window[0].get("tid")
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
    # the driver's spans: annotations on the host thread, not the window
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("tid") == host_tid and e["name"] != WINDOW_SPAN)
    starts = [s[0] for s in spans]

    def span_at(t: float) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        # outermost span holding t: spans do not nest in the drivers
        while i >= 0:
            lo, hi, name = spans[i]
            if lo <= t <= hi:
                return name
            if hi < t:
                return None
            i -= 1
        return None

    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < w0 or ts > w1:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        ops.append((ts, dur, e["name"],
                    span_at(launch) if launch is not None else None,
                    e["cat"]))
    busy = _union([(max(ts, w0), min(ts + dur, w1)) for ts, dur, *_ in ops])
    host_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") == "cpu_op" and e.get("tid") == host_tid)
    op_starts = [h[0] for h in host_ops]

    def host_label(t: float) -> str:
        span = span_at(t) or "between spans"
        i = bisect.bisect_right(op_starts, t) - 1
        inner = None
        # host ops nest, so the latest-starting op holding t is the
        # innermost; look back over the last few thousand only
        for j in range(i, max(i - 4000, -1), -1):
            lo, hi, name = host_ops[j]
            if hi >= t:
                inner = name
                break
        return f"{span}/{inner}" if inner else span

    gaps: Dict[str, float] = {}
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            label = host_label(a)
            gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(hi - lo for lo, hi in busy) * 1e-6,
                 calls=calls,
                 ops=[(ts * 1e-6, dur * 1e-6, name, span, cat)
                      for ts, dur, name, span, cat in ops],
                 gaps=gaps)


@contextlib.contextmanager
def profiled(calls: int, out: list):
    """Profile the block (host and device), open the window's span
    around it, and append its ``Trace`` to ``out`` on the way out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out.append(reduce_events(events, calls))
