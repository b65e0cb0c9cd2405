"""The program's own spans and counters in a profiled window.

The port opens ``record_function`` spans named ``dis_yolo.<layer>``
around its layers while its spans are on
(``dis_yolo_tpu_torch/utils/profiling.py``), and counts NMS's sweeps,
its host syncs by site and its kernels' launches.  This module reduces
one profiled window's chrome-trace events (``port_bench/trace.py``'s
window, same categories) by those spans:

  * program spans: the ``user_annotation`` events named ``dis_yolo.*``
    on the host thread, nested by interval containment; driver spans:
    the other annotations there (``h2d``, ``forward``, ...);
  * each device operation goes to the innermost program span open at
    its launch (the host call its ``correlation`` id names), and counts
    in that span and every span around it;
  * each idle gap, a hole in the union of the device intervals, goes to
    the innermost program span open where it starts, or else to the
    driver span open there, or else to "outside";
  * per program span: device ms, idle ms, host self ms (its duration
    less its program-span children's) and calls, each per batch.

``program_window`` is the serving driver's block that takes such a
window over a few batches with the spans on, then counts host syncs
with the spans off, both by PyTorch's sync debug mode and by the
program's ``sync.*`` counters.  ``metrics`` reads nine per-layer
numbers from its result.  Run as a module, it measures one cell with
that block, the syncs by source line and the cost of spans when on:

    python -m port_bench.program_trace --workload <cell> --seed <n> \\
        --seconds <s> [--cost-batches 200] [--out <file.json>]
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
import warnings
from typing import Dict, List, Optional, Tuple

from port_bench.trace import DEVICE_CATS, LAUNCH_CATS, WINDOW_SPAN, _union

PREFIX = "dis_yolo."
OUTSIDE = "outside"
FORWARD_SPANS = ("dis_yolo.backbone", "dis_yolo.heads",
                 "dis_yolo.mask_decoder")
SYNC_WARNING = "called a synchronizing CUDA operation"


class _Nest:
    """Host intervals ``(start, end, name)`` nested by containment; finds
    the innermost one open at a time."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        for i, (lo, hi, _) in enumerate(self.spans):
            while stack and not (self.spans[stack[-1]][0] <= lo
                                 and hi <= self.spans[stack[-1]][1]):
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, t: float) -> Optional[int]:
        """The latest-starting interval at or before ``t`` lies inside
        every interval that holds ``t``, so the innermost one is it or
        one of its ancestors."""
        i = bisect.bisect_right(self.starts, t) - 1
        j = i if i >= 0 else None
        while j is not None:
            lo, hi, _ = self.spans[j]
            if lo <= t <= hi:
                return j
            j = self.parent[j]
        return None

    def chain(self, i: Optional[int]) -> List[str]:
        """Names from interval ``i`` out to its root, each once."""
        names: List[str] = []
        while i is not None:
            if self.spans[i][2] not in names:
                names.append(self.spans[i][2])
            i = self.parent[i]
        return names


def reduce_program(events: list, calls: int) -> dict:
    """Chrome-trace events of one profiled window of ``calls`` batches ->
    the program's spans, per batch (the module docstring).

    Returns ``{"batches", "window_ms", "busy_ms", "spans": {name:
    {"device_ms", "idle_ms", "host_self_ms", "calls"}}, "unspanned":
    {driver span or "outside": {"device_ms", "idle_ms"}},
    "driver_device_ms": {driver span: device ms}}``; ``unspanned`` holds
    what ran under no program span."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise RuntimeError(f"expected one {WINDOW_SPAN!r} span in the "
                           f"trace, found {len(window)}")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    host_tid = window[0].get("tid")
    annotations = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("tid") == host_tid and e["name"] != WINDOW_SPAN]
    program = _Nest([a for a in annotations if a[2].startswith(PREFIX)])
    driver = _Nest([a for a in annotations if not a[2].startswith(PREFIX)])
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}

    spans: Dict[str, Dict[str, float]] = {}
    unspanned: Dict[str, Dict[str, float]] = {}
    driver_device: Dict[str, float] = {}

    def row(table, name):
        return table.setdefault(name, {"device_ms": 0.0, "idle_ms": 0.0})

    def book(t: Optional[float], key: str, us: float) -> None:
        """``us`` of device or idle time to the spans open at ``t``."""
        inner = program.innermost(t) if t is not None else None
        if inner is not None:
            for name in program.chain(inner):
                row(spans, name)[key] += us * 1e-3
            return
        d = driver.innermost(t) if t is not None else None
        row(unspanned, driver.spans[d][2] if d is not None
            else OUTSIDE)[key] += us * 1e-3

    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < w0 or ts > w1:
            continue
        intervals.append((max(ts, w0), min(ts + dur, w1)))
        launch = launches.get(e.get("args", {}).get("correlation"))
        book(launch, "device_ms", dur)
        d = driver.innermost(launch) if launch is not None else None
        if d is not None:
            name = driver.spans[d][2]
            driver_device[name] = driver_device.get(name, 0.0) + dur * 1e-3
    busy = _union(intervals)
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            book(a, "idle_ms", b - a)

    child_us = [0.0] * len(program.spans)
    for i, p in enumerate(program.parent):
        if p is not None:
            child_us[p] += program.spans[i][1] - program.spans[i][0]
    for i, (lo, hi, name) in enumerate(program.spans):
        r = row(spans, name)
        r["host_self_ms"] = r.get("host_self_ms", 0.0) + (
            hi - lo - child_us[i]) * 1e-3
        r["calls"] = r.get("calls", 0) + 1

    n = max(calls, 1)
    return {"batches": calls, "window_ms": (w1 - w0) * 1e-3 / n,
            "busy_ms": sum(hi - lo for lo, hi in busy) * 1e-3 / n,
            "spans": {k: {f: v / n for f, v in r.items()}
                      for k, r in spans.items()},
            "unspanned": {k: {f: v / n for f, v in r.items()}
                          for k, r in unspanned.items()},
            "driver_device_ms": {k: v / n for k, v in driver_device.items()}}


@contextlib.contextmanager
def profiled(calls: int, out: list, profiling):
    """``trace.profiled``'s window with the program's spans on
    (``profiling`` is the port's ``utils.profiling``); appends
    ``reduce_program``'s result to ``out`` on the way out.  Without a
    card it profiles the host alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profiling.tracing(), profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_program_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out.append(reduce_program(events, calls))


def _profiling():
    """The port's spans and counters, or None in a program without them."""
    try:
        from dis_yolo_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def program_window(server, start: int, profile_batches: int,
                   sync_batches: int, count_syncs) -> Optional[dict]:
    """The serving driver's program block, after its own traced window
    and sync count: counters reset; ``profile_batches`` batches from pool
    position ``start`` profiled with the spans on (``reduce_program``);
    then ``sync_batches`` batches with the spans off through the
    driver's ``count_syncs``, the program's ``sync.*`` counters read
    around them.  None where the program has no spans or counters."""
    profiling = _profiling()
    if profiling is None:
        return None
    profiling.reset_counters()
    tables: list = []
    with profiled(profile_batches, tables, profiling):
        for p in range(start, start + profile_batches):
            server.batch(server.pool.at(p))
    per_batch = {k: v / profile_batches
                 for k, v in profiling.counters().items()}
    before = profiling.counters()
    p0 = start + profile_batches
    debug = count_syncs(server, range(p0, p0 + sync_batches))
    after = profiling.counters()
    program_syncs = sum(v - before.get(k, 0) for k, v in after.items()
                        if k.startswith("sync."))
    return {**tables[0], "counters_per_batch": per_batch,
            "syncs_debug_per_batch": debug,
            "syncs_program_per_batch": program_syncs / max(sync_batches, 1)}


# the per-layer metrics read from the spans: (spans summed, quantity)
SPAN_METRICS = {
    "backbone_ms.serve": (("dis_yolo.backbone",), "device_ms"),
    "heads_ms.serve": (("dis_yolo.heads",), "device_ms"),
    "mask_decoder_ms.serve": (("dis_yolo.mask_decoder",), "device_ms"),
    "forward_idle_ms.serve": (FORWARD_SPANS, "idle_ms"),
    "nms_ms.serve": (("dis_yolo.nms",), "device_ms"),
    "nms_idle_ms.serve": (("dis_yolo.nms",), "idle_ms"),
    "paste_taps_ms.serve": (("dis_yolo.paste.taps",), "device_ms"),
    "paste_gemm_ms.serve": (("dis_yolo.paste.gemm",), "device_ms"),
}


def metrics(program: Optional[dict]) -> Dict[str, Optional[float]]:
    """The nine per-layer numbers of a ``program_window`` result, each
    per batch: ``SPAN_METRICS`` and ``nms_sweeps_per_batch.serve``.  None
    where the window holds nothing to read: no result (a program without
    spans), or no device time (a run without a card)."""
    out: Dict[str, Optional[float]] = {}
    for name, (names, key) in SPAN_METRICS.items():
        got = sum(program["spans"].get(n, {}).get(key, 0.0)
                  for n in names) if program else 0.0
        out[name] = got if got > 0 else None
    out["nms_sweeps_per_batch.serve"] = (
        program["counters_per_batch"].get("nms.sweeps") if program else None)
    return out


def sync_sites(server, positions) -> Dict[str, float]:
    """Host syncs per batch under PyTorch's sync debug mode, by the
    innermost frame of the port or the benchmark on the stack when each
    was flagged."""
    import torch
    sites: Dict[str, float] = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        site = next((f"{os.path.relpath(f.filename)}:{f.lineno}"
                     for f in reversed(stack)
                     if "dis_yolo_tpu_torch" in f.filename
                     or "port_bench" in f.filename),
                    f"{filename}:{lineno}")
        sites[site] = sites.get(site, 0.0) + 1.0 / len(positions)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for p in positions:
                server.batch(server.pool.at(p))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def span_cost(server, start: int, n: int, profiling) -> dict:
    """Batch p50 over ``n`` unprofiled batches with the spans off and
    ``n`` with them on, in turns of two batches (one of each size of a
    pool whose sizes alternate)."""
    lat: Dict[bool, List[float]] = {False: [], True: []}
    for j in range(2 * n):
        on = bool((j // 2) % 2)
        with profiling.tracing(on):
            t0 = time.perf_counter()
            server.batch(server.pool.at(start + j))
            lat[on].append(time.perf_counter() - t0)
    off, on = (statistics.median(lat[k]) * 1e3 for k in (False, True))
    return {"batches": n, "off_p50_ms": off, "on_p50_ms": on,
            "on_over_off": on / off - 1.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m port_bench.program_trace")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost-batches", type=int, default=200)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    from port_bench import harness, manifest
    if not torch.cuda.is_available():
        print("port_bench.program_trace: no CUDA device", file=sys.stderr)
        return 2
    m = manifest.load()
    w = manifest.cell(m, args.workload)
    traffic = manifest.traffic(w["traffic"])
    ctx = harness.Context(workload=w["name"],
                          config=manifest.config(w["config"]),
                          traffic=traffic, limits=manifest.limits(w["name"]),
                          seed=args.seed, seconds=args.seconds, trace=True,
                          device="cuda")
    drv = manifest.driver(traffic["driver"])
    real = drv.count_syncs
    found: dict = {}

    def count_syncs(server, positions):
        # the driver's own count, then this module's block after it
        n = real(server, positions)
        profiling = _profiling()
        if profiling is None or found:
            return n
        start = positions.stop
        found["program"] = program_window(server, start,
                                          traffic["profile_batches"],
                                          traffic["sync_batches"], real)
        start += traffic["profile_batches"] + traffic["sync_batches"]
        found["sync_sites"] = sync_sites(server, range(start, start + 4))
        found["span_cost"] = span_cost(server, start + 4, args.cost_batches,
                                       profiling)
        return n

    drv.count_syncs = count_syncs
    out = drv.run(ctx)
    line = {"workload": w["name"], "seed": args.seed,
            "device": torch.cuda.get_device_name(0),
            "correct": out.correct,
            "checks": {k: v for k, v, _ in out.checks},
            "per_layer": {e["name"]: manifest.metric_reader(e["name"])
                          .read(out)
                          for e in manifest.metrics_of(m, w["name"],
                                                       "per_layer")},
            "program_metrics": metrics(found.get("program")),
            **found}
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if out.correct else 1


if __name__ == "__main__":
    sys.exit(main())
