"""Run one cell of the port's benchmark once.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and
a traffic mix; the mix names its driver (``port_bench/drivers/``), which
builds the port's system from the seed, warms it up, measures it for
``--seconds``, and checks what the timed path produced against the
plain reference (``port_bench/reference/``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read by ``port_bench/metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit, which also end standard error.  The
line before it gives the set-up time by part.

A run needs a CUDA card: without one, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result.  It exits with
code 3 and no result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_PERF_AT_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from port_bench import harness, manifest  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(prog="python -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _finite(value: float) -> float:
    """JSON has no infinity: a check that found nothing to compare, or a
    window with no batch, reads as the largest float."""
    return value if math.isfinite(value) else sys.float_info.max


def result_line(m: dict, workload: str, out: harness.Outcome, trace: bool,
                device: dict) -> dict:
    """The result object, keys in the contract's order, checks last."""
    metrics = {}
    if not trace:
        for entry in manifest.metrics_of(m, workload, "end_to_end"):
            metrics[entry["name"]] = {"value": _finite(out.e2e[entry["name"]]),
                                      "unit": entry["unit"]}
    else:
        for entry in manifest.metrics_of(m, workload, "per_layer"):
            value = manifest.metric_reader(entry["name"]).read(out)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {name: {"value": _finite(value), "limit": limit}
                      for name, value, limit in out.checks}
    return line


def main(argv=None) -> int:
    args = _args(argv)
    clock = harness.SetupClock()
    clock.parts["interpreter"] = _PERF_AT_IMPORT - clock.start
    clock.last = _PERF_AT_IMPORT
    import torch
    clock.mark("import_torch")
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark does not run on "
              "the CPU", file=sys.stderr)
        return 2
    m = manifest.load()
    w = manifest.cell(m, args.workload)
    if torch.cuda.device_count() < w["chips"]:
        print(f"port_bench: {args.workload} needs {w['chips']} CUDA "
              f"devices, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    traffic = manifest.traffic(w["traffic"])
    ctx = harness.Context(workload=w["name"],
                          config=manifest.config(w["config"]),
                          traffic=traffic, limits=manifest.limits(w["name"]),
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda", clock=clock)
    out = manifest.driver(traffic["driver"]).run(ctx)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"port_bench: the run loaded {loaded}: the port and the "
              "benchmark must not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
    line = result_line(m, w["name"], out, ctx.trace, device)
    print("counters " + json.dumps(out.counters), flush=True)
    print("setup_parts " + json.dumps(clock.parts), flush=True)
    for name, value, limit in out.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
