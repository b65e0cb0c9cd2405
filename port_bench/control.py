"""Readings of the correctness check, for setting its limits.

    python -m port_bench.control --workload <cell> --seeds 1,2,3 \\
        [--graphs default,int8] [--seconds 3] [--out FILE]

Runs the cell's driver once per seed and graph in one process, each at
the cell's own sizes and load with a short window, and prints each
run's compared numbers.  ``default`` is the port as its configuration
states it: over a dozen seeds or more its largest reading of each
number is that number's lower reading.  ``int8`` is the control: the
port's own int8 serving graph (``quant``), the nearest precision below
the configuration's bfloat16; its smallest reading is the upper one.
The limits in ``port_bench/limits/<cell>.json`` lie between the two.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from port_bench import harness, manifest


def readings(workload: str, seeds, graphs, seconds: float, device="cuda",
             config=None, traffic=None, limits=None):
    """[{"seed", "graph", "correct", "checks": {name: value}}, ...]."""
    m = manifest.load()
    w = manifest.cell(m, workload)
    config = config or manifest.config(w["config"])
    traffic = traffic or manifest.traffic(w["traffic"])
    limits = limits or manifest.limits(w["name"])
    drv = manifest.driver(traffic["driver"])
    rows = []
    for graph in graphs:
        for seed in seeds:
            ctx = harness.Context(workload=workload, config=config,
                                  traffic=traffic, limits=limits, seed=seed,
                                  seconds=seconds, trace=False, device=device)
            out = drv.run(ctx, graph=graph)
            rows.append({"seed": seed, "graph": graph,
                         "correct": out.correct,
                         "checks": {k: v for k, v, _ in out.checks},
                         "judged": out.counters.get("judged", {}),
                         "img_per_s": out.e2e.get("serve_img_per_s")})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--graphs", default="default,int8")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    rows = readings(a.workload, [int(s) for s in a.seeds.split(",")],
                    a.graphs.split(","), a.seconds)
    for graph in a.graphs.split(","):
        got = [r["checks"] for r in rows if r["graph"] == graph]
        agg = "max" if graph == "default" else "min"
        fn = max if agg == "max" else min
        print(f"{graph}: {agg} " + json.dumps(
            {k: fn(g[k] for g in got) for k in got[0]}), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
