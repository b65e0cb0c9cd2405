"""``BENCHMARK.json`` and the files it names, found by name.

  * a configuration ``<c>``: ``port_bench/configs/<c>.json``;
  * a traffic mix ``<t>``: ``port_bench/traffic/<t>.json``, whose
    ``driver`` names ``port_bench/drivers/<driver>.py``;
  * a per-layer metric ``<m>``: ``port_bench/metrics/<m>.py``, a module
    with ``read(ctx)`` returning a number, or None where it finds
    nothing to read;
  * a cell ``<w>``'s correctness limits: ``port_bench/limits/<w>.json``.

A later change adds a configuration, a mix, a metric or a cell by
adding its file and its entry; nothing here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
MANIFEST = ROOT.parent / "BENCHMARK.json"


def load(path: Optional[Path] = None) -> dict:
    with open(path or MANIFEST) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, root: Path = ROOT) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str, root: Path = ROOT) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json("traffic", name, root)


def limits(workload: str, root: Path = ROOT) -> dict:
    return _json("limits", workload, root)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    return _module(root / "drivers" / f"{name}.py",
                   f"port_bench.drivers.{name}")


def metric_reader(name: str, root: Path = ROOT):
    return _module(root / "metrics" / f"{name}.py",
                   "port_bench_metric_" + name.replace(".", "_")
                   .replace("-", "_"))


def metrics_of(manifest: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    that list it under ``workloads``, or list no cells at all."""
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]
