"""What every driver shares: the run's context, the set-up clock, the
peak-memory reading and the check that no JAX module was loaded."""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "dis_yolo_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or 0 where the
    kernel does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


class SetupClock:
    """Set-up time from the process's start, split by part."""

    def __init__(self, start: Optional[float] = None):
        self.start = (time.perf_counter() - process_age_s()
                      if start is None else start)
        self.last = self.start
        self.parts: Dict[str, float] = {}

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.start


@dataclass
class Context:
    """One run of one cell, as the driver gets it."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    clock: SetupClock = field(default_factory=SetupClock)


@dataclass
class Outcome:
    """What a driver hands back: end-to-end values by metric name, the
    counters and trace the per-layer readers read, and the checks that
    decide ``correct`` as (name, value, limit)."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Tuple[str, float, float]]
    counters: Dict[str, float] = field(default_factory=dict)
    trace: object = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and self.attempted > 0 and all(
            value <= limit for _, value, limit in self.checks)


def forbidden_modules() -> List[str]:
    """Top-level modules of JAX or the JAX package in ``sys.modules``,
    compared by whole name (``dis_yolo_tpu_torch`` is not
    ``dis_yolo_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
