"""Step-timing utilities: running span average + whole-run ETA (a copy of
``dis_yolo_tpu/utils/timer.py``; the port imports nothing of that package).

Behavioral spec (NOT a transcription) from the reference
``utils/timer.py:3-37``: a timer accumulates tic/toc intervals into a
running average, and ``remain(iters, max_iters)`` extrapolates the time
elapsed *since the timer was constructed* over the remaining iterations —
the reference bases the ETA on ``init_time``, not on the last ``tic``.

Rebuilt idiomatically: a ``span()`` context manager is the primary API
(``tic``/``toc`` remain as thin conveniences for loop bodies), the clock is
injectable for deterministic tests, and derived statistics are properties
computed from two accumulators instead of mirrored attributes.
"""

from __future__ import annotations

import datetime
import time
from contextlib import contextmanager
from typing import Callable


class Timer:
    """Accumulates timed spans; reports per-span average and run ETA."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._born = clock()       # ETA reference point (see module doc)
        self._elapsed = 0.0        # sum of all completed spans
        self._spans = 0            # number of completed spans
        self._last = 0.0           # duration of the most recent span
        self._open = None          # start of the currently open span

    @contextmanager
    def span(self):
        """Time one iteration phase: ``with load_timer.span(): batch = ...``"""
        begin = self._clock()
        try:
            yield self
        finally:
            self._close(begin)

    def tic(self) -> None:
        self._open = self._clock()

    def toc(self, average: bool = True) -> float:
        if self._open is None:
            raise RuntimeError("toc() without a matching tic()")
        begin, self._open = self._open, None
        self._close(begin)
        return self.average_time if average else self._last

    def _close(self, begin: float) -> None:
        self._last = self._clock() - begin
        self._elapsed += self._last
        self._spans += 1

    @property
    def calls(self) -> int:
        return self._spans

    @property
    def diff(self) -> float:
        return self._last

    @property
    def total_time(self) -> float:
        return self._elapsed

    @property
    def average_time(self) -> float:
        return self._elapsed / self._spans if self._spans else 0.0

    def remain(self, iters: int, max_iters: int) -> str:
        """ETA string: lifetime-so-far scaled to the remaining iterations."""
        if iters <= 0:
            seconds = 0.0
        else:
            lifetime = self._clock() - self._born
            seconds = lifetime * (max_iters - iters) / iters
        return str(datetime.timedelta(seconds=int(seconds)))
