"""High-resolution frame timer.

The port's own copy of `ptre_tpu/app/timer.py`, unchanged in behaviour.
Equivalent of the reference's `timer` singleton over
`std::chrono::high_resolution_clock` (`timer.h`, `timer.cu:27-45`):
`get_delta()` returns seconds since the previous `get_delta()` call (the
frame dt) and `get_total_time()` seconds since construction. A injectable
clock makes the loop deterministic under test.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Timer:
    """Frame timer: `get_delta()` = dt since last call, `get_total_time()`
    = seconds since start (reference `timer.cu:33-45`)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._start = clock()
        self._last = self._start

    def get_total_time(self) -> float:
        return self._clock() - self._start

    def get_delta(self) -> float:
        old = self._last
        self._last = self._clock()
        return self._last - old


_timer: Optional[Timer] = None


def init() -> None:
    """Create the process-wide timer (reference `timer::init`)."""
    global _timer
    if _timer is None:
        _timer = Timer()


def shutdown() -> None:
    global _timer
    _timer = None


def get() -> Optional[Timer]:
    return _timer
