"""Metrics, structured logging, profiling helpers.

The port's own copy of `ptre_tpu/utils/metrics.py`: per-frame timings,
rays/s and accumulated-sample counters with the same rolling window and the
same ``summary()`` string, a structured logger (named ``ptre_tpu_torch``),
and `profile_trace` over ``torch.profiler`` in place of ``jax.profiler``.

`span` marks a phase of the program's own work (``ptre.render.*``,
``ptre.wave.*``, ``ptre.train.*``) on the profiler's timeline while a
profiler records, and costs one attribute read while none does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import List, Optional

import torch

logger = logging.getLogger("ptre_tpu_torch")


def configure_logging(level=logging.INFO):
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
    logger.setLevel(level)


@dataclasses.dataclass
class FrameStat:
    seconds: float
    rays: int
    samples_accumulated: int


class Metrics:
    """Rolling frame statistics (the FPS-readout equivalent, queryable)."""

    def __init__(self, window: int = 120):
        self.window = window
        self.frames: List[FrameStat] = []
        self._t_start = time.perf_counter()

    def frame(self, seconds: float, rays: int, samples_accumulated: int):
        self.frames.append(FrameStat(seconds, rays, samples_accumulated))
        if len(self.frames) > self.window:
            self.frames.pop(0)

    @property
    def fps(self) -> float:
        if not self.frames:
            return 0.0
        dt = sum(f.seconds for f in self.frames)
        return len(self.frames) / dt if dt > 0 else 0.0

    @property
    def ms_per_frame(self) -> float:
        return 1000.0 / self.fps if self.fps > 0 else 0.0

    @property
    def mrays_per_s(self) -> float:
        if not self.frames:
            return 0.0
        dt = sum(f.seconds for f in self.frames)
        rays = sum(f.rays for f in self.frames)
        return rays / dt / 1e6 if dt > 0 else 0.0

    def summary(self) -> str:
        """The title-bar string (`application.cu:101-113` format, extended)."""
        n = self.frames[-1].samples_accumulated if self.frames else 0
        return (
            f"fps: {self.fps:.1f} frame time: {self.ms_per_frame:.2f}ms "
            f"rays/s: {self.mrays_per_s:.1f}M samples: {n}"
        )


#: what `span` returns while no profiler records: one shared no-op
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks ``name`` on the profiler's timeline.

    While a ``torch.profiler`` records (`profile_trace`, a benchmark's
    traced stretch), the span is an operator-scope host event on the
    profiler's own clock, which is the clock of the device trace. It is not
    a user annotation, so the device trace gets no copy of it and the
    device's event count stays that of the work. While no profiler
    records, it is one shared no-op and no ``RecordFunction`` is built;
    where this torch lacks the fast event, spans are off."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return _NO_SPAN if fast is None else fast(name)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace scope (host and, where there is a card, device
    activity) that writes a Chrome trace into ``log_dir``; no-op when
    ``log_dir`` is None. The operator's way to see the program's spans
    (`span`): inside it they are recorded, named ``ptre.*``, around the
    host's phases of each render and training step.

        with profile_trace("traces"):
            accum = render_step(packet, cam, accum, seed, config, spp=4)
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
