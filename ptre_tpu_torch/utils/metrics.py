"""Metrics, structured logging, profiling helpers.

The port's own copy of `ptre_tpu/utils/metrics.py`: per-frame timings,
rays/s and accumulated-sample counters with the same rolling window and the
same ``summary()`` string, a structured logger (named ``ptre_tpu_torch``),
and `profile_trace` over ``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import List, Optional

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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace scope (host and, where there is a card, device
    activity) that writes a Chrome trace into ``log_dir``; no-op when
    ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def timed(name: str, sink=None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    (sink or logger.info)("%s: %.3fs" % (name, dt))
