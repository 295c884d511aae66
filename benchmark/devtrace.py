"""The device trace of a traced run: `torch.profiler` over a steady stretch
of calls, reduced to what the per-layer metrics and the breakdown read.

The arithmetic is that of the port's `chip_smoke.device_share`, copied so
that the yardstick stays put: device busy time is the union of the device
events' intervals; the idle share is one less busy over the stretch's wall
time. Each call runs inside a ``record_function`` range named `CALL`, which
places the host's calls on the profiler's clock.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

CALL = "bench.call"
#: host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
#: the longest idle gaps the breakdown names, and how far back from a gap it
#: looks for the host events under way (they nest: the innermost started last)
_GAPS = 500
_BACK = 4096


@dataclasses.dataclass
class Trace:
    """One traced stretch; times in seconds, on the profiler's clock."""

    calls: int
    wall_s: float
    busy_s: float
    device: list  # (name, start, end) of every device event
    host: list  # (name, start, end) of every host event
    ranges: list  # (start, end) of every call

    def device_events_per_call(self) -> float:
        return len(self.device) / self.calls

    def host_events_in_calls(self, names) -> int:
        """Host events named ``names`` that start inside a call."""
        starts = sorted(s for n, s, _ in self.host if n in names)
        count, j = 0, 0
        for a, b in sorted(self.ranges):
            while j < len(starts) and starts[j] < a:
                j += 1
            k = j
            while k < len(starts) and starts[k] <= b:
                k += 1
            count += k - j
            j = k
        return count

    def kernel(self, match):
        """(launches, device seconds) of the device events whose name
        ``match`` accepts."""
        ev = [(b - a) for n, a, b in self.device if match(n)]
        return len(ev), sum(ev)

    def breakdown(self, top: int = 10):
        """The device operations that take most time, and the longest idle
        gaps grouped by the innermost host event under way at their middle."""
        by_op = {}
        for n, a, b in self.device:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (b - a)
        gaps, end = [], None
        lo = min(a for a, _ in self.ranges)
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if end is None:
                if a > lo:
                    gaps.append((lo, a))
            elif a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted(self.host, key=lambda e: e[1])
        starts = [s for _, s, _ in host]
        by_host = {}
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:_GAPS]:
            mid = 0.5 * (a + b)
            j = bisect.bisect_right(starts, mid)
            inner = [(e - s, n) for n, s, e in host[max(0, j - _BACK):j] if e >= mid]
            name = min(inner)[1] if inner else "(host: no profiled op under way)"
            by_host[name[:120]] = by_host.get(name[:120], 0.0) + (b - a)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


def trace_calls(call, count: int) -> Trace:
    """Profile ``count`` calls of ``call(k)`` (k = 0, 1, ...), each in a
    `CALL` range, ending in a device synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(count):
            with record_function(CALL):
                call(k)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host, ranges = [], [], []
    for e in prof.events():
        item = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == CALL:
            if not on_device:  # the device's copy of the range is no work
                ranges.append(item[1:])
        elif on_device:
            dev.append(item)
        else:
            host.append(item)
    busy, end = 0.0, -float("inf")
    for _, a, b in sorted(dev, key=lambda e: e[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return Trace(calls=count, wall_s=wall, busy_s=busy, device=dev, host=host, ranges=ranges)
