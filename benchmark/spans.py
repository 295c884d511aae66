"""The program's own spans in a traced run: host events named ``ptre.*``
(`ptre_tpu_torch.utils.metrics.span`), which `devtrace` keeps among the
host events, on the profiler's clock. The per-layer metrics that read them
share this arithmetic.

A span counts where it starts inside a traced call (``run.profile.ranges``),
and, given ``within``, inside a span of that name too (a recomputed sample
inside the backward: by time, not by thread, as the backward may run on
the autograd engine's own thread). Its host milliseconds are summed and
divided by the traced calls. A trace that holds no span of the name reads
None: a program without the span leaves the metric out.
"""

from __future__ import annotations

import bisect


def intervals(run, name: str):
    """(start, end) of every host event named ``name``, by start."""
    return sorted((a, b) for n, a, b in run.profile.host if n == name)


def starting_inside(spans, ranges):
    """The ``spans`` whose start lies in one of the ``ranges`` (which do not
    overlap)."""
    ranges = sorted(ranges)
    starts = [a for a, _ in ranges]
    out = []
    for a, b in spans:
        j = bisect.bisect_right(starts, a) - 1
        if j >= 0 and a <= ranges[j][1]:
            out.append((a, b))
    return out


def ms_per_call(run, name: str, within: str = None):
    """Host milliseconds a traced call inside the spans named ``name`` that
    start inside a call (and inside a ``within`` span); None where the trace
    holds no span named ``name``."""
    if run.profile is None or not run.profile.calls:
        return None
    spans = intervals(run, name)
    if not spans:
        return None
    spans = starting_inside(spans, run.profile.ranges)
    if within is not None:
        spans = starting_inside(spans, intervals(run, within))
    return 1e3 * sum(b - a for a, b in spans) / run.profile.calls
