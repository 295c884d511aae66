"""frame_ms_p95 (ms): the 95th percentile (nearest rank), over every frame of
the window, of the time between successive returns of the frame call, the
first counted from the window's start: what the window shows (host clock)."""

import math


def read(run):
    gaps = sorted(run.return_intervals_s())
    return 1e3 * gaps[max(0, math.ceil(0.95 * len(gaps)) - 1)]
