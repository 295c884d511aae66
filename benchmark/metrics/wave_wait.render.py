"""wave_wait.render (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.wave.live_count`` a render step: the
wavefront's live-count reads, where the host blocks on the card before each
bounce past the first."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.wave.live_count")
