"""wave_wait.train (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.wave.live_count`` a training step:
the wavefront's live-count reads, where the host blocks on the card, in the
recording forward and in the backward's recompute of each sample."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.wave.live_count")
