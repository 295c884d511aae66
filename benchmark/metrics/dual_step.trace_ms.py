"""dual_step.trace_ms (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.dual.trace`` a dual step: the
path-traced image, every local sample (jitter, rays, the recording
wavefront)."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.dual.trace")
