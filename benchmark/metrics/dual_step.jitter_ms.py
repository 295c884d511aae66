"""dual_step.jitter_ms (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.shard.jitter`` a dual step: each
sample's threefry pixel jitter (`rng.pixel_jitter`) on the sharded route."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.shard.jitter")
