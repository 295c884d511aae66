"""train_step.forward_ms (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.train.forward`` a training step: the
samples' recording forward and the loss, after the packing."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.train.forward")
