"""train_step.backward_ms (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.train.backward`` a training step:
`torch.autograd.grad` over the step's graph, the samples' recompute
included."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.train.backward")
