"""train_step.recompute_ms (ms): host milliseconds under the profiler, from
the traced stretch, inside the spans ``ptre.train.sample`` that start inside
``ptre.train.backward``, a training step: the rematerialised samples'
recompute (attributed by time, whichever thread runs the backward)."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.train.sample", within="ptre.train.backward")
