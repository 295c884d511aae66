"""dual_step.backward_ms (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.dual.backward`` a dual step:
`torch.autograd.grad` over both pipelines' graph (the SoftRas backward and
the fused backward included) and the gradients' mean over the ranks."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.dual.backward")
