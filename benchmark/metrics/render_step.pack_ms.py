"""render_step.pack_ms (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.render.pack`` a render step: the
step's packing of the scene (`wavefront.prepare_scene` on the wavefront
route), which every step repeats."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.render.pack")
