"""dual_step.raster_ms (ms): host milliseconds under the profiler, from the
traced stretch, inside the span ``ptre.dual.raster`` a dual step: the raster
drawcall table, the packing of the raster table and the SoftRas forward and
resolve."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "ptre.dual.raster")
