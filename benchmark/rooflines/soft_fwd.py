"""The SoftRas forward (`csrc/soft_raster_kernel.cu` soft_fwd_kernel): the
online-softmax raster of the whole supersampled image.

Least bytes of a launch, from the configuration alone: the (rows, 32) float
table of the raster view's triangles and its 64-row chunk boxes (8 floats
each) read once; the planar image (3 planes) and the residuals (6 planes)
of every supersample written once."""

from benchmark.rooflines import soft_bwd


def matches(name: str) -> bool:
    return "soft_fwd_kernel" in name


def least_bytes(run, launches: int) -> float:
    rows, samples = soft_bwd.table_rows_and_samples(run.config)
    return float(launches * (4 * (32 * rows + 8 * (rows // 64)) + 4 * 9 * samples))
