"""The SoftRas backward (`csrc/soft_raster_kernel.cu` soft_bwd_kernel): the
adjoint of the forward, d(table) from the image's cotangent.

Least bytes of a launch, from the configuration alone: the (rows, 32) float
table and its 64-row chunk boxes, the residuals (6 planes) and the image
cotangent (3 planes) of every supersample read once; d(table) written once.
Rows: every model's triangles (analytic spheres as meshes), padded to a
multiple of 128 as the packet pads them, and to whole 64-row chunks."""

from benchmark.reference import meshes


def table_rows_and_samples(config: dict):
    """(rows of the raster table, supersamples of the image)."""
    tris = sum(meshes.build(config["meshes"][m["mesh"]])[2].size // 3 for m in config["models"])
    rows = -(-max(-(-tris // 128) * 128, 128) // 64) * 64
    ss = int(config["raster"]["supersample"])
    return rows, int(config["width"]) * ss * int(config["height"]) * ss


def matches(name: str) -> bool:
    return "soft_bwd_kernel" in name


def least_bytes(run, launches: int) -> float:
    rows, samples = table_rows_and_samples(run.config)
    return float(launches * (4 * (2 * 32 * rows + 8 * (rows // 64)) + 4 * 9 * samples))
