"""The dense render kernel (`csrc/trace.cuh` dense_kernel over RenderJob,
`csrc/render_kernel.cu`): one sample of every pixel into the accumulator.

Least bytes of a launch: the (H, W, 3) float32 accumulator read once and
written once, and the scene's rows read once (triangles and spheres as the
configuration counts them, 16 and 4 floats, materials 5, sky 6). Each input
byte read once and each output byte written once: a lower bound whatever the
kernel does."""

from benchmark.rooflines import scene_counts


def matches(name: str) -> bool:
    return "dense_kernel" in name and "RenderJob" in name


def least_bytes(run, launches: int) -> float:
    c = run.config
    tris, sphs, mats = scene_counts(c)
    pixels = int(c["width"]) * int(c["height"])
    per_launch = 2 * pixels * 12 + 4 * (16 * tris + 4 * sphs + 5 * mats + 6)
    return float(launches * per_launch)
