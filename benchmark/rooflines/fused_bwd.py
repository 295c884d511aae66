"""The fused backward (`csrc/fused_grad_kernel.cu` fused_bwd_kernel and
fused_bwd_global_kernel): the adjoint of one recorded sample.

Least bytes of a launch: per ray the origin and direction (24 B), the
recorded selection of each of max_depth bounces (4 B each) and the colour's
cotangent (12 B) read once, d(origin) and d(direction) (24 B) written once;
the unified table of the configuration's triangles and spheres (27 floats a
row) read once and its cotangent written once."""

from benchmark.rooflines import scene_counts


def matches(name: str) -> bool:
    return "fused_bwd" in name


def least_bytes(run, launches: int) -> float:
    c = run.config
    tris, sphs, _ = scene_counts(c)
    rays = int(c["width"]) * int(c["height"])
    per_launch = rays * (24 + 4 * int(c["max_depth"]) + 12 + 24) + 2 * 4 * 27 * (tris + sphs)
    return float(launches * per_launch)
