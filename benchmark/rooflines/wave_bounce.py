"""The wavefront's bounce kernel (`csrc/wave_kernel.cu` wave_bounce_kernel):
one bounce of the live rays over the leaves the mask listed.

Least bytes, loose by design: only bounce 0's W x H rays of each sample, a
ray's origin and direction read once (24 B) and its colour factor written
once (12 B), plus the scene's triangle rows read once a launch (the
configuration's leaves of 64 rows, 12 floats a row: the compact rows). Later
bounces' live rays are left out: their count needs a counter of the work
these inputs need, which the program does not expose yet. So the share is a
lower bound of the kernel's and cannot pass 100 %."""

from benchmark.rooflines import scene_counts


def matches(name: str) -> bool:
    return "wave_bounce_kernel" in name


def least_bytes(run, launches: int) -> float:
    c = run.config
    tris, _, _ = scene_counts(c)
    leaves = -(-tris // 64)
    rays0 = run.profile.calls * run.rays_per_call // int(c["max_depth"])
    return float(rays0 * 36 + launches * leaves * 64 * 48)
