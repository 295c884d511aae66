"""The mask kernel's global instantiation (`csrc/mask_kernel.cu`
wave_mask_global_kernel, past 1,024 leaves): the (ray block, leaf) verdicts
of one bounce past 0, the leaf and supertile boxes read through L1/L2.

Least bytes of a launch, from the configuration alone: the leaf boxes (8
floats a leaf) and the supertile table (8 floats a supertile of 8 leaves)
read once, and one verdict bit a (block of 256 rays, leaf) written once.
Leaves: the triangle rows, padded to a multiple of 128 as the packet pads
them, in leaves of 64. The live rays the kernel reads are left out, as in
`wave_bounce.py`: their count past bounce 0 needs a counter of the work
these inputs need. So the share is a lower bound of the kernel's and cannot
pass 100 %."""

from benchmark.rooflines import scene_counts


def leaves(config: dict) -> int:
    tris, _, _ = scene_counts(config)
    return -(-tris // 128) * 128 // 64


def matches(name: str) -> bool:
    return "wave_mask_global_kernel" in name


def least_bytes(run, launches: int) -> float:
    c = run.config
    n_leaf = leaves(c)
    blocks = -(-int(c["width"]) * int(c["height"]) // 256)
    per_launch = 32 * n_leaf + 32 * -(-n_leaf // 8) + blocks * n_leaf / 8
    return float(launches * per_launch)
