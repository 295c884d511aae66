"""Byte counts of the kernels' rooflines, one file a kernel, and the scene
counts they share, from the configuration alone."""

from benchmark.reference import meshes


def scene_counts(config: dict):
    """(triangles, analytic spheres, materials) the path tracer sees."""
    tris = sphs = 0
    for mdl in config["models"]:
        spec = config["meshes"][mdl["mesh"]]
        if spec["type"] == "spheres":
            sphs += 1
        else:
            tris += meshes.build(spec)[2].size // 3
    return tris, sphs, len(config["materials"])
