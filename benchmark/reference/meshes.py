"""Frozen mesh generators of the benchmark: the IoniqRE topologies
(`mesh.cu:130-279`) that the configurations name, as numpy arrays.

The benchmark builds every configuration's geometry from these, hands the
arrays to the program through its public scene API and to the reference
unchanged, so a later edit to the program's own generators cannot move the
yardstick. ``GENERATORS`` maps a configuration's ``generator`` name to its
function; each returns (positions (V, 3), normals (V, 3), indices (3T,)).
"""

from __future__ import annotations

import math

import numpy as np


def cube():
    """Unit cube: 24 vertices with per-face normals, 36 indices."""
    v = {
        "a": [-0.5, -0.5, -0.5], "b": [0.5, -0.5, -0.5], "c": [0.5, 0.5, -0.5],
        "d": [-0.5, 0.5, -0.5], "a2": [-0.5, -0.5, 0.5], "b2": [0.5, -0.5, 0.5],
        "c2": [0.5, 0.5, 0.5], "d2": [-0.5, 0.5, 0.5],
    }
    faces = [
        (["a", "b", "c", "d"], [0.0, 0.0, -1.0]),
        (["a2", "b2", "c2", "d2"], [0.0, 0.0, 1.0]),
        (["a2", "d", "a", "d2"], [-1.0, 0.0, 0.0]),
        (["b", "c2", "b2", "c"], [1.0, 0.0, 0.0]),
        (["a2", "b", "b2", "a"], [0.0, -1.0, 0.0]),
        (["d", "c2", "c", "d2"], [0.0, 1.0, 0.0]),
    ]
    verts = [v[k] for keys, _ in faces for k in keys]
    normals = [n for _, n in faces for _ in range(4)]
    indices = [0, 2, 1, 0, 3, 2, 5, 7, 4, 5, 6, 7, 8, 9, 10, 8, 11, 9,
               12, 13, 14, 12, 15, 13, 16, 17, 18, 16, 19, 17, 20, 21, 22, 20, 23, 21]
    return (np.asarray(verts, np.float32), np.asarray(normals, np.float32),
            np.asarray(indices, np.uint32))


def uv_sphere(segments: int = 32, rings: int = 16):
    """Lat-long unit sphere with smooth normals (= positions): interior rings
    by iterated z- then y-rotations of (0, -1, 0), the two poles last, quad
    bands between rings and triangle fans at the caps."""
    segments = max(int(segments), 3)
    rings = max(int(rings), 3)
    theta = math.pi / rings
    phi = 2.0 * math.pi / segments

    def rot_z(p, ang):
        c, s = math.cos(ang), math.sin(ang)
        return [p[0] * c - p[1] * s, p[0] * s + p[1] * c, p[2]]

    def rot_y(p, ang):
        c, s = math.cos(ang), math.sin(ang)
        return [p[0] * c + p[2] * s, p[1], -p[0] * s + p[2] * c]

    verts = []
    polar = [0.0, -1.0, 0.0]
    for _ in range(1, rings):
        polar = rot_z(polar, theta)
        verts.append(list(polar))
        az = polar
        for _ in range(1, segments):
            az = rot_y(az, phi)
            verts.append(list(az))
    verts.append([0.0, -1.0, 0.0])
    verts.append([0.0, 1.0, 0.0])

    idx = []
    for i in range(rings - 2):
        for j in range(segments - 1):
            idx += [i * segments + j, i * segments + j + 1, (i + 1) * segments + j + 1]
            idx += [i * segments + j, (i + 1) * segments + j + 1, (i + 1) * segments + j]
        idx += [(i + 1) * segments - 1, i * segments, (i + 1) * segments]
        idx += [(i + 1) * segments - 1, (i + 1) * segments, (i + 2) * segments - 1]
    nv = len(verts)
    top, bottom = nv - 1, nv - 2
    for i in range(segments - 1):
        idx += [bottom, i + 1, i]
        idx += [top, nv - i - 4, nv - i - 3]
    idx += [bottom, 0, segments - 1]
    idx += [top, nv - 3, nv - segments - 2]
    pos = np.asarray(verts, np.float32)
    return pos, pos.copy(), np.asarray(idx, np.uint32)


GENERATORS = {"cube": cube, "uv_sphere": uv_sphere}


def build(spec: dict):
    """The arrays of a configuration's mesh entry: ``generator`` and its
    arguments (``segments``, ``rings``)."""
    args = {k: spec[k] for k in ("segments", "rings") if k in spec}
    return GENERATORS[spec["generator"]](**args)
