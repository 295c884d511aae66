"""Meshes + procedural geometry generators.

The port's own numpy copy of `ptre_tpu/models/mesh.py`, unchanged in
behaviour, so both packages build identical meshes. Equivalent of
`IoniqRE/mesh.{h,cu}`: a mesh is host-side numpy SoA
data (positions, normals, triangle indices) plus a ``MeshType`` selecting the
intersection path (`mesh.h:31-38`): TRIANGLES meshes are ray-traced with
Möller–Trumbore; SPHERES meshes are replaced by an analytic sphere drawcall
(radius = scale.x, center = translation — `scene.cu:176-177`) in the path
tracer while still rasterizing their real geometry.

The generators reproduce the reference topologies exactly (vertex order,
winding, index layout): tri (`mesh.cu:66-80`), quad (`mesh.cu:82-98`),
reg_polygon (`mesh.cu:100-128`), cube with 24 verts / 36 indices and per-face
normals (`mesh.cu:130-186`), and the rings×segments uv_sphere with quad bands
+ triangle caps and smooth normals equal to positions (`mesh.cu:190-279`).
There is no device state here — device residency happens at ScenePacket build.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np


class MeshType(enum.IntEnum):
    """Selects the intersection algorithm (reference `mesh.h:31-38`)."""

    TRIANGLES = 0
    SPHERES = 1


@dataclasses.dataclass
class Mesh:
    """Host-side mesh: SoA positions/normals + flat triangle index list."""

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (3*T,) uint32, CW winding
    mesh_type: MeshType = MeshType.TRIANGLES

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        self.normals = np.ascontiguousarray(self.normals, np.float32)
        self.indices = np.ascontiguousarray(self.indices, np.uint32)

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_indices(self) -> int:
        return self.indices.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0] // 3


def _mesh(verts, normals, indices, mesh_type=MeshType.TRIANGLES) -> Mesh:
    return Mesh(
        np.asarray(verts, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(indices, np.uint32),
        mesh_type,
    )


def tri() -> Mesh:
    """Single triangle facing -z (reference `mesh.cu:66-80`)."""
    n = [0.0, 0.0, -1.0]
    verts = [[0.0, 0.5, 0.0], [0.5, -0.5, 0.0], [-0.5, -0.5, 0.0]]
    return _mesh(verts, [n] * 3, [0, 1, 2])


def quad() -> Mesh:
    """Unit quad facing -z (reference `mesh.cu:82-98`)."""
    n = [0.0, 0.0, -1.0]
    verts = [
        [-0.5, -0.5, 0.0],
        [0.5, -0.5, 0.0],
        [0.5, 0.5, 0.0],
        [-0.5, 0.5, 0.0],
    ]
    return _mesh(verts, [n] * 4, [0, 3, 1, 1, 3, 2])


def reg_polygon(vertices: int) -> Mesh:
    """Regular n-gon fan built by roots-of-unity rotation (`mesh.cu:100-128`).

    Vertex 0 is the center; vertex 1 is (0.5, 0, 0); subsequent vertices apply
    successive z-rotations by tau/n (row-vector convention), matching the
    reference's iterated ``vertex.transform(rotation_z(theta))``.
    """
    vertices = max(int(vertices), 3)
    theta = 2.0 * math.pi / vertices
    n = [0.0, 0.0, -1.0]
    verts = [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]]
    # row-vector z-rotation: (x', y') = (x c + y? ...) — v @ Rz with
    # Rz rows [[c, s, 0], [-s, c, 0], [0, 0, 1]] (reference `matrix.cu:399-409`)
    x, y = 0.5, 0.0
    c, s = math.cos(theta), math.sin(theta)
    for _ in range(1, vertices):
        x, y = x * c - y * s, x * s + y * c
        verts.append([x, y, 0.0])

    indices: list[int] = []
    for i in range(1, vertices):
        indices += [i, 0, i + 1]
    indices += [len(verts) - 1, 0, 1]
    return _mesh(verts, [n] * len(verts), indices)


def cube() -> Mesh:
    """Unit cube: 24 vertices with per-face normals, 36 indices (`mesh.cu:130-186`)."""
    v = {
        "a": [-0.5, -0.5, -0.5],
        "b": [0.5, -0.5, -0.5],
        "c": [0.5, 0.5, -0.5],
        "d": [-0.5, 0.5, -0.5],
        "a2": [-0.5, -0.5, 0.5],
        "b2": [0.5, -0.5, 0.5],
        "c2": [0.5, 0.5, 0.5],
        "d2": [-0.5, 0.5, 0.5],
    }
    faces = [
        # (vertex keys in reference order, normal)
        (["a", "b", "c", "d"], [0.0, 0.0, -1.0]),  # -Z back
        (["a2", "b2", "c2", "d2"], [0.0, 0.0, 1.0]),  # +Z front
        (["a2", "d", "a", "d2"], [-1.0, 0.0, 0.0]),  # -X left
        (["b", "c2", "b2", "c"], [1.0, 0.0, 0.0]),  # +X right
        (["a2", "b", "b2", "a"], [0.0, -1.0, 0.0]),  # -Y bottom
        (["d", "c2", "c", "d2"], [0.0, 1.0, 0.0]),  # +Y top
    ]
    verts, normals = [], []
    for keys, n in faces:
        for k in keys:
            verts.append(v[k])
            normals.append(n)
    indices = [
        0, 2, 1, 0, 3, 2,  # -Z
        5, 7, 4, 5, 6, 7,  # +Z
        8, 9, 10, 8, 11, 9,  # -X
        12, 13, 14, 12, 15, 13,  # +X
        16, 17, 18, 16, 19, 17,  # -Y
        20, 21, 22, 20, 23, 21,  # +Y
    ]
    return _mesh(verts, normals, indices)


def uv_sphere(
    flat: bool = False,
    segments: int = 32,
    rings: int = 16,
    mesh_type: MeshType = MeshType.SPHERES,
) -> Mesh:
    """Lat-long unit sphere, reference topology (`mesh.cu:190-279`).

    Built bottom (-y) to top (+y): (rings-1) interior rings of ``segments``
    vertices each (generated by iterated z- then y-rotations of (0,-1,0)),
    then the bottom and top pole vertices appended last. Quad bands between
    interior rings, triangle fans at the caps. Smooth normals = positions.

    ``flat=True`` builds the flat-shaded variant — per-face normals with
    unshared (duplicated) vertices. The reference declares but never
    implements this (`mesh.cu:198` TODO); here it is implemented: outward
    face normal from the triangle cross product per face.

    Default ``mesh_type`` is SPHERES (`mesh.h:93`): such models take the
    analytic-sphere path in the path tracer.
    """
    segments = max(int(segments), 3)
    rings = max(int(rings), 3)
    theta = math.pi / rings  # polar step
    phi = 2.0 * math.pi / segments  # azimuthal step

    def rot_z(p, ang):
        c, s = math.cos(ang), math.sin(ang)
        x, y, z = p
        return [x * c - y * s, x * s + y * c, z]

    def rot_y(p, ang):
        c, s = math.cos(ang), math.sin(ang)
        x, y, z = p
        return [x * c + z * s, y, -x * s + z * c]

    bottom = [0.0, -1.0, 0.0]
    top = [0.0, 1.0, 0.0]
    verts: list[list[float]] = []
    crt_polar = bottom
    for _ in range(1, rings):
        crt_polar = rot_z(crt_polar, theta)
        verts.append(list(crt_polar))
        crt_az = crt_polar
        for _ in range(1, segments):
            crt_az = rot_y(crt_az, phi)
            verts.append(list(crt_az))
    verts.append(list(bottom))
    verts.append(list(top))

    indices: list[int] = []
    # quad bands between interior rings (`mesh.cu:233-253`)
    for i in range(rings - 2):
        for j in range(segments - 1):
            indices += [i * segments + j, i * segments + j + 1, (i + 1) * segments + j + 1]
            indices += [i * segments + j, (i + 1) * segments + j + 1, (i + 1) * segments + j]
        indices += [(i + 1) * segments - 1, i * segments, (i + 1) * segments]
        indices += [(i + 1) * segments - 1, (i + 1) * segments, (i + 2) * segments - 1]

    nv = len(verts)
    top_idx = nv - 1
    bottom_idx = nv - 2
    # cap fans (`mesh.cu:255-275`)
    for i in range(segments - 1):
        indices += [bottom_idx, i + 1, i]
        indices += [top_idx, nv - i - 4, nv - i - 3]
    indices += [bottom_idx, 0, segments - 1]
    indices += [top_idx, nv - 3, nv - segments - 2]

    positions = np.asarray(verts, np.float32)
    if not flat:
        return _mesh(positions, positions.copy(), indices, mesh_type)

    # flat-shaded: duplicate vertices per face with the outward face normal
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    tv = positions[idx]  # (F, 3, 3)
    fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    # orient outward (unit sphere at origin: outward = away from center)
    outward = np.sign(np.einsum("fi,fi->f", fn, tv.mean(axis=1)))
    fn *= np.where(outward == 0.0, 1.0, outward)[:, None]
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    flat_pos = tv.reshape(-1, 3).astype(np.float32)
    flat_nrm = np.repeat(fn, 3, axis=0).astype(np.float32)
    return _mesh(flat_pos, flat_nrm, list(range(flat_pos.shape[0])), mesh_type)
