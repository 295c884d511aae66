"""ctypes binding for the native C++ scene-graph runtime (native/scene_core.cpp).

The port's counterpart of `ptre_tpu/models/native_scene.py`: the same C ABI
and the same `NativeScene` API, whose `build_packet` emits the port's
`ScenePacket` (tensors on ``device``, default the card), leaf for leaf the
packet `Scene.build_packet` builds for the same scene. The sky leaves are
the defaults, since the C++ core has no sky.

The shared library is built at first use with ``g++`` and the Makefile's
flags (``-O2 -std=c++17 -fPIC -shared``) into ``ptre_tpu_torch/_build/``
(git-ignored), under a name keyed on a hash of the source, written to a
temporary name and swapped in with ``os.replace``, so concurrent builds both
succeed. It is never built into ``native/``, where the JAX package builds
its own copy with ``make``.
"""

from __future__ import annotations

import ctypes as C
import functools
import hashlib
import os
import shutil
import subprocess
from typing import List

import numpy as np

from ptre_tpu_torch.models.mesh import MeshType
from ptre_tpu_torch.models.scene import (
    DEFAULT_EMISSIVE, DEFAULT_OREN_NAYAR, DEFAULT_SKY_BOTTOM, DEFAULT_SKY_TOP, Material,
    MaterialKind, ScenePacket, _round_up,
)
from ptre_tpu_torch.utils.device import resolve
from ptre_tpu_torch.utils.errors import SceneError

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "scene_core.cpp")
BUILD_DIR = os.path.join(_REPO, "ptre_tpu_torch", "_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libptre_scene_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the library into ``_build/`` unless it is there; returns its
    path. A missing compiler or a failed build raises SceneError."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise SceneError("no C++ compiler (g++) to build the native scene library")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SceneError(f"building {SOURCE} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds both succeed
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> C.CDLL:
    """Build (if needed) and load the library; cached per process."""
    lib = C.CDLL(build_library())
    lib.ptre_scene_create.restype = C.c_void_p
    lib.ptre_scene_create.argtypes = []
    for name, args in {
        "ptre_scene_destroy": [C.c_void_p],
        "ptre_scene_modified": [C.c_void_p],
        "ptre_scene_add_mesh_tri": [C.c_void_p, C.c_char_p],
        "ptre_scene_add_mesh_quad": [C.c_void_p, C.c_char_p],
        "ptre_scene_add_mesh_reg_polygon": [C.c_void_p, C.c_char_p, C.c_uint32],
        "ptre_scene_add_mesh_cube": [C.c_void_p, C.c_char_p],
        "ptre_scene_add_mesh_uv_sphere": [
            C.c_void_p, C.c_char_p, C.c_int, C.c_uint32, C.c_uint32, C.c_int32,
        ],
        "ptre_scene_add_mesh_raw": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_uint32,
            C.c_void_p, C.c_uint32, C.c_int32,
        ],
        "ptre_scene_rename_mesh": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_delete_mesh": [C.c_void_p, C.c_char_p],
        "ptre_scene_mesh_counts": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_mesh_data": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_add_model": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_rename_model": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_delete_model": [C.c_void_p, C.c_char_p],
        "ptre_scene_set_transforms": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_set_model_material": [C.c_void_p, C.c_char_p, C.c_int32],
        "ptre_scene_change_model_mesh": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_packet_counts": [
            C.c_void_p, C.c_int, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_build_packet": [C.c_void_p, C.c_int, C.c_int32, C.c_int32]
        + [C.c_void_p] * 12,
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None if name in ("ptre_scene_destroy", "ptre_scene_packet_counts") \
            else C.c_int
    return lib


def _f3(v):
    """A C float[3] of a scalar (broadcast) or a 3-vector."""
    vv = np.broadcast_to(np.asarray(v, np.float32).reshape(-1), (3,))
    return (C.c_float * 3)(*(float(x) for x in vv))


class NativeScene:
    """Scene graph backed by the C++ core; Python keeps only the material table."""

    def __init__(self):
        self._lib = load_library()
        self._h = C.c_void_p(self._lib.ptre_scene_create())
        self._materials: List[Material] = [DEFAULT_OREN_NAYAR, DEFAULT_EMISSIVE]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ptre_scene_destroy(h)
            self._h = None

    # -- mesh CRUD -----------------------------------------------------------
    def add_mesh_tri(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_add_mesh_tri(self._h, name.encode()))

    def add_mesh_quad(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_add_mesh_quad(self._h, name.encode()))

    def add_mesh_reg_polygon(self, name: str, vertices: int) -> bool:
        return bool(
            self._lib.ptre_scene_add_mesh_reg_polygon(self._h, name.encode(), vertices)
        )

    def add_mesh_cube(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_add_mesh_cube(self._h, name.encode()))

    def add_mesh_uv_sphere(
        self, name: str, flat=False, segments=32, rings=16,
        mesh_type: MeshType = MeshType.SPHERES,
    ) -> bool:
        return bool(
            self._lib.ptre_scene_add_mesh_uv_sphere(
                self._h, name.encode(), int(flat), segments, rings, int(mesh_type)
            )
        )

    def add_mesh_raw(self, name, positions, normals, indices,
                     mesh_type: MeshType = MeshType.TRIANGLES) -> bool:
        p = np.ascontiguousarray(positions, np.float32)
        n = np.ascontiguousarray(normals, np.float32)
        i = np.ascontiguousarray(indices, np.uint32)
        if p.ndim != 2 or p.shape[1] != 3 or n.shape != p.shape or i.ndim != 1:
            raise SceneError(f"raw mesh '{name}': positions and normals must be (V, 3) and "
                             f"indices (I,), got {p.shape}, {n.shape}, {i.shape}")
        if i.size and int(i.max()) >= p.shape[0]:
            raise SceneError(f"raw mesh '{name}': index {int(i.max())} past {p.shape[0]} "
                             "vertices")
        return bool(
            self._lib.ptre_scene_add_mesh_raw(
                self._h, name.encode(), p.ctypes.data, n.ctypes.data,
                p.shape[0], i.ctypes.data, i.shape[0], int(mesh_type),
            )
        )

    def rename_mesh(self, old: str, new: str) -> bool:
        return bool(self._lib.ptre_scene_rename_mesh(self._h, old.encode(), new.encode()))

    def delete_mesh(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_delete_mesh(self._h, name.encode()))

    def _mesh_counts(self, name: str):
        nv, ni, ty = C.c_uint32(), C.c_uint32(), C.c_int32()
        ok = self._lib.ptre_scene_mesh_counts(
            self._h, name.encode(), C.byref(nv), C.byref(ni), C.byref(ty))
        return bool(ok), nv.value, ni.value, ty.value

    def get_mesh_arrays(self, name: str):
        ok, nv, ni, ty = self._mesh_counts(name)
        if not ok:
            raise SceneError(f"unknown mesh '{name}'")
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nv, 3), np.float32)
        idx = np.empty((ni,), np.uint32)
        self._lib.ptre_scene_mesh_data(
            self._h, name.encode(), pos.ctypes.data, nrm.ctypes.data, idx.ctypes.data
        )
        return pos, nrm, idx, MeshType(ty)

    def has_mesh(self, name: str) -> bool:
        return self._mesh_counts(name)[0]

    # -- model CRUD ----------------------------------------------------------
    def add_model(self, name: str, mesh_name: str) -> bool:
        ok = bool(self._lib.ptre_scene_add_model(self._h, name.encode(), mesh_name.encode()))
        if not ok and not self.has_mesh(mesh_name):
            raise SceneError(f"model '{name}' references unknown mesh '{mesh_name}'")
        return ok

    def rename_model(self, old: str, new: str) -> bool:
        return bool(self._lib.ptre_scene_rename_model(self._h, old.encode(), new.encode()))

    def delete_model(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_delete_model(self._h, name.encode()))

    def set_transforms(self, model: str, scale=1.0, rotation=0.0, translation=0.0) -> bool:
        return bool(
            self._lib.ptre_scene_set_transforms(
                self._h, model.encode(), _f3(scale), _f3(rotation), _f3(translation)
            )
        )

    def change_model_mesh(self, model: str, mesh: str) -> bool:
        return bool(
            self._lib.ptre_scene_change_model_mesh(self._h, model.encode(), mesh.encode())
        )

    # -- materials (Python-side table, ids passed to C) ----------------------
    def add_material(self, m: Material) -> int:
        self._materials.append(m)
        return len(self._materials) - 1

    def set_model_material(self, model: str, material_id: int) -> bool:
        if not (0 <= material_id < len(self._materials)):
            raise SceneError(f"material id {material_id} out of range")
        return bool(
            self._lib.ptre_scene_set_model_material(self._h, model.encode(), material_id)
        )

    def modified(self) -> bool:
        return bool(self._lib.ptre_scene_modified(self._h))

    # -- packet --------------------------------------------------------------
    def build_packet(
        self, tri_pad: int = 128, sph_pad: int = 8,
        spheres_as_triangles: bool = False, device=None,
    ) -> ScenePacket:
        """Flatten the scene into a padded ScenePacket on ``device`` (None:
        the card, RendererError where there is none), as
        `Scene.build_packet`. Clears the modified flag."""
        device = resolve(device)
        nt, ns, nd = C.c_uint32(), C.c_uint32(), C.c_uint32()
        self._lib.ptre_scene_packet_counts(
            self._h, int(spheres_as_triangles), C.byref(nt), C.byref(ns), C.byref(nd)
        )
        T, S, D = nt.value, ns.value, nd.value
        t_cap = _round_up(T, tri_pad)
        s_cap = _round_up(S, sph_pad)
        d_cap = max(D, 1)

        tv = [np.zeros((t_cap, 3), np.float32) for _ in range(6)]
        tri_dc = np.zeros((t_cap,), np.int32)
        tri_mat = np.zeros((t_cap,), np.int32)
        tf = np.tile(np.eye(4, dtype=np.float32).reshape(1, 16), (d_cap, 1))
        sc = np.zeros((s_cap, 3), np.float32)
        sr = np.ones((s_cap,), np.float32)
        sm = np.zeros((s_cap,), np.int32)

        self._lib.ptre_scene_build_packet(
            self._h, int(spheres_as_triangles),
            int(MaterialKind.EMISSIVE), int(MaterialKind.OREN_NAYAR),
            *(a.ctypes.data for a in tv),
            tri_dc.ctypes.data, tri_mat.ctypes.data, tf.ctypes.data,
            sc.ctypes.data, sr.ctypes.data, sm.ctypes.data,
        )

        mats = self._materials
        arrays = dict(
            tri_v0=tv[0], tri_v1=tv[1], tri_v2=tv[2],
            tri_n0=tv[3], tri_n1=tv[4], tri_n2=tv[5],
            tri_dc=tri_dc, tri_mat=tri_mat,
            tri_valid=np.arange(t_cap) < T,
            transforms=tf.reshape(d_cap, 4, 4),
            sph_center=sc, sph_radius=sr, sph_mat=sm,
            sph_valid=np.arange(s_cap) < S,
            mat_kind=np.asarray([int(m.kind) for m in mats], np.int32),
            mat_albedo=np.asarray([m.albedo for m in mats], np.float32),
            mat_param=np.asarray([m.param for m in mats], np.float32),
            sky_bottom=np.asarray(DEFAULT_SKY_BOTTOM, np.float32),
            sky_top=np.asarray(DEFAULT_SKY_TOP, np.float32),
        )
        return ScenePacket.from_numpy(
            arrays, num_triangles=T, num_spheres=S, num_drawcalls=D,
            num_materials=len(mats)).to(device)
