"""Scene graph + device-resident SoA ScenePacket.

PyTorch port of `ptre_tpu/models/scene.py`. ``Scene`` is the same host-side
numpy graph (name → mesh and name → model maps, models walked sorted by mesh
name with insertion-order tie-break, a ``modified`` flag). ``ScenePacket`` is
a dataclass of tensors with the reference packet's leaves, padding
(``tri_pad`` 128, ``sph_pad`` 8, pad radius 1) and static counts, so both
packages build bit-identical geometry from one scene description. Meshes
are the port's own (`ptre_tpu_torch/models/mesh.py`, a numpy copy of the
reference generators), and errors the port's `SceneError`.

Sphere models ignore rotation and non-uniform scale: radius = scale.x and
center = translation (`scene.cu:176-177`).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ptre_tpu_torch.models.mesh import Mesh, MeshType
from ptre_tpu_torch.utils.device import resolve
from ptre_tpu_torch.utils.errors import SceneError
from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.ops.cuda.take_rows import take_rows


class MaterialKind(enum.IntEnum):
    OREN_NAYAR = 0
    EMISSIVE = 1


@dataclasses.dataclass
class Material:
    """Albedo + one scalar: roughness sigma (OREN_NAYAR) or emission
    strength (EMISSIVE)."""

    kind: MaterialKind
    albedo: Tuple[float, float, float]
    param: float


#: default sphere material (reference `path_tracer.cu:248`)
DEFAULT_OREN_NAYAR = Material(MaterialKind.OREN_NAYAR, (0.5, 0.5, 0.5), 1.0)
#: default triangle-mesh material (reference `path_tracer.cu:249`)
DEFAULT_EMISSIVE = Material(MaterialKind.EMISSIVE, (1.0, 1.0, 1.0), 10.0)
#: default sky gradient endpoints (`path_tracer.cu:307-316`)
DEFAULT_SKY_BOTTOM = (1.0, 1.0, 1.0)
DEFAULT_SKY_TOP = (0.5, 0.7, 1.0)


@dataclasses.dataclass
class Model:
    """A scene instance: mesh name + TRS, ``transform = S @ Rx @ Ry @ Rz @ T``
    (`model.cu:11-18`). ``material`` None selects the type default."""

    mesh_name: str = "default"
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    material: Optional[int] = None
    _on_mutate: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def set_transforms(self, scale=1.0, rotation=0.0, translation=0.0):
        self.scale = _as3(scale)
        self.rotation = _as3(rotation)
        self.translation = _as3(translation)
        if self._on_mutate is not None:
            self._on_mutate()

    def set_material(self, material: Optional[int]):
        self.material = material
        if self._on_mutate is not None:
            self._on_mutate()

    def transform_matrix(self) -> np.ndarray:
        s = np.diag(list(self.scale) + [1.0]).astype(np.float32)
        rx, ry, rz = self.rotation
        r = _np_rot_x(rx) @ _np_rot_y(ry) @ _np_rot_z(rz)
        t = np.eye(4, dtype=np.float32)
        t[3, :3] = self.translation
        return (s @ r @ t).astype(np.float32)


def _as3(v) -> Tuple[float, float, float]:
    if np.isscalar(v):
        return (float(v), float(v), float(v))
    return tuple(float(x) for x in np.asarray(v).reshape(-1)[:3])


def _np_rot_x(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, s, -s, c
    return m


def _np_rot_y(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def _np_rot_z(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, s, -s, c
    return m


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


#: tensor leaves of a ScenePacket, in the reference packet's field order
PACKET_LEAVES = (
    "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2", "tri_dc",
    "tri_mat", "tri_valid", "transforms", "sph_center", "sph_radius",
    "sph_mat", "sph_valid", "mat_kind", "mat_albedo", "mat_param",
    "sky_bottom", "sky_top",
)
#: static (host int) counts of a ScenePacket
PACKET_COUNTS = ("num_triangles", "num_spheres", "num_drawcalls",
                 "num_materials")
#: the kinds of `ScenePacket.drawcall_params`: a drawcall whose model is a row
#: of the path-traced packet's ``transforms``, or one of its analytic spheres
DC_TRANSFORM, DC_SPHERE = 0, 1


@dataclasses.dataclass
class ScenePacket:
    """Padded static-shape SoA scene. Triangles keep object-space corners and
    a ``tri_dc`` row into ``transforms``; world space is applied once per
    frame by `world_triangles`. Dtypes follow the reference: float32 geometry,
    int32 indices, bool masks."""

    tri_v0: torch.Tensor  # (T, 3) object space
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n0: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_dc: torch.Tensor  # (T,) int32 → transforms row
    tri_mat: torch.Tensor  # (T,) int32 → material row
    tri_valid: torch.Tensor  # (T,) bool
    transforms: torch.Tensor  # (D, 4, 4)
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_mat: torch.Tensor  # (S,) int32
    sph_valid: torch.Tensor  # (S,) bool
    mat_kind: torch.Tensor  # (M,) int32 MaterialKind
    mat_albedo: torch.Tensor  # (M, 3)
    mat_param: torch.Tensor  # (M,)
    sky_bottom: torch.Tensor  # (3,)
    sky_top: torch.Tensor  # (3,)
    num_triangles: int = 0
    num_spheres: int = 0
    num_drawcalls: int = 0
    num_materials: int = 0
    #: per drawcall, whose parameters its model has in the path-traced packet
    #: of the same scene: (DC_TRANSFORM, row of ``transforms``) or
    #: (DC_SPHERE, index into ``sph_center`` and ``sph_radius``); empty for
    #: packets made elsewhere (`native_scene`, `interop`)
    drawcall_params: Tuple[Tuple[int, int], ...] = ()

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], drawcall_params=(),
                   **counts) -> "ScenePacket":
        """Packet from numpy leaves (``PACKET_LEAVES``) + static counts."""
        leaves = {k: torch.from_numpy(np.array(arrays[k])) for k in PACKET_LEAVES}
        return cls(**leaves, **{k: int(counts[k]) for k in PACKET_COUNTS},
                   drawcall_params=tuple(drawcall_params))

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "ScenePacket":
        """The same packet with every leaf on ``device``."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in PACKET_LEAVES})

    def world_triangles(self):
        """World-space (v0, v1, v2, n0, n1, n2), each (T, 3): vertices by the
        drawcall transform (POINT), normals by its inverse-transpose 3x3
        (`ptre_tpu/models/scene.py:186-208`)."""
        tf = take_rows(self.transforms, self.tri_dc)  # (T, 4, 4)
        nm = vm.normal_matrix(tf)

        def point(p):
            return torch.einsum("ti,tij->tj", p, tf[:, :3, :3]) + tf[:, 3, :3]

        def normal(n):
            return torch.einsum("ti,tij->tj", n, nm)

        return (point(self.tri_v0), point(self.tri_v1), point(self.tri_v2),
                normal(self.tri_n0), normal(self.tri_n1), normal(self.tri_n2))


class Scene:
    """Mutable host-side scene graph (reference `scene.{h,cu}`)."""

    def __init__(self):
        self._meshes: Dict[str, Mesh] = {}
        self._models: Dict[str, Model] = {}
        self._model_order: Dict[str, int] = {}
        self._materials: List[Material] = [DEFAULT_OREN_NAYAR, DEFAULT_EMISSIVE]
        self._sky_bottom = DEFAULT_SKY_BOTTOM
        self._sky_top = DEFAULT_SKY_TOP
        self._next_order = 0
        self._modified = True

    def set_sky(self, bottom, top):
        self._sky_bottom = tuple(float(x) for x in bottom)
        self._sky_top = tuple(float(x) for x in top)
        self._modified = True

    def add_mesh(self, name: str, m: Mesh) -> bool:
        if name in self._meshes:
            return False  # reference silently refuses duplicate insert
        self._meshes[name] = m
        self._modified = True
        return True

    def rename_mesh(self, old: str, new: str):
        """Rename a mesh and repoint the models that use it; a missing
        ``old`` or a taken ``new`` changes nothing."""
        if old not in self._meshes or new in self._meshes:
            return
        self._meshes[new] = self._meshes.pop(old)
        for mdl in self._models.values():
            if mdl.mesh_name == old:
                mdl.mesh_name = new
        self._modified = True

    def delete_mesh(self, name: str):
        """Delete an unused mesh; SceneError while a model uses it."""
        if name not in self._meshes:
            return
        in_use = [mn for mn, mdl in self._models.items() if mdl.mesh_name == name]
        if in_use:
            raise SceneError(f"mesh '{name}' still referenced by models {in_use}")
        del self._meshes[name]
        self._modified = True

    def get_mesh(self, name: str) -> Mesh:
        return self._meshes[name]

    @property
    def mesh_names(self) -> List[str]:
        return sorted(self._meshes)

    def add_model(self, name: str, m: Model) -> bool:
        if name in self._models:
            return False
        if m.mesh_name not in self._meshes:
            raise SceneError(f"model '{name}' references unknown mesh '{m.mesh_name}'")
        self._models[name] = m
        m._on_mutate = self._mark_modified
        self._model_order[name] = self._next_order
        self._next_order += 1
        self._modified = True
        return True

    def _mark_modified(self):
        self._modified = True

    def rename_model(self, old: str, new: str):
        """Rename a model, keeping its place in the walk; a missing ``old``
        or a taken ``new`` changes nothing."""
        if old not in self._models or new in self._models:
            return
        self._models[new] = self._models.pop(old)
        self._model_order[new] = self._model_order.pop(old)
        self._modified = True

    def delete_model(self, name: str):
        if name in self._models:
            del self._models[name]
            del self._model_order[name]
            self._modified = True

    def get_model(self, name: str) -> Model:
        """Read access does not dirty the scene; the Model's setters do."""
        return self._models[name]

    def change_model_mesh(self, model_name: str, new_mesh_name: str):
        if new_mesh_name not in self._meshes:
            raise SceneError(f"unknown mesh '{new_mesh_name}'")
        self._models[model_name].mesh_name = new_mesh_name
        self._modified = True

    def add_material(self, m: Material) -> int:
        self._materials.append(m)
        self._modified = True
        return len(self._materials) - 1

    def set_model_material(self, model_name: str, material_id: int):
        if not (0 <= material_id < len(self._materials)):
            raise SceneError(f"material id {material_id} out of range")
        self._models[model_name].material = material_id
        self._modified = True

    @property
    def materials(self) -> List[Material]:
        return list(self._materials)

    def modified(self) -> bool:
        return self._modified

    def sorted_models(self) -> List[Tuple[str, Model]]:
        """Models sorted by mesh name, insertion-order tie-break (`scene.h:58-68`)."""
        return sorted(
            self._models.items(),
            key=lambda kv: (kv[1].mesh_name, self._model_order[kv[0]]),
        )

    def build_packet(self, tri_pad: int = 128, sph_pad: int = 8,
                     spheres_as_triangles: bool = False, device=None) -> ScenePacket:
        """Flatten the scene into a padded ScenePacket on ``device``, walking
        models exactly like `scene.cu:156-181`. ``device`` None means the
        card (`utils.device.resolve`: RendererError where there is none);
        ``"cpu"`` builds it on the host. With ``spheres_as_triangles`` every
        model emits its mesh as triangles (the rasterizer's view), and
        ``drawcall_params`` says which of them are the path-traced view's
        analytic spheres. Clears the modified flag."""
        device = resolve(device)
        self._modified = False

        tv0, tv1, tv2, tn0, tn1, tn2 = [], [], [], [], [], []
        tdc, tmat, transforms, dc_params = [], [], [], []
        sph_c, sph_r, sph_m = [], [], []
        n_tri_models = n_sph_models = 0
        for _, mdl in self.sorted_models():
            mesh = self._meshes[mdl.mesh_name]
            is_sphere = mesh.mesh_type == MeshType.SPHERES
            source = ((DC_SPHERE, n_sph_models) if is_sphere
                      else (DC_TRANSFORM, n_tri_models))
            n_sph_models += is_sphere
            n_tri_models += not is_sphere
            if is_sphere and not spheres_as_triangles:
                sph_c.append(mdl.translation)
                sph_r.append(mdl.scale[0])
                sph_m.append(mdl.material if mdl.material is not None
                             else int(MaterialKind.OREN_NAYAR))
            else:
                dc = len(transforms)
                dc_params.append(source)
                transforms.append(mdl.transform_matrix())
                idx = mesh.indices.reshape(-1, 3)
                for corner, (vs, ns) in enumerate(((tv0, tn0), (tv1, tn1),
                                                   (tv2, tn2))):
                    vs.append(mesh.positions[idx[:, corner]])
                    ns.append(mesh.normals[idx[:, corner]])
                ntri = idx.shape[0]
                tdc.append(np.full(ntri, dc, np.int32))
                mat = (mdl.material if mdl.material is not None
                       else int(MaterialKind.EMISSIVE))
                tmat.append(np.full(ntri, mat, np.int32))

        num_tris = sum(a.shape[0] for a in tv0)
        num_sph = len(sph_c)
        num_dc = len(transforms)
        t_cap = _round_up(num_tris, tri_pad)
        s_cap = _round_up(num_sph, sph_pad)

        def cat_pad(parts, cap):
            out = np.zeros((cap, 3), np.float32)
            if parts:
                a = np.concatenate([np.asarray(p, np.float32).reshape(-1, 3)
                                    for p in parts])
                out[: a.shape[0]] = a
            return out

        def cat_pad_i(parts, cap):
            out = np.zeros((cap,), np.int32)
            if parts:
                a = np.concatenate(parts)
                out[: a.shape[0]] = a
            return out

        tf = (np.stack(transforms) if transforms
              else np.eye(4, dtype=np.float32)[None])
        sc = np.zeros((s_cap, 3), np.float32)
        sr = np.ones((s_cap,), np.float32)  # pad radius 1: no 0-div in normals
        sm = np.zeros((s_cap,), np.int32)
        if num_sph:
            sc[:num_sph] = np.asarray(sph_c, np.float32)
            sr[:num_sph] = np.asarray(sph_r, np.float32)
            sm[:num_sph] = np.asarray(sph_m, np.int32)

        mats = self._materials
        arrays = dict(
            tri_v0=cat_pad(tv0, t_cap), tri_v1=cat_pad(tv1, t_cap),
            tri_v2=cat_pad(tv2, t_cap), tri_n0=cat_pad(tn0, t_cap),
            tri_n1=cat_pad(tn1, t_cap), tri_n2=cat_pad(tn2, t_cap),
            tri_dc=cat_pad_i(tdc, t_cap), tri_mat=cat_pad_i(tmat, t_cap),
            tri_valid=np.arange(t_cap) < num_tris,
            transforms=tf.astype(np.float32),
            sph_center=sc, sph_radius=sr, sph_mat=sm,
            sph_valid=np.arange(s_cap) < num_sph,
            mat_kind=np.asarray([int(m.kind) for m in mats], np.int32),
            mat_albedo=np.asarray([m.albedo for m in mats], np.float32),
            mat_param=np.asarray([m.param for m in mats], np.float32),
            sky_bottom=np.asarray(self._sky_bottom, np.float32),
            sky_top=np.asarray(self._sky_top, np.float32),
        )
        return ScenePacket.from_numpy(
            arrays, drawcall_params=dc_params, num_triangles=num_tris, num_spheres=num_sph,
            num_drawcalls=num_dc, num_materials=len(mats)).to(device)

    def raster_drawcalls(self):
        """(model name, mesh, transform) per model in the walk's order, mesh
        bind reuse left to the caller (reference `rasterizer.cu:157-169`).
        SPHERES-type meshes rasterize their true geometry."""
        return [(name, self._meshes[mdl.mesh_name], mdl.transform_matrix())
                for name, mdl in self.sorted_models()]
