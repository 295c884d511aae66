"""The reference's scene and camera, worked out from a configuration file.

A configuration names meshes (a generator of `meshes.py` and whether the
path tracer sees it as triangles or as one analytic sphere), models (mesh,
scale, Euler rotation, translation, material index, in insertion order), a
material table, the sky and a perspective camera. `Scene.from_config` flattens
them as the IoniqRE scene walk does (`scene.cu:156-181`): models sorted by mesh
name with insertion order breaking ties; a sphere-type model becomes one
analytic sphere (centre = translation, radius = scale.x); every other model
emits its triangles in object space with a row into the transform table
``S @ Rx @ Ry @ Rz @ T`` (row vectors). Triangle rows are padded to a
multiple of 128 and spheres to a multiple of 8 (radius 1), padding invalid:
the layout whose ten float leaves (`Scene.params`: transforms, spheres,
materials, sky, camera pose and fov) a training step differentiates.

Camera (`camera.cu:11-43`): a left-handed look-at view, a D3D perspective
projection with clip z in [0, 1]; a ray unprojects the near (z = 0) and far
(z = 1) points of its jittered pixel's NDC through inv(proj) with a w-divide,
then inv(view), and runs near to far with a unit direction.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import meshes

TRI_PAD = 128
SPH_PAD = 8
KIND = {"oren_nayar": 0, "emissive": 1}


def _rot(axis: int, a: float):
    c, s = math.cos(a), math.sin(a)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m = np.eye(4, dtype=np.float32)
    m[i, i], m[j, j] = c, c
    if axis == 1:  # y: [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        m[i, j], m[j, i] = -s, s
    else:
        m[i, j], m[j, i] = s, -s
    return m


def transform_matrix(model: dict) -> np.ndarray:
    """``S @ Rx @ Ry @ Rz @ T`` of a model entry, float32 (`model.cu:11-18`)."""
    s = np.diag(list(model["scale"]) + [1.0]).astype(np.float32)
    rx, ry, rz = model["rotation"]
    t = np.eye(4, dtype=np.float32)
    t[3, :3] = model["translation"]
    return (s @ _rot(0, rx) @ _rot(1, ry) @ _rot(2, rz) @ t).astype(np.float32)


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


def walk(config: dict):
    """The models in the scene walk's order: by mesh name, ties in insertion
    order."""
    order = {m["name"]: i for i, m in enumerate(config["models"])}
    return sorted(config["models"], key=lambda m: (m["mesh"], order[m["name"]]))


@dataclasses.dataclass
class Scene:
    """Padded scene arrays on one device (float32 geometry, int64 indices)."""

    tri_obj: torch.Tensor  # (T, 6, 3): v0 v1 v2 n0 n1 n2 in object space
    tri_dc: torch.Tensor  # (T,)
    tri_mat: torch.Tensor  # (T,)
    tri_valid: torch.Tensor  # (T,) bool
    sph_mat: torch.Tensor  # (S,)
    sph_valid: torch.Tensor  # (S,) bool
    mat_kind: torch.Tensor  # (M,)
    params: dict  # the float leaves a training step differentiates
    width: int
    height: int
    znear: float
    zfar: float

    @property
    def device(self):
        return self.tri_obj.device

    @classmethod
    def from_config(cls, config: dict, device) -> "Scene":
        mesh_arrays = {name: meshes.build(spec) for name, spec in config["meshes"].items()}
        tris, dcs, tmats, transforms, sphs = [], [], [], [], []
        for mdl in walk(config):
            spec = config["meshes"][mdl["mesh"]]
            if spec["type"] == "spheres":
                sphs.append((mdl["translation"], mdl["scale"][0], mdl["material"]))
                continue
            pos, nrm, idx = mesh_arrays[mdl["mesh"]]
            idx = idx.reshape(-1, 3).astype(np.int64)
            tris.append(np.stack([pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]],
                                  nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]], axis=1))
            dcs.append(np.full(idx.shape[0], len(transforms)))
            tmats.append(np.full(idx.shape[0], mdl["material"]))
            transforms.append(transform_matrix(mdl))
        n_tri = sum(t.shape[0] for t in tris)
        t_cap, s_cap = _round_up(n_tri, TRI_PAD), _round_up(len(sphs), SPH_PAD)
        tri_obj = np.zeros((t_cap, 6, 3), np.float32)
        tri_dc = np.zeros(t_cap, np.int64)
        tri_mat = np.zeros(t_cap, np.int64)
        if tris:
            tri_obj[:n_tri] = np.concatenate(tris)
            tri_dc[:n_tri] = np.concatenate(dcs)
            tri_mat[:n_tri] = np.concatenate(tmats)
        centre = np.zeros((s_cap, 3), np.float32)
        radius = np.ones(s_cap, np.float32)
        sph_mat = np.zeros(s_cap, np.int64)
        for i, (c, r, m) in enumerate(sphs):
            centre[i], radius[i], sph_mat[i] = c, r, m
        mats = config["materials"]
        cam = config["camera"]
        tf = np.stack(transforms) if transforms else np.eye(4, dtype=np.float32)[None]

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        params = {
            "transforms": f32(tf), "sph_center": f32(centre), "sph_radius": f32(radius),
            "mat_albedo": f32([m["albedo"] for m in mats]),
            "mat_param": f32([m["param"] for m in mats]),
            "sky_bottom": f32(config["sky"]["bottom"]), "sky_top": f32(config["sky"]["top"]),
            "cam_position": f32(cam["position"]), "cam_forward": f32(cam["forward"]),
            "cam_fov": f32(cam["fov_degrees"]),
        }
        return cls(
            tri_obj=f32(tri_obj), tri_dc=torch.as_tensor(tri_dc, device=device),
            tri_mat=torch.as_tensor(tri_mat, device=device),
            tri_valid=torch.arange(t_cap, device=device) < n_tri,
            sph_mat=torch.as_tensor(sph_mat, device=device),
            sph_valid=torch.arange(s_cap, device=device) < len(sphs),
            mat_kind=torch.as_tensor([KIND[m["kind"]] for m in mats], device=device),
            params=params, width=int(config["width"]), height=int(config["height"]),
            znear=float(cam["znear"]), zfar=float(cam["zfar"]))


def world_triangles(scene: Scene, transforms):
    """World-space (T, 6, 3): corners by each drawcall's transform (points,
    row vectors), normals by the inverse-transpose of its 3x3."""
    tf = transforms[scene.tri_dc]
    nm = torch.linalg.inv_ex(tf[:, :3, :3]).inverse.transpose(-1, -2)
    pts = torch.einsum("tki,tij->tkj", scene.tri_obj[:, :3], tf[:, :3, :3]) + tf[:, None, 3, :3]
    nrm = torch.einsum("tki,tij->tkj", scene.tri_obj[:, 3:], nm)
    return torch.cat([pts, nrm], dim=1)


def _normalize(v):
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    pos = n2 > 0
    return v * torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2, torch.ones_like(n2))),
                           torch.zeros_like(n2))


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _inverse(m):
    """4x4 inverse; a matrix with |det| < 1e-5 inverts to infinities."""
    bad = torch.abs(torch.linalg.det(m)) < 1e-5
    eye = torch.eye(4, dtype=m.dtype, device=m.device)
    inv = torch.linalg.inv_ex(torch.where(bad, eye, m)).inverse
    return torch.where(bad, torch.full_like(m, math.inf), inv)


def camera_inverses(position, forward, fov_degrees, width: int, height: int,
                    znear: float, zfar: float):
    """(inv(view), inv(proj)) of the camera, differentiable in its leaves."""
    fwd = _normalize((position + forward) - position)
    right = _cross(torch.stack([torch.zeros_like(fwd[0]), torch.ones_like(fwd[0]),
                                torch.zeros_like(fwd[0])]), fwd)
    up = _cross(fwd, right)
    zero, one = torch.zeros_like(fwd[0]), torch.ones_like(fwd[0])
    view = torch.stack([
        torch.stack([right[0], up[0], fwd[0], zero]),
        torch.stack([right[1], up[1], fwd[1], zero]),
        torch.stack([right[2], up[2], fwd[2], zero]),
        torch.stack([-torch.sum(right * position), -torch.sum(up * position),
                     -torch.sum(fwd * position), one])])
    y_scale = 1.0 / torch.tan(fov_degrees * (math.pi / 180.0) * 0.5)
    x_scale = y_scale / (width / height)
    zz = zfar / (zfar - znear)
    proj = torch.stack([
        torch.stack([x_scale, zero, zero, zero]),
        torch.stack([zero, y_scale, zero, zero]),
        torch.stack([zero, zero, zero + zz, one]),
        torch.stack([zero, zero, zero - znear * zfar / (zfar - znear), zero])])
    return _inverse(view), _inverse(proj)


def primary_rays(inverses, width: int, height: int, px, py, jx, jy):
    """Rays through pixels (px, py) + jitter (jx, jy) in [-0.5, 0.5):
    (origins, unit directions), (R, 3) each."""
    inv_view, inv_proj = inverses
    x = ((px + jx) / width) * 2.0 - 1.0
    y = 1.0 - ((py + jy) / height) * 2.0

    def unproject(z):
        p = torch.stack([x, y, torch.full_like(x, z)], dim=-1)
        xyz = p @ inv_proj[:3, :3] + inv_proj[3, :3]
        w = p @ inv_proj[:3, 3] + inv_proj[3, 3]
        return (xyz / w[:, None]) @ inv_view[:3, :3] + inv_view[3, :3]

    near = unproject(0.0)
    return near, _normalize(unproject(1.0) - near)
