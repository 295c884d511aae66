"""Carry the JAX package's state across into the port.

The JAX package's pytrees (ScenePacket — path-traced or raster, the latter
built with ``spheres_as_triangles=True`` — Camera, AccumState, the
differentiable parameters) cross as numpy arrays — ``np.asarray`` on each
leaf — and its frozen configs (RenderConfig, RasterConfig) field by field,
so both packages render the same scene, from the same pose, onto the same
history, with the same settings, and differentiate the same parameters.
Nothing here imports jax or the JAX package: its objects are read by their
field names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ptre_tpu_torch.models.scene import PACKET_COUNTS, PACKET_LEAVES, ScenePacket
from ptre_tpu_torch.ops.camera import Camera
from ptre_tpu_torch.render.pathtracer import AccumState
from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig


def packet_from_numpy(arrays: Dict[str, np.ndarray], counts: Dict[str, int],
                      device=None) -> ScenePacket:
    """A ScenePacket from the reference packet's leaves by field name
    (``tri_v0`` … ``sky_top``) and its static counts (``num_triangles``,
    ``num_spheres``, ``num_drawcalls``, ``num_materials``)."""
    pkt = ScenePacket.from_numpy(arrays, **counts)
    return pkt if device is None else pkt.to(device)


def packet_from_reference(packet, device=None) -> ScenePacket:
    """A ScenePacket from any packet object with the reference's leaves and
    counts as attributes (the JAX package's ScenePacket, path-traced or
    raster): ``np.asarray`` of each leaf, ``int`` of each count."""
    return packet_from_numpy({k: np.asarray(getattr(packet, k)) for k in PACKET_LEAVES},
                             {k: int(getattr(packet, k)) for k in PACKET_COUNTS}, device)


def config_from_reference(config):
    """The port's RenderConfig or RasterConfig with the fields of the
    reference config of the same class name (the field sets are the same)."""
    cls = {"RenderConfig": RenderConfig, "RasterConfig": RasterConfig}[type(config).__name__]
    return cls(**{f.name: getattr(config, f.name) for f in dataclasses.fields(cls)})


def camera_from_numpy(position, forward, fov_degrees, znear, zfar, width: int,
                      height: int, projection: int) -> Camera:
    """A Camera from the reference camera's leaves and static fields."""
    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    return Camera(position=f32(position), forward=f32(forward),
                  fov_degrees=f32(fov_degrees), znear=f32(znear), zfar=f32(zfar),
                  width=int(width), height=int(height), projection=int(projection))


def accum_from_numpy(linear, frame, device=None) -> AccumState:
    """An AccumState from an (H, W, 3) linear buffer and the sample count."""
    lin = torch.from_numpy(np.array(linear, dtype=np.float32))
    return AccumState(linear=lin if device is None else lin.to(device),
                      frame=int(frame))


def params_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The port's parameter dict from the JAX ``differentiable_params``
    leaves (``np.asarray`` of each), as float32 tensors."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in arrays.items()}


def selections_from_jax(sel, tri_rows: int, n_rays: int = None) -> torch.Tensor:
    """JAX's float selection rows (tri index, sphere index, use_sph, hit &
    active per bounce) → the port's (B, R) int32 unified-table rows: ``tri``
    or ``tri_rows + sph`` where the bounce hit, else -1. Two layouts:

    * (B, 4, R), ray order: `megakernel.trace_fused_sel` and
      `wavefront.trace(record=True)`;
    * planar (4B, 8, L), ray r at (r // L, r % L), zero-padded past
      ``n_rays`` (required): `megakernel.trace_culled_sel` and the dense
      kernel's ``planar`` forms.

    The triangle index is a row of the order the forward swept (Morton-
    permuted where it returns a permutation)."""
    sel = np.asarray(sel)
    if sel.shape[1] == 8 and sel.shape[0] % 4 == 0:
        if n_rays is None:
            raise ValueError("the planar (4B, 8, L) layout needs n_rays")
        sel = sel.reshape(sel.shape[0] // 4, 4, -1)[:, :, :n_rays]
    elif sel.shape[1] != 4:
        raise ValueError(f"selections of shape {sel.shape}: expected (B, 4, R) or (4B, 8, L)")
    tri = sel[:, 0].astype(np.int64)
    sph = sel[:, 1].astype(np.int64) + tri_rows
    rows = np.where(sel[:, 2] > 0.5, sph, tri)
    return torch.from_numpy(np.where(sel[:, 3] > 0.5, rows, -1).astype(np.int32))
