"""Carry the JAX package's state across into the port.

The JAX package's pytrees (ScenePacket, Camera, AccumState) cross as numpy
arrays — ``np.asarray`` on each leaf — so both packages render the same
scene, from the same pose, onto the same history. Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ptre_tpu_torch.models.scene import ScenePacket
from ptre_tpu_torch.ops.camera import Camera
from ptre_tpu_torch.render.pathtracer import AccumState


def packet_from_numpy(arrays: Dict[str, np.ndarray], counts: Dict[str, int],
                      device=None) -> ScenePacket:
    """A ScenePacket from the reference packet's leaves by field name
    (``tri_v0`` … ``sky_top``) and its static counts (``num_triangles``,
    ``num_spheres``, ``num_drawcalls``, ``num_materials``)."""
    pkt = ScenePacket.from_numpy(arrays, **counts)
    return pkt if device is None else pkt.to(device)


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
