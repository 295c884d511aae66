"""Vector / matrix math core (row-vector, HLSL/D3D conventions).

PyTorch port of `ptre_tpu/ops/vecmat.py`, reduced to what the progressive
path tracer uses. Conventions are the reference's, unchanged:

  * 4x4 matrices act on ROW vectors (``v @ M``); translation lives in row 3.
  * Projections are D3D-style left-handed with clip z in [0, 1].
  * ``look_at`` does NOT orthonormalize right/up (`matrix.cu:315-324`).
  * A singular 4x4 (|det| < 1e-5) inverts to an INFINITY-filled matrix.

All functions take float32 tensors and broadcast over leading batch dims.
"""

from __future__ import annotations

import math

import torch

pi = math.pi
tau = 2.0 * math.pi


def to_radians(degrees):
    return torch.as_tensor(degrees, dtype=torch.float32) * (pi / 180.0)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def normalize(v, eps: float = 0.0):
    """Zero-safe normalize: zero vectors stay zero (`vector.h:239-244`)."""
    len_sq = torch.sum(v * v, dim=-1, keepdim=True)
    safe = torch.where(len_sq > 0, len_sq, torch.ones_like(len_sq))
    inv = torch.where(len_sq > eps, 1.0 / torch.sqrt(safe), torch.zeros_like(len_sq))
    return v * inv


def look_at(eye, focus):
    """Left-handed view matrix, faithfully non-orthonormalized
    (`matrix.cu:315-324`)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    focus = torch.as_tensor(focus, dtype=torch.float32)
    forward = normalize(focus - eye)
    aux = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=forward.device)
    right = torch.linalg.cross(aux.expand_as(forward), forward)
    up = torch.linalg.cross(forward, right)
    m = torch.zeros(forward.shape[:-1] + (4, 4), dtype=torch.float32,
                    device=forward.device)
    m[..., :3, 0] = right
    m[..., :3, 1] = up
    m[..., :3, 2] = forward
    m[..., 3, 0] = -dot(right, eye)
    m[..., 3, 1] = -dot(up, eye)
    m[..., 3, 2] = -dot(forward, eye)
    m[..., 3, 3] = 1.0
    return m


def _bad_planes(znear, zfar):
    return (znear < 0.0) | (zfar < 0.0) | (torch.abs(znear - zfar) < 1e-5)


def perspective(aspect_ratio, fovh, znear, zfar):
    """D3D LH perspective, clip z in [0, 1] (`matrix.cu:342-357`). ``fovh`` is
    the vertical fov in radians; degenerate planes give an INFINITY matrix."""
    aspect_ratio = torch.as_tensor(aspect_ratio, dtype=torch.float32)
    fovh = torch.as_tensor(fovh, dtype=torch.float32)
    znear = torch.as_tensor(znear, dtype=torch.float32)
    zfar = torch.as_tensor(zfar, dtype=torch.float32)
    y_scale = 1.0 / torch.tan(fovh * 0.5)
    x_scale = y_scale / aspect_ratio
    m = torch.zeros((4, 4), dtype=torch.float32, device=fovh.device)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = zfar / (zfar - znear)
    m[2, 3] = 1.0
    m[3, 2] = -znear * zfar / (zfar - znear)
    return torch.where(_bad_planes(znear, zfar), torch.full_like(m, math.inf), m)


def orthographic(aspect_ratio, znear, zfar):
    """D3D orthographic, 2 world units tall (`matrix.cu:325-341`)."""
    aspect_ratio = torch.as_tensor(aspect_ratio, dtype=torch.float32)
    znear = torch.as_tensor(znear, dtype=torch.float32)
    zfar = torch.as_tensor(zfar, dtype=torch.float32)
    height = 2.0
    width = aspect_ratio * height
    m = torch.zeros((4, 4), dtype=torch.float32, device=znear.device)
    m[0, 0] = 2.0 / width
    m[1, 1] = 2.0 / height
    m[2, 2] = 1.0 / (zfar - znear)
    m[3, 3] = 1.0
    m[3, 2] = znear / (znear - zfar)
    return torch.where(_bad_planes(znear, zfar), torch.full_like(m, math.inf), m)


def inverse(m):
    """4x4 inverse; |det| < 1e-5 returns an INFINITY-filled matrix
    (`matrix.cu:141-145`). The singular input is swapped for identity before
    inverting so the unselected branch never raises or makes NaNs."""
    det = torch.linalg.det(m)
    bad = (torch.abs(det) < 1e-5)[..., None, None]
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand_as(m)
    inv = torch.linalg.inv(torch.where(bad, eye, m))
    return torch.where(bad, torch.full_like(m, math.inf), inv)


def transform_points(p, m):
    """(..., 3) points by (..., 4, 4) with w = 1, no w-divide."""
    return p @ m[..., :3, :3] + m[..., 3, :3]


def transform_points_h(p, m):
    """Homogeneous transform of (..., 3) points → (xyz, w), no divide."""
    xyz = p @ m[..., :3, :3] + m[..., 3, :3]
    w = p @ m[..., :3, 3:4] + m[..., 3, 3:4]
    return xyz, w[..., 0]


def normal_matrix(m):
    """3x3 normal matrix ``inv(M3x3).T``, applied as row-vector ``n @ N``.
    A truly singular input gives LAPACK's inf/nan garbage, as in the
    reference, instead of raising."""
    return torch.linalg.inv_ex(m[..., :3, :3]).inverse.transpose(-1, -2)
