"""Vector / matrix math core (row-vector, HLSL/D3D conventions).

PyTorch port of `ptre_tpu/ops/vecmat.py`: every helper of the reference,
as plain functions on tensors. Conventions are the reference's, unchanged:

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

#: epsilon used by `is_zero` (reference `iqmath.h:29-31`)
IS_ZERO_EPS = 1e-6


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def to_radians(degrees):
    return _f32(degrees) * (pi / 180.0)


def to_degrees(radians):
    return _f32(radians) * (180.0 / pi)


def is_zero(x, eps: float = IS_ZERO_EPS):
    """|x| < eps predicate (reference `iqmath.h:29-31`)."""
    return torch.abs(torch.as_tensor(x)) < eps


def vec3(x, y, z, dtype=torch.float32):
    return torch.stack([torch.as_tensor(c, dtype=dtype) for c in (x, y, z)], dim=-1)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def length_sq(v):
    return torch.sum(v * v, dim=-1)


def length(v):
    return torch.sqrt(length_sq(v))


def hadamard(a, b):
    """Component-wise product (reference `vector.h:107-109`)."""
    return a * b


def dot3(a, b):
    """Dot over a trailing axis of 3, summed left to right as the kernels
    sum it: a.x*b.x + a.y*b.y + a.z*b.z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    """3D cross product in ``jnp.cross``'s operation order (`vector.h:219-224`)."""
    a0, a1, a2 = a.unbind(dim=-1)
    b0, b1, b2 = b.unbind(dim=-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def normalize(v, eps: float = 0.0):
    """Zero-safe normalize: zero vectors stay zero (`vector.h:239-244`)."""
    len_sq = torch.sum(v * v, dim=-1, keepdim=True)
    safe = torch.where(len_sq > 0, len_sq, torch.ones_like(len_sq))
    inv = torch.where(len_sq > eps, 1.0 / torch.sqrt(safe), torch.zeros_like(len_sq))
    return v * inv


def angle(a, b):
    """Angle between vectors in radians (reference `vector.h` angle3)."""
    lab = length(a) * length(b)
    denom = torch.where(lab > 0, lab, torch.ones_like(lab))
    return torch.arccos(torch.clamp(dot(a, b) / denom, -1.0, 1.0))


def clamp_length(v, max_len):
    """Clamp a vector's length (reference `vector.h` clamp_length)."""
    ln = length(v)[..., None]
    safe = torch.where(ln > 0, ln, torch.ones_like(ln))
    return v * torch.where(ln > max_len, max_len / safe, torch.ones_like(ln))


def _trailing(x):
    return tuple(range(-min(x.dim(), 2), 0))


def is_nan(x):
    """Any-NaN predicate over the trailing (up to two) dims (reference
    `vector.h:236-238`, `matrix.cu:307-313`)."""
    x = torch.as_tensor(x)
    return torch.isnan(x).any(dim=_trailing(x)) if x.dim() else torch.isnan(x)


def is_inf(x):
    """Any-inf predicate (reference `matrix.cu:292-305`)."""
    x = torch.as_tensor(x)
    return torch.isinf(x).any(dim=_trailing(x)) if x.dim() else torch.isinf(x)


def reflect(v, n):
    """Reflect v about normal n (reference `vector.h` reflect)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, eta):
    """Refract with the total-internal-reflection fallback to `reflect`
    (reference `vector.h:260-269`); ``eta`` is n1/n2."""
    cos_i = -dot(v, n)
    disc = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    s = eta * cos_i - torch.sqrt(torch.clamp(disc, min=0.0))
    refracted = eta * v + s[..., None] * n
    return torch.where((disc < 0.0)[..., None], reflect(v, n), refracted)


_SWIZZLE_IDX = {"x": 0, "y": 1, "z": 2, "w": 3}


def swizzle(v, permutation: str):
    """String swizzle, e.g. ``swizzle(v, "zyx")`` (reference `vector.h:351-368`)."""
    return torch.stack([v[..., _SWIZZLE_IDX[c]] for c in permutation], dim=-1)


def identity(dtype=torch.float32):
    return torch.eye(4, dtype=dtype)


def _eye(batch, device):
    return torch.eye(4, dtype=torch.float32, device=device).expand(
        tuple(batch) + (4, 4)).clone()


def scale(factor):
    """Scale matrix of a scalar or (..., 3) factor (reference `matrix.cu:359-365`)."""
    factor = _f32(factor)
    if factor.dim() == 0:
        factor = factor.expand(3)
    m = _eye(factor.shape[:-1], factor.device)
    for i in range(3):
        m[..., i, i] = factor[..., i]
    return m


def translate(offset):
    """Translation in row 3 (row-vector convention, `matrix.cu:367-373`)."""
    offset = _f32(offset)
    m = _eye(offset.shape[:-1], offset.device)
    m[..., 3, :3] = offset[..., :3]
    return m


def _rotation(angle, i, j):
    """Rotation in the (i, j) plane: m[i,i] = m[j,j] = c, m[i,j] = s,
    m[j,i] = -s, as `matrix.cu:375-409` writes each elementary rotation."""
    angle = _f32(angle)
    s, c = torch.sin(angle), torch.cos(angle)
    m = _eye(angle.shape, angle.device)
    m[..., i, i], m[..., i, j], m[..., j, i], m[..., j, j] = c, s, -s, c
    return m


def rotation_x(angle):
    """Rotation about x (reference `matrix.cu:375-385`)."""
    return _rotation(angle, 1, 2)


def rotation_y(angle):
    """Rotation about y (reference `matrix.cu:387-397`)."""
    return _rotation(angle, 2, 0)


def rotation_z(angle):
    """Rotation about z (reference `matrix.cu:399-409`)."""
    return _rotation(angle, 0, 1)


def rotation_axis(angle, axis):
    """Axis-angle rotation (reference `matrix.cu:411-428`). Axis assumed unit."""
    angle, axis = _f32(angle), _f32(axis)
    s, c = torch.sin(angle), torch.cos(angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    omc = 1.0 - c
    m = _eye(angle.shape, angle.device)
    m[..., 0, 0] = c + x * x * omc
    m[..., 0, 1] = y * x * omc + z * s
    m[..., 0, 2] = z * x * omc - y * s
    m[..., 1, 0] = x * y * omc - z * s
    m[..., 1, 1] = c + y * y * omc
    m[..., 1, 2] = z * y * omc + x * s
    m[..., 2, 0] = x * z * omc + y * s
    m[..., 2, 1] = y * z * omc - x * s
    m[..., 2, 2] = c + z * z * omc
    return m


def compose_trs(scale_v, rotation_euler, translation):
    """Model transform ``S @ Rx @ Ry @ Rz @ T`` (reference `model.cu:11-18`)."""
    rotation_euler = _f32(rotation_euler)
    r = (rotation_x(rotation_euler[..., 0]) @ rotation_y(rotation_euler[..., 1])
         @ rotation_z(rotation_euler[..., 2]))
    return scale(scale_v) @ r @ translate(translation)


def look_at(eye, focus):
    """Left-handed view matrix, faithfully non-orthonormalized
    (`matrix.cu:315-324`)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    focus = torch.as_tensor(focus, dtype=torch.float32)
    forward = normalize(focus - eye)
    aux = torch.zeros_like(forward)
    aux[..., 1].fill_(1.0)  # filled where forward lives: no host-made copy
    right = torch.linalg.cross(aux, forward)
    up = torch.linalg.cross(forward, right)
    m = torch.zeros(forward.shape[:-1] + (4, 4), dtype=torch.float32,
                    device=forward.device)
    m[..., :3, 0] = right
    m[..., :3, 1] = up
    m[..., :3, 2] = forward
    m[..., 3, 0] = -dot(right, eye)
    m[..., 3, 1] = -dot(up, eye)
    m[..., 3, 2] = -dot(forward, eye)
    m[..., 3, 3].fill_(1.0)  # a Python value set by index is a host copy on CUDA
    return m


def _on(x, ref):
    """``x`` as a float32 tensor: a tensor where it lies, a Python number
    filled on ``ref``'s device (no host copy; and on CUDA a division by a
    host scalar would be a product with its reciprocal, not the division)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=ref.device)


def _bad_planes(znear, zfar):
    return (znear < 0.0) | (zfar < 0.0) | (torch.abs(znear - zfar) < 1e-5)


def perspective(aspect_ratio, fovh, znear, zfar):
    """D3D LH perspective, clip z in [0, 1] (`matrix.cu:342-357`). ``fovh`` is
    the vertical fov in radians; degenerate planes give an INFINITY matrix."""
    fovh = torch.as_tensor(fovh, dtype=torch.float32)
    aspect_ratio, znear, zfar = (_on(x, fovh) for x in (aspect_ratio, znear, zfar))
    y_scale = 1.0 / torch.tan(fovh * 0.5)
    x_scale = y_scale / aspect_ratio
    m = torch.zeros((4, 4), dtype=torch.float32, device=fovh.device)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = zfar / (zfar - znear)
    m[2, 3].fill_(1.0)
    m[3, 2] = -znear * zfar / (zfar - znear)
    return torch.where(_bad_planes(znear, zfar), torch.full_like(m, math.inf), m)


def orthographic(aspect_ratio, znear, zfar):
    """D3D orthographic, 2 world units tall (`matrix.cu:325-341`)."""
    znear = torch.as_tensor(znear, dtype=torch.float32)
    aspect_ratio, zfar = (_on(x, znear) for x in (aspect_ratio, zfar))
    height = 2.0
    width = aspect_ratio * height
    m = torch.zeros((4, 4), dtype=torch.float32, device=znear.device)
    m[0, 0] = 2.0 / width
    m[1, 1].fill_(2.0 / height)
    m[2, 2] = 1.0 / (zfar - znear)
    m[3, 3].fill_(1.0)
    m[3, 2] = znear / (znear - zfar)
    return torch.where(_bad_planes(znear, zfar), torch.full_like(m, math.inf), m)


def inverse(m):
    """4x4 inverse; |det| < 1e-5 returns an INFINITY-filled matrix
    (`matrix.cu:141-145`). The singular input is swapped for identity before
    inverting so the unselected branch never raises or makes NaNs; so
    ``inv_ex`` checks nothing, and on CUDA no read of its ``info`` stalls the
    host (``linalg.inv`` reads it)."""
    det = torch.linalg.det(m)
    bad = (torch.abs(det) < 1e-5)[..., None, None]
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand_as(m)
    inv = torch.linalg.inv_ex(torch.where(bad, eye, m)).inverse
    return torch.where(bad, torch.full_like(m, math.inf), inv)


def determinant(m):
    return torch.linalg.det(m)


def transform_points(p, m):
    """(..., 3) points by (..., 4, 4) with w = 1, no w-divide."""
    return p @ m[..., :3, :3] + m[..., 3, :3]


def transform_points_h(p, m):
    """Homogeneous transform of (..., 3) points → (xyz, w), no divide."""
    xyz = p @ m[..., :3, :3] + m[..., 3, :3]
    w = p @ m[..., :3, 3:4] + m[..., 3, 3:4]
    return xyz, w[..., 0]


def project_points(p, m):
    """Homogeneous transform + w-divide (the rasterizer's clip → NDC step):
    returns (xyz / w, w)."""
    xyz, w = transform_points_h(p, m)
    return xyz / w[..., None], w


def normal_matrix(m):
    """3x3 normal matrix ``inv(M3x3).T``, applied as row-vector ``n @ N``.
    A truly singular input gives LAPACK's inf/nan garbage, as in the
    reference, instead of raising."""
    return torch.linalg.inv_ex(m[..., :3, :3]).inverse.transpose(-1, -2)


def transform_dirs(d, m):
    """(..., 3) directions by (..., 4, 4) with w = 0."""
    return d @ m[..., :3, :3]


def transform_normals(n, m):
    """(..., 3) normals by the 4x4 model matrix's normal matrix."""
    return n @ normal_matrix(m)
