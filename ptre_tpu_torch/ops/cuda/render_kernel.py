"""Whole-sample render kernel: wrapper, plain version, camera rows.

Port of `ptre_tpu/ops/pallas/render_kernel.py`. One progressive sample per
pixel in one launch: jittered closed-form camera ray, the dense bounce loop,
clamp + non-finite scrub, and the running average ``lin = c/n +
lin*(n-1)/n`` on the public (H, W, 3) accumulator, updated in place.

  * `sample_accum` is the wrapper: on CUDA tensors it launches the kernel of
    `csrc/render_kernel.cu` (and counts the launch in ``launches``); on CPU
    tensors it runs the plain version. Anything else raises.
  * `sample_accum_reference` is the plain PyTorch version, on any device.

Both take ``urand=None`` (Philox draws keyed by (seed, pixel, sample, draw),
identical on both sides — `ops/rng.py`) or an external (2 + 2*max_depth, H,
W) uniform tensor: rows 0-1 the pixel jitter plus 0.5, rows 2b+2 and 2b+3
bounce b's scatter pair (`render_kernel.py:275-277`).

Not carried over from the TPU kernel: the lane-width / ``H % 8`` gate (the
CUDA kernel masks the ragged edge), the planar (3, H, W) accumulator and
its two transposes, and the NaN-only scrub — this port scrubs ±inf too, as
`integrator.postprocess_sample` does (ROADMAP §C).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.ops.camera import PERSPECTIVE
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.integrator import postprocess_sample

#: kernel launches made by `sample_accum` in this process
launches = 0


def camera_rows(cam):
    """(24,) float32 ray rows over NDC (x, y): origin = x·A + y·B + C,
    direction ∝ x·DA + y·DB + DC, then 6 zeros (`render_kernel.py:224-260`).
    The closed form of the near/far unproject of `camera.get_rays`."""
    inv_view = vm.inverse(cam.view_matrix())
    rot = inv_view[:3, :3]  # row-vector: world = v @ rot + t
    t = inv_view[3, :3]
    proj = cam.projection_matrix()
    m00 = proj[0, 0]
    m11 = proj[1, 1]
    n = cam.znear
    zeros3 = torch.zeros(3, dtype=torch.float32, device=rot.device)
    if cam.projection == PERSPECTIVE:
        a = (n / m00) * rot[0]
        b = (n / m11) * rot[1]
        da = rot[0] / m00
        db = rot[1] / m11
    else:  # orthographic: parallel rays along view z
        a = rot[0] / m00
        b = rot[1] / m11
        da = zeros3
        db = zeros3
    c = n * rot[2] + t
    return torch.cat([a, b, c, da, db, rot[2], zeros3, zeros3]).to(torch.float32)


class RenderParams(ctypes.Structure):
    """Kernel arguments; field for field `ptre::RenderParams` (trace.cuh)."""

    _fields_ = [
        ("cam", ctypes.c_float * 18),
        ("t_min", ctypes.c_float), ("t_max", ctypes.c_float),
        ("det_eps", ctypes.c_float), ("shadow_eps", ctypes.c_float),
        ("pdf_eps", ctypes.c_float),
        ("inv_w", ctypes.c_float), ("inv_h", ctypes.c_float),
        ("inv_n", ctypes.c_float), ("w_old", ctypes.c_float),
        ("seed_lo", ctypes.c_uint32), ("seed_hi", ctypes.c_uint32),
        ("sample", ctypes.c_uint32),
        ("height", ctypes.c_int32), ("width", ctypes.c_int32),
        ("n_tri", ctypes.c_int32), ("n_sph", ctypes.c_int32),
        ("num_mats", ctypes.c_int32), ("max_depth", ctypes.c_int32),
        ("clamp", ctypes.c_int32), ("external_rng", ctypes.c_int32),
    ]


def _average_weights(n: int):
    """Float32 (1/n, (n-1)/n) of the running average, as the TPU kernel
    computes them (`render_kernel.py:172-173`)."""
    nf = np.float32(n)
    inv_n = np.float32(1.0) / nf
    return float(inv_n), float((nf - np.float32(1.0)) * inv_n)


def render_params(height: int, width: int, scene: mk.PackedScene, cam_rows,
                  n: int, config, seed: int = 0,
                  external_rng: bool = False) -> RenderParams:
    """The kernel arguments for one sample with running-average index n."""
    k = mk.TraceConsts.from_config(config)
    inv_n, w_old = _average_weights(n)
    p = RenderParams()
    p.cam[:] = cam_rows.tolist()[:18]
    p.t_min, p.t_max, p.det_eps = k.t_min, k.t_max, k.det_eps
    p.shadow_eps, p.pdf_eps = k.shadow_eps, k.pdf_eps
    p.inv_w, p.inv_h = mk.f32(1.0 / width), mk.f32(1.0 / height)
    p.inv_n, p.w_old = inv_n, w_old
    p.seed_lo, p.seed_hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    p.sample = n & 0xFFFFFFFF
    p.height, p.width = height, width
    p.n_tri, p.n_sph, p.num_mats = scene.n_tri, scene.n_sph, scene.num_mats
    p.max_depth = config.max_depth
    p.clamp = int(config.clamp_samples)
    p.external_rng = int(external_rng)
    return p


def sample_accum_reference(accum, scene: mk.PackedScene, cam_rows, n: int,
                           config, seed: int = 0, urand=None):
    """Plain PyTorch version of the kernel: returns the updated (H, W, 3)
    accumulator as a new tensor (``accum`` is not modified)."""
    H, W = accum.shape[:2]
    dev = accum.device
    if urand is None:
        urand = rng.render_uniforms(seed, n, H, W, config.max_depth, device=dev)
    c = cam_rows.tolist()
    sx = mk.f32(2.0 * mk.f32(1.0 / W))
    sy = mk.f32(2.0 * mk.f32(1.0 / H))

    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    x_ndc = (px + (urand[0] - 0.5)) * sx - 1.0
    y_ndc = 1.0 - (py + (urand[1] - 0.5)) * sy
    o = tuple(x_ndc * c[i] + y_ndc * c[i + 3] + c[i + 6] for i in range(3))
    dx, dy, dz = (x_ndc * c[i + 9] + y_ndc * c[i + 12] + c[i + 15]
                  for i in range(3))
    dlen = torch.sqrt(dx * dx + dy * dy + dz * dz)
    pos = dlen > 0.0
    dinv = torch.where(pos, 1.0 / torch.where(pos, dlen, 1.0), 0.0)
    d = (dx * dinv, dy * dinv, dz * dinv)

    col = mk.trace_block(
        o, d, scene, mk.TraceConsts.from_config(config),
        lambda b: (urand[2 + 2 * b], urand[3 + 2 * b]), config.max_depth)
    col = postprocess_sample(torch.stack(col, dim=-1), config.clamp_samples)
    inv_n, w_old = _average_weights(n)
    return col * inv_n + accum * w_old


def _check_cuda_inputs(accum, scene, urand, max_depth):
    H, W = accum.shape[:2]
    expected = [("accum", accum, (H, W, 3), torch.float32)]
    if urand is not None:
        expected.append(("urand", urand, (2 + 2 * max_depth, H, W), torch.float32))
    mk.check_tensors("accum", accum.device, expected)
    mk.check_scene(scene, "accum", accum.device)


def sample_accum(accum, scene: mk.PackedScene, cam_rows, n: int, config,
                 seed: int = 0, urand=None):
    """One progressive sample into ``accum`` (H, W, 3) in place; returns it.

    CUDA tensors launch the hand-written kernel; CPU tensors run
    `sample_accum_reference`. ``n`` is this sample's 1-based running-average
    index; ``seed`` keys the in-kernel Philox when ``urand`` is None.
    """
    global launches
    if accum.device.type == "cpu":
        accum.copy_(sample_accum_reference(accum, scene, cam_rows, n, config,
                                           seed, urand))
        return accum
    if accum.device.type != "cuda":
        raise RendererError(f"sample_accum runs on cuda or cpu, not {accum.device}")
    _check_cuda_inputs(accum, scene, urand, config.max_depth)
    H, W = accum.shape[:2]
    params = render_params(H, W, scene, cam_rows, n, config, seed,
                           external_rng=urand is not None)
    lib = build.load_library()
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream(accum.device).cuda_stream
        rc = lib.ptre_render_sample(
            ctypes.addressof(params), accum.data_ptr(),
            None if urand is None else urand.data_ptr(),
            scene.tris.data_ptr(), scene.sphs.data_ptr(),
            scene.mats.data_ptr(), scene.sky.data_ptr(), stream)
    if rc != 0:
        raise RendererError(
            f"render kernel launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    launches += 1
    return accum
