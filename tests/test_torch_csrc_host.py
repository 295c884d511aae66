"""The CUDA kernel's math, checked on the CPU.

`csrc/trace.cuh` and `csrc/philox.cuh` are written ``__host__ __device__``
behind a macro, so `csrc/host_render.cpp` compiles the kernel's per-pixel
body with g++. Run over a 32x16 image it must agree with the plain PyTorch
version (`sample_accum_reference`), in external-uniform and in Philox mode.

Tolerance 1e-5: g++ on x86-64 without -mfma does not contract a*b+c, so the
arithmetic is the plain version's; only cos/sin come from other libraries
(libm vs PyTorch's vectorised kernels), a few ulp apart. Philox bits are
integers and must be equal, which the Philox-mode case checks end to end.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ptre_tpu.utils.config import RenderConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models.scene import Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk

W, H = 32, 16


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no C++ compiler (g++) to build csrc/host_render.cpp")
    out = str(tmp_path_factory.mktemp("host") / "libptre_host.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-o", out,
                    os.path.join(build.CSRC_DIR, "host_render.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.ptre_render_sample_host.restype = None
    lib.ptre_render_sample_host.argtypes = [ctypes.c_void_p] * 7
    return lib


def _host_sample(lib, prev, scene, rows, n, cfg, seed, urand):
    out = prev.clone()
    params = rk.render_params(H, W, scene, rows, n, cfg, seed,
                              external_rng=urand is not None)
    lib.ptre_render_sample_host(
        ctypes.addressof(params), out.data_ptr(),
        None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
        scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr())
    return out


CASES = {
    "demo": (lambda: demo.reference_demo_scene(8, 4), {}, {}),
    "demo_ortho_unclamped": (lambda: demo.reference_demo_scene(8, 4),
                             dict(projection=cam_ops.ORTHOGRAPHIC),
                             dict(clamp_samples=False)),
    "cornell": (demo.cornell_spheres_scene,
                dict(position=(0.0, 1.5, -6.0), forward=(0.0, -0.2, 6.0)), {}),
    "config3_flat_dense": (lambda: demo.config3_scene(flat=True, segments=6,
                                                      rings=3, diffuse=True), {}, {}),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("external", [True, False])
def test_host_build_matches_plain_version(host_lib, name, external):
    torch.set_num_threads(1)
    build_scene, cam_kw, cfg_kw = CASES[name]
    pkt = build_scene().build_packet()
    assert mk.dense_supported(pkt)
    cfg = RenderConfig(width=W, height=H, **cfg_kw)
    scene = mk.pack_scene(pkt)
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H, **cam_kw))
    rs = np.random.default_rng(len(name))
    prev = torch.from_numpy(rs.random((H, W, 3), dtype=np.float32))
    urand = (torch.from_numpy(rs.random((2 + 2 * cfg.max_depth, H, W), dtype=np.float32))
             if external else None)
    got = _host_sample(host_lib, prev, scene, rows, 3, cfg, 0xBEEF, urand)
    want = rk.sample_accum_reference(prev, scene, rows, 3, cfg, 0xBEEF, urand)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, prev)


def test_host_build_empty_scene_is_pure_sky(host_lib):
    # no geometry: every pixel is the sky gradient of its primary ray. Ray
    # generation and the sky are the same float32 operations on both sides,
    # but PyTorch's CPU sqrt is not always correctly rounded (measured: one
    # ulp off libm's for some ray lengths), so allow 2 ulp of values <= 1
    cfg = RenderConfig(width=W, height=H)
    scene = mk.pack_scene(Scene().build_packet())
    assert scene.n_tri == 1 and float(scene.tris[0, 18]) == 0.0  # one invalid row
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H))
    zero = torch.zeros((H, W, 3))
    got = _host_sample(host_lib, zero, scene, rows, 1, cfg, 3, None)
    want = rk.sample_accum_reference(zero, scene, rows, 1, cfg, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2.4e-7)
    assert (got == want).float().mean() > 0.99
    # the top row looks up into the sky: bluer than the bottom row
    assert float(got[0, :, 0].mean()) < float(got[-1, :, 0].mean())
