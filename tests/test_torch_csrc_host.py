"""The CUDA kernels' math, checked on the CPU.

`csrc/trace.cuh`, `csrc/wave.cuh` and `csrc/philox.cuh` are written
``__host__ __device__`` behind a macro, so `csrc/host_render.cpp` compiles the
render kernel's per-pixel body with g++, and `csrc/host_wave.cpp` the mask and
bounce kernels' per-ray bodies. Run over a 32x16 image the render body must
agree with the plain PyTorch version (`sample_accum_reference`), in
external-uniform and in Philox mode; the wavefront bodies with
`wave_mask_reference` (equal verdicts) and `wave_bounce_reference`.

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
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.render import pathtracer as pt

W, H = 32, 16


def _build_host(tmp_path_factory, source):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail(f"no C++ compiler (g++) to build csrc/{source}")
    out = str(tmp_path_factory.mktemp("host") / "libptre_host.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-o", out, os.path.join(build.CSRC_DIR, source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _build_host(tmp_path_factory, "host_render.cpp")
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


# ---- the wavefront kernels' per-ray bodies (csrc/wave.cuh) -------------------


@pytest.fixture(scope="module")
def wave_lib(tmp_path_factory):
    lib = _build_host(tmp_path_factory, "host_wave.cpp")
    ptr = ctypes.c_void_p
    lib.ptre_wave_mask_host.restype = None
    lib.ptre_wave_mask_host.argtypes = [ptr] * 4 + [ctypes.c_int]
    lib.ptre_wave_bounce_host.restype = None
    lib.ptre_wave_bounce_host.argtypes = [ptr] * 11 + [ctypes.c_int]
    return lib


WAVE_CASES = {
    "config4": (lambda: demo.config4_mixed_scene(24, 12), {}),
    "config3_flat_ortho": (lambda: demo.config3_scene(flat=True, segments=24, rings=12,
                                                      diffuse=True),
                           dict(projection=cam_ops.ORTHOGRAPHIC)),
}


@pytest.mark.parametrize("name", list(WAVE_CASES))
@pytest.mark.parametrize("external", [True, False])
def test_host_wave_build_matches_plain_versions(wave_lib, name, external):
    """Two bounces (the second on the sorted next state), 64-ray blocks.
    Tolerance: g++ does not contract FMAs, so the arithmetic is the plain
    version's but for libm's cos/sin and PyTorch's vectorised sqrt (an ulp
    apart); a ray leaving the r = 10 ground sphere turns an ulp into ~1e-5
    (see test_torch_wavefront._assert_state_close): >= 99 % of the values
    within 1e-6, all within 1e-4; dead rays bit for bit."""
    torch.set_num_threads(1)
    build_scene, cam_kw = WAVE_CASES[name]
    lanes, B = 64, 3
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    k = mk.TraceConsts.from_config(cfg)
    scene = wf.prepare_scene(build_scene().build_packet())
    cam = cam_ops.Camera.create(width=W, height=H, **cam_kw)
    px, py = pt.pixel_grid(H, W)
    rs = np.random.default_rng(len(name))
    jit = torch.from_numpy(rs.uniform(-0.5, 0.5, (W * H, 2)).astype(np.float32))
    o, d = cam_ops.get_rays(cam, px, py, jit)
    state, ids = wf.initial_state(o, d, lanes)
    state[9, ::9] = 0.0  # some dead rays
    urand = (torch.from_numpy(rs.random((2 + 2 * B, W * H), dtype=np.float32))
             if external else None)
    for b in range(2):
        mask = torch.empty((state.shape[1] // lanes, scene.n_leaf), dtype=torch.uint8)
        mp = wf.MaskParams(t_min=k.t_min, r_pad=state.shape[1], n_leaf=scene.n_leaf)
        wave_lib.ptre_wave_mask_host(ctypes.addressof(mp), state.data_ptr(),
                                     scene.boxes.data_ptr(), mask.data_ptr(), lanes)
        want_mask = wf.wave_mask_reference(state, scene.boxes, k.t_min, lanes)
        np.testing.assert_array_equal(mask.bool().numpy(), want_mask.numpy())
        short, cnt = wf.shortlists_from_mask(want_mask)
        got = torch.empty_like(state)
        p = wf.WaveParams(
            t_min=k.t_min, t_max=k.t_max, det_eps=k.det_eps, shadow_eps=k.shadow_eps,
            pdf_eps=k.pdf_eps, seed_lo=0xBEEF, seed_hi=0, sample=5,
            n_rays=0 if urand is None else urand.shape[1], r_pad=state.shape[1],
            n_leaf=scene.n_leaf, list_stride=short.shape[1], n_sph=scene.n_sph,
            num_mats=scene.num_mats, bounce=b, external_rng=int(external))
        wave_lib.ptre_wave_bounce_host(
            ctypes.addressof(p), state.data_ptr(), ids.data_ptr(), short.data_ptr(),
            cnt.data_ptr(), scene.tris.data_ptr(), scene.sphs.data_ptr(),
            scene.mats.data_ptr(), scene.sky.data_ptr(),
            None if urand is None else urand.data_ptr(), got.data_ptr(), lanes)
        want = wf.wave_bounce_reference(state, ids, short, cnt, scene, k, b, 0xBEEF, 5,
                                        urand, lanes)
        err = (got - want).abs()
        assert float((err <= 1e-6).float().mean()) >= 0.99, (b, float(err.max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
        dead = state[9] < 0.5
        assert torch.equal(got[:, dead], state[:, dead])
        assert int((want[9] > 0.5).sum()) > 0 and not torch.equal(want, state)
        perm = torch.argsort(wf.coherence_key(want, scene.scene_lo, scene.scene_hi),
                             stable=True)
        state, ids = want[:, perm].contiguous(), ids[perm].contiguous()
