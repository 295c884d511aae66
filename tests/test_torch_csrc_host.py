"""The CUDA kernels' math, checked on the CPU.

`csrc/trace.cuh`, `csrc/wave.cuh`, `csrc/raster.cuh` and `csrc/philox.cuh`
are written ``__host__ __device__`` behind a macro, so `csrc/host_render.cpp`
compiles the render kernel's per-pixel body with g++, `csrc/host_wave.cpp`
the mask and bounce kernels' per-ray bodies, and `csrc/host_raster.cpp` the
rasterizer kernels' per-sample bodies and the SoftRas adjoint. Run over a
32x16 image the render body must agree with the plain PyTorch version
(`sample_accum_reference`), in external-uniform and in Philox mode; the
wavefront bodies with `wave_mask_reference` (equal verdicts) and
`wave_bounce_reference`; the raster bodies with the raster plain versions,
and the adjoint with torch float64 autograd (1e-10, each test states its
own tolerance).

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
    lib.ptre_render_sample_host.argtypes = [ctypes.c_void_p] * 9
    return lib


def _host_sample(lib, prev, scene, rows, n, cfg, seed, urand):
    out = prev.clone()
    params = rk.render_params(H, W, scene, rows, n, cfg, seed,
                              external_rng=urand is not None)
    lib.ptre_render_sample_host(
        ctypes.addressof(params), out.data_ptr(),
        None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
        scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr(), None, None)
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
    pkt = build_scene().build_packet(device="cpu")
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
    scene = mk.pack_scene(Scene().build_packet(device="cpu"))
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
    lib.ptre_wave_bounce_host.argtypes = [ptr] * 14 + [ctypes.c_int]
    lib.ptre_trace_culled_host.restype = None
    lib.ptre_trace_culled_host.argtypes = [ptr] * 14
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
    within 1e-6, all within 1e-4; dead rays bit for bit. The recording
    finish writes the plain version's winners (integers: equal, but for a
    ray whose state is beyond 1e-6, which may sit on a tie) and touches no
    other bounce's row."""
    torch.set_num_threads(1)
    build_scene, cam_kw = WAVE_CASES[name]
    lanes, B = 64, 3
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    k = mk.TraceConsts.from_config(cfg)
    scene = wf.prepare_scene(build_scene().build_packet(device="cpu"))
    cam = cam_ops.Camera.create(width=W, height=H, **cam_kw)
    px, py = pt.pixel_grid(H, W)
    rs = np.random.default_rng(len(name))
    jit = torch.from_numpy(rs.uniform(-0.5, 0.5, (W * H, 2)).astype(np.float32))
    o, d = cam_ops.get_rays(cam, px, py, jit)
    state, ids = wf.initial_state(o, d, lanes)
    state[9, ::9] = 0.0  # some dead rays
    urand = (torch.from_numpy(rs.random((2 + 2 * B, W * H), dtype=np.float32))
             if external else None)
    sel = torch.full((B, W * H), -1, dtype=torch.int32)
    want_sel = sel.clone()
    for b in range(2):
        mask = torch.empty((state.shape[1] // lanes, scene.n_leaf), dtype=torch.uint8)
        mp = wf.MaskParams(t_min=k.t_min, r_pad=state.shape[1], n_leaf=scene.n_leaf)
        wave_lib.ptre_wave_mask_host(ctypes.addressof(mp), state.data_ptr(),
                                     scene.boxes.data_ptr(), mask.data_ptr(), lanes)
        want_mask = wf.wave_mask_reference(state, scene.boxes, k.t_min, lanes)
        np.testing.assert_array_equal(mask.bool().numpy(), want_mask.numpy())
        short, cnt = wf.shortlists_from_mask(want_mask)
        got = torch.empty_like(state)
        p = mk.wave_params(
            k, 0xBEEF, 5, scene, n_rays=0 if urand is None else urand.shape[1],
            r_pad=state.shape[1], list_stride=short.shape[1], bounce=b,
            external_rng=int(external), n_sel=sel.shape[1])
        plain_state = torch.empty_like(state)
        for out, rec in ((got, sel), (plain_state, None)):
            wave_lib.ptre_wave_bounce_host(
                ctypes.addressof(p), state.data_ptr(), ids.data_ptr(), short.data_ptr(),
                cnt.data_ptr(), scene.tris.data_ptr(), scene.rows.data_ptr(),
                scene.cull_boxes.data_ptr(), scene.sphs.data_ptr(),
                scene.mats.data_ptr(), scene.sky.data_ptr(),
                None if urand is None else urand.data_ptr(), out.data_ptr(),
                None if rec is None else rec.data_ptr(), lanes)
        assert torch.equal(got, plain_state)  # recording changes no state
        want = wf.wave_bounce_reference(state, ids, short, cnt, scene, k, b, 0xBEEF, 5,
                                        urand, lanes, sel=want_sel)
        err = (got - want).abs()
        loose = ids[(err > 1e-6).any(dim=0)].long()
        same = sel == want_sel
        same[:, loose] = True
        assert bool(same.all()) and bool((sel[b + 1:] == -1).all())
        assert int((sel[b] >= scene.tri_rows).sum()) > 0
        assert int(((sel[b] >= 0) & (sel[b] < scene.tri_rows)).sum()) > 0
        assert float((err <= 1e-6).float().mean()) >= 0.99, (b, float(err.max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
        dead = state[9] < 0.5
        assert torch.equal(got[:, dead], state[:, dead])
        assert int((want[9] > 0.5).sum()) > 0 and not torch.equal(want, state)
        perm = torch.argsort(wf.coherence_key(want, scene.scene_lo, scene.scene_hi),
                             stable=True)
        state, ids = want[:, perm].contiguous(), ids[perm].contiguous()


def _adversarial_mask_state(boxes, rs, lanes, t_min):
    """(state, boxes) for the mask: ``boxes`` padded with empty leaves to
    whole supertiles, then a supertile of eight boxes set apart along x (one
    of zero thickness, one a point), then a ragged last supertile of one
    such box and empty (padding) leaves; rays through every kind of trouble
    — direction components of +0.0 and -0.0, origins on a box face and
    inside a box, t_min exactly at a box's exit along an axis (and one ulp
    past it), rays grazing every box at each of its corners, random rays —
    some of them dead, with a whole dead warp and a dead block."""
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    valid = (lo <= hi).all(dim=1)
    base = lo[valid].amin(dim=0)
    size = float((hi[valid] - lo[valid]).amax())
    apart = []
    for i in range(9):
        blo = base + torch.tensor([3.0 * size * i, -2.0 * size, 0.0])
        bhi = blo + torch.tensor([size, 0.0 if i == 2 else size, size])
        if i == 5:
            bhi = blo.clone()
        apart.append(torch.cat([blo, bhi, torch.zeros(2)]))
    pad = mk.empty_boxes((-boxes.shape[0]) % mk.SUPER)
    boxes = torch.cat([boxes, pad, torch.stack(apart), mk.empty_boxes(3)]).contiguous()
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    c = 0.5 * (lo + hi)
    pick = torch.nonzero((lo <= hi).all(dim=1)).flatten()
    axes = torch.eye(3)

    def box_rays(j, axis_list):
        o_j, d_j = [], []
        for a in axis_list:
            for sign in (1.0, -1.0):
                dvec = axes[a] * sign
                dneg = torch.where(dvec == 0, -0.0, dvec)  # -0.0 in the other components
                on_face = c[j].clone()
                on_face[a] = lo[j, a] if sign > 0 else hi[j, a]
                o_j += [on_face, on_face, c[j], c[j]]
                d_j += [dvec, dneg, dvec, dneg]
                # t_min at the exit: (hi - o) * 1 == t_min exactly, and an ulp past
                exit_o = c[j].clone()
                exit_o[a] = hi[j, a] - t_min if sign > 0 else lo[j, a] + t_min
                past = exit_o.clone()
                past[a] = torch.nextafter(exit_o[a], torch.tensor(1e30 * sign))
                o_j += [exit_o, past]
                d_j += [dvec, dvec]
        return o_j, d_j

    # the boxes set apart first, one whole warp each, across y and z only:
    # their rays pass no other box of the supertile
    o_list, d_list = [], []
    for j in pick[-9:].tolist():
        o_j, d_j = box_rays(j, (1, 2))
        o_list += (o_j * 2)[:32]
        d_list += (d_j * 2)[:32]
    for j in pick[torch.from_numpy(rs.permutation(pick.numel() - 9)[:40])].tolist():
        o_j, d_j = box_rays(j, (0, 1, 2))
        o_list += o_j
        d_list += d_j
    # every box's eight corners, each grazed by a ray from outside along the
    # diagonal: such a ray touches the box only there
    for j in pick.tolist():
        for corner in range(8):
            bits = torch.tensor([(corner >> a) & 1 for a in range(3)], dtype=torch.bool)
            p = torch.where(bits, hi[j], lo[j])
            out = torch.where(bits, 1.0, -1.0) / 3 ** 0.5
            o_list.append(p + 2.0 * out)
            d_list.append(-out)
    n_rand = 512
    span = (hi[pick] - lo[pick]).abs().amax()
    o_r = torch.from_numpy(rs.uniform(-1.0, 1.0, (n_rand, 3)).astype(np.float32)) * span
    d_r = torch.from_numpy(rs.normal(size=(n_rand, 3)).astype(np.float32))
    d_r[::5, 1] = 0.0
    d_r[1::5, 0] = -0.0
    d_r = d_r / d_r.norm(dim=1, keepdim=True)
    o = torch.cat([torch.stack(o_list), o_r])
    d = torch.cat([torch.stack(d_list), d_r])
    r = o.shape[0]
    r_pad = -(-r // lanes) * lanes + 2 * lanes  # and a whole dead block
    state = torch.zeros((wf.STATE_ROWS, r_pad))
    state[0:3, :r] = o.T
    state[3:6, :r] = d.T
    state[6:9] = 1.0
    state[9, :r] = 1.0
    state[9, 9 * 32::7] = 0.0
    state[9, 9 * 32:10 * 32] = 0.0  # a dead warp in a live block
    return state.contiguous(), boxes


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_host_mask_two_level_walk_matches_plain_on_adversarial_rays(wave_lib, name):
    """csrc/host_wave.cpp's copy of the mask kernel's walk (supertile union
    boxes, then the leaves of the supertiles a warp's live lanes pass)
    equals wave_mask_reference, verdict for verdict, on configs 3's and 4's
    leaf boxes and the adversarial rays of _adversarial_mask_state. And the
    argument behind it, ray by ray: a ray that passes a leaf's slab test
    passes its supertile's (the union box, megakernel.pack_super_boxes)."""
    torch.set_num_threads(1)
    build_scene = {"config3": lambda: demo.config3_scene(segments=24, rings=12),
                   "config4": lambda: demo.config4_mixed_scene(24, 12)}[name]
    scene = wf.prepare_scene(build_scene().build_packet(device="cpu"))
    rs = np.random.default_rng(len(name))
    lanes, t_min = 64, mk.f32(2.0 ** -10)
    state, boxes = _adversarial_mask_state(scene.boxes, rs, lanes, t_min)
    n_leaf = boxes.shape[0]
    assert n_leaf % mk.SUPER != 0
    mask = torch.full((state.shape[1] // lanes, n_leaf), 7, dtype=torch.uint8)
    mp = wf.MaskParams(t_min=t_min, r_pad=state.shape[1], n_leaf=n_leaf)
    wave_lib.ptre_wave_mask_host(ctypes.addressof(mp), state.data_ptr(), boxes.data_ptr(),
                                 mask.data_ptr(), lanes)
    want = wf.wave_mask_reference(state, boxes, t_min, lanes)
    np.testing.assert_array_equal(mask.numpy(), want.numpy().astype(np.uint8))
    assert bool(want.any()) and not bool(want.all()) and not bool(want[-1].any())
    # per ray: leaf passes imply supertile passes
    o = state[0:3]
    iv = [mk.slab_inv(state[3 + k]) for k in range(3)]
    sup = mk.pack_super_boxes(boxes)
    n_pass = 0
    for leaf in range(n_leaf):
        tn, tf = mk.slab_interval(boxes[leaf, :6].tolist(), o, iv)
        passes = (tn <= tf) & (tf >= t_min)
        tn_s, tf_s = mk.slab_interval(sup[leaf // mk.SUPER, :6].tolist(), o, iv)
        assert bool((~passes | ((tn_s <= tf_s) & (tf_s >= t_min))).all()), leaf
        n_pass += int(passes.sum())
    assert n_pass > 0


@pytest.mark.parametrize("name", list(WAVE_CASES))
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("cull", [True, False])
def test_host_culled_megakernel_matches_plain_version(wave_lib, name, external, cull):
    """mega_kernel.cu's warp — the two-level walk, each lane's box tests
    bounded by its own best hit, the sweep of the leaves a lane passes, the
    recording finish, the all-dead exit — over a ragged ray count, against
    the plain version's 64-ray blocks. Tolerance as
    above: the selections equal and the colour within 1e-5 on >= 99 % of the
    rays, all colours within 2e-4 (three bounces of the ground sphere's
    1e-5), and rays that agree on every selection within 1e-4."""
    torch.set_num_threads(1)
    build_scene, cam_kw = WAVE_CASES[name]
    lanes, B = 64, 3
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    k = mk.TraceConsts.from_config(cfg)
    scene = wf.prepare_scene(build_scene().build_packet(device="cpu"))
    cam = cam_ops.Camera.create(width=W, height=H, **cam_kw)
    px, py = pt.pixel_grid(H, W)
    rs = np.random.default_rng(len(name) + cull)
    R = W * H - 13  # a ragged last block
    jit = torch.from_numpy(rs.uniform(-0.5, 0.5, (W * H, 2)).astype(np.float32))
    o, d = (x[:R].contiguous() for x in cam_ops.get_rays(cam, px, py, jit))
    urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)) if external else None
    p = mk.MegaParams(
        w=mk.wave_params(k, 0xBEEF, 5, scene, n_rays=R, n_sel=R, external_rng=int(external)),
        max_depth=B, n_super=scene.super_boxes.shape[0], cull=int(cull))
    color = torch.empty((R, 3))
    sel = torch.full((B, R), -7, dtype=torch.int32)  # every slot must be written
    plain_color = torch.empty((R, 3))
    stats = np.zeros(len(mk.CULLED_STATS), np.int64)
    for out, rec in ((color, sel), (plain_color, None)):
        wave_lib.ptre_trace_culled_host(
            ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
            None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
            scene.rows.data_ptr(), scene.cull_boxes.data_ptr(), scene.super_boxes.data_ptr(),
            scene.sphs.data_ptr(),
            scene.mats.data_ptr(), scene.sky.data_ptr(), out.data_ptr(),
            None if rec is None else rec.data_ptr(), stats.ctypes.data)
    assert torch.equal(color, plain_color)
    want, want_sel = mk.trace_culled_reference(o, d, scene, k, B, 0xBEEF, 5, urand, cull=cull,
                                               record=True, lanes=lanes)
    assert bool((sel >= -1).all())
    agree = (sel == want_sel).all(dim=0)
    err = (color - want).abs().amax(dim=1)
    assert float((agree & (err <= 1e-5)).float().mean()) >= 0.99
    np.testing.assert_allclose(color.numpy(), want.numpy(), rtol=0, atol=2e-4)
    assert float(err[agree].max()) <= 1e-4
    assert int((want_sel[B - 1] >= 0).sum()) > 0 and int((want_sel == -1).sum()) > 0


# ---- the rasterizer kernels' per-sample code (csrc/raster.cuh) ----------------


@pytest.fixture(scope="module")
def raster_lib(tmp_path_factory):
    lib = _build_host(tmp_path_factory, "host_raster.cpp")
    ptr = ctypes.c_void_p
    lib.ptre_soft_pair_host_d.restype = None
    lib.ptre_soft_pair_host_d.argtypes = [ctypes.c_int] + [ptr] * 5
    lib.ptre_soft_pair_adjoint_host_d.restype = None
    lib.ptre_soft_pair_adjoint_host_d.argtypes = [ctypes.c_int] + [ptr] * 6
    for name, n in (("ptre_raster_hard_host", 5), ("ptre_soft_fwd_host", 6),
                    ("ptre_soft_bwd_host", 7)):
        getattr(lib, name).restype = ctypes.c_longlong
        getattr(lib, name).argtypes = [ptr] * n
    lib.ptre_soft_gate_host.restype = None
    lib.ptre_soft_gate_host.argtypes = [ctypes.c_int] + [ptr] * 3 + [ctypes.c_float, ptr]
    return lib


def _soft_rows(rs, n):
    """(n, 32) float64 soft-table rows: random screen triangles (both
    windings), depths, 1/w, normals * 1/w, keep flags, 1/area and inverse
    squared edge lengths as pack_raster_tris / _soft_cols make them; and a
    sample near each."""
    rows = np.zeros((n, 32))
    v = rs.uniform(0.0, 20.0, (n, 3, 2))
    rows[:, 0:6] = v.reshape(n, 6)
    rows[:, 6:9] = rs.uniform(-0.2, 1.2, (n, 3))
    rows[:, 9:12] = rs.uniform(0.2, 2.0, (n, 3))
    rows[:, 12] = rs.random(n) > 0.1
    rows[:, 13:22] = rs.standard_normal((n, 9)) * np.repeat(rows[:, 9:12], 3, axis=1)
    x, y = v[..., 0], v[..., 1]
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    rows[:, 22] = 1.0 / area
    for j, (a, b) in enumerate(((0, 1), (1, 2), (2, 0))):
        rows[:, 27 + j] = 1.0 / ((x[:, b] - x[:, a]) ** 2 + (y[:, b] - y[:, a]) ** 2 + 1e-12)
    px = v[:, :, 0].mean(1) + rs.uniform(-6.0, 6.0, n)
    py = v[:, :, 1].mean(1) + rs.uniform(-6.0, 6.0, n)
    return rows, px, py


def _tie_rows():
    """Rows whose samples sit exactly on the ties JAX splits in half: the
    diffuse max(-(n.l), 0) at 0 (a normal with ny = 0 under the light
    (0, -1, 0), like the demo cube's side faces), min(d01, min(d12, d20))
    with two and three equal edge distances, the edge clip at t = 0 and
    t = 1, and the depth clip at z = 0 and z = 1. Coordinates are small
    dyadic numbers, so every tie is exact in float64."""
    tri = np.array([0.0, 0.0, 0.0, 4.0, 4.0, 0.0])  # (0,0) (0,4) (4,0): CW, area 16
    rows, pts = [], []
    for (px, py), z, n in [
        ((1.0, 1.0), (0.5, 0.5, 0.5), (1.0, 0.0, 0.0)),   # diffuse tie, inside
        ((-2.0, 6.0), (0.5, 0.5, 0.5), (0.0, 1.0, 0.0)),  # past (0,4): d01 == d12
        ((-2.0, -2.0), (0.5, 0.5, 0.5), (0.0, 1.0, 0.0)), # past (0,0): d01 == d20
        ((-3.0, 0.0), (0.5, 0.5, 0.5), (0.0, -1.0, 0.0)), # edge 01's clip at t = 0
        ((-3.0, 4.0), (0.5, 0.5, 0.5), (0.0, 1.0, 1.0)),  # edge 01's clip at t = 1
        ((1.0, 1.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),   # z = 0: logit clip tie
        ((1.0, 1.0), (1.0, 1.0, 1.0), (0.0, 1.0, 0.0)),   # z = 1
    ]:
        r = np.zeros(32)
        r[0:6] = tri
        r[6:9] = z
        r[9:12] = 1.0
        r[12] = 1.0
        r[13:22] = np.tile(n, 3)
        r[22] = 1.0 / 16.0
        r[27:30] = (1.0 / 16.0, 1.0 / 32.0, 1.0 / 16.0)
        rows.append(r)
        pts.append((px, py))
    pts = np.array(pts)
    return np.array(rows), pts[:, 0].copy(), pts[:, 1].copy()


def test_host_soft_pair_adjoint_matches_float64_autograd(raster_lib):
    """The hand adjoint of pair_terms (raster.cuh) in double against torch
    float64 autograd of the plain `soft_raster.pair_terms` (written with
    gradsafe's half-at-a-tie forms), random rows plus exact ties: 1e-10."""
    from ptre_tpu_torch.ops.cuda import raster_kernel as rk
    from ptre_tpu_torch.ops.cuda import soft_raster as sr
    from ptre_tpu_torch.utils.config import RasterConfig

    torch.set_num_threads(1)
    rs = np.random.default_rng(17)
    rows_r, px_r, py_r = _soft_rows(rs, 400)
    rows_t, px_t, py_t = _tie_rows()
    rows = np.ascontiguousarray(np.concatenate([rows_r, rows_t]))
    px, py = np.concatenate([px_r, px_t]), np.concatenate([py_r, py_t])
    n = rows.shape[0]
    scal = rk.raster_scalars(RasterConfig(), 1.0 / 0.7).numpy()
    gout = rs.standard_normal((n, 5))

    got_f = np.zeros((n, 5))
    raster_lib.ptre_soft_pair_host_d(n, rows.ctypes.data, px.ctypes.data, py.ctypes.data,
                                     scal.ctypes.data, got_f.ctypes.data)
    got_g = np.zeros((n, 32))
    raster_lib.ptre_soft_pair_adjoint_host_d(n, rows.ctypes.data, px.ctypes.data,
                                             py.ctypes.data, scal.ctypes.data,
                                             gout.ctypes.data, got_g.ctypes.data)

    t_rows = torch.from_numpy(rows).requires_grad_(True)
    outs = sr.pair_terms(t_rows, torch.from_numpy(px), torch.from_numpy(py),
                         [float(s) for s in scal])
    want_f = torch.stack(outs, dim=1)
    (want_g,) = torch.autograd.grad(outs, t_rows, tuple(torch.from_numpy(gout[:, k])
                                                        for k in range(5)))
    np.testing.assert_allclose(got_f, want_f.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_g, want_g.numpy(), rtol=1e-10, atol=1e-10)
    # the ties are really hit, and the half rule is what both computed
    tf = want_f.detach().numpy()[-7:]
    assert tf[0, 2] == scal[0] * scal[3]  # diffuse exactly 0 at the tie
    assert float(want_g[-7:].abs().max()) > 0.0


def test_host_soft_pair_ties_match_jax_vjp(raster_lib):
    """The tie rows through JAX's own `_pair_terms` and `jax.vjp` (float32):
    the adjoint's half-at-a-tie rule is JAX's (relative 1e-4)."""
    import jax
    import jax.numpy as jnp

    from ptre_tpu.ops.pallas import soft_raster as jsr
    from ptre_tpu_torch.ops.cuda import raster_kernel as rk
    from ptre_tpu_torch.utils.config import RasterConfig

    rows, px, py = _tie_rows()
    scal = rk.raster_scalars(RasterConfig(), 1.0 / 0.7).numpy()
    rs = np.random.default_rng(5)
    for i in range(rows.shape[0]):
        blk = np.repeat(rows[i:i + 1], 8, axis=0).astype(np.float32)
        go = rs.standard_normal(5)
        f = lambda b: jsr._pair_terms(b, jnp.full((1, 1), px[i], jnp.float32),  # noqa: E731
                                      jnp.float32(py[i]), [jnp.float32(s) for s in scal])
        _, vjp = jax.vjp(f, jnp.asarray(blk))
        cot = tuple(jnp.zeros((8, 1), jnp.float32).at[0, 0].set(go[k]) for k in range(5))
        (want,) = vjp(cot)
        got = np.zeros((1, 32))
        r = np.ascontiguousarray(rows[i:i + 1])
        raster_lib.ptre_soft_pair_adjoint_host_d(
            1, r.ctypes.data, px[i:i + 1].ctypes.data, py[i:i + 1].ctypes.data,
            scal.ctypes.data, np.ascontiguousarray(go[None]).ctypes.data, got.ctypes.data)
        want = np.asarray(want)[0]
        np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"tie row {i}")


def _raster_host_inputs(ss=2, W=40, H=24, y0=1.0, rows=9, stride=2):
    from ptre_tpu_torch.ops.cuda import raster_kernel as rk
    from ptre_tpu_torch.ops.cuda import soft_raster as sr
    from ptre_tpu_torch.utils.config import RasterConfig

    torch.set_num_threads(1)
    cfg = RasterConfig(width=W, height=H, supersample=ss)
    pkt = demo.reference_demo_scene(8, 4).build_packet(spheres_as_triangles=True, device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H)
    cols, cbox = sr._soft_cols(pkt, cam, cfg)
    scal = rk.raster_scalars(cfg, 1.0 / 0.5, y0, stride)
    p = rk.raster_params(scal, rows * ss, W * ss, ss, cbox.shape[0])
    return cols.detach().contiguous(), cbox, scal, p, rows * ss, W * ss, ss


def test_host_raster_kernel_bodies_match_plain_versions(raster_lib):
    """The three kernels' bodies (their tiles, chunk gate and per-sample
    code, built with g++) against the plain versions on a strided ss-2
    window of the demo scene: the hard image to 1e-6 (libm's vs PyTorch's
    sqrt, an ulp), the visited (block, chunk) pairs equal; the soft image
    and residuals to 1e-5 relative (exp and sqrt from other libraries);
    d(table) to 1e-4 of its largest entry (sums in another order), and each
    column group no further from float64 than twice the plain float32
    version (or 1e-4 of the group's norm)."""
    from ptre_tpu_torch.ops.cuda import raster_kernel as rk
    from ptre_tpu_torch.ops.cuda import soft_raster as sr

    cols, cbox, scal, p, R, Wss, ss = _raster_host_inputs()
    out = torch.empty((3, R, Wss))
    h_stats = np.zeros(len(rk.STATS), np.int64)
    n_hard = raster_lib.ptre_raster_hard_host(ctypes.addressof(p), cols.data_ptr(),
                                              cbox.data_ptr(), out.data_ptr(),
                                              h_stats.ctypes.data)
    want = rk.raster_reference(cols, cbox, scal, R, Wss, ss)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert n_hard == rk.visited_pairs(cbox, R, Wss, ss, 1.0, 2.0) > 0
    assert float((want - scal[9:12][:, None, None]).abs().max()) > 0.1

    dbox = sr.dilate(cbox, 0.5)
    img, res = torch.empty((3, R, Wss)), torch.empty((6, R, Wss))
    f_stats = np.zeros(len(sr.STATS), np.int64)
    n_soft = raster_lib.ptre_soft_fwd_host(ctypes.addressof(p), cols.data_ptr(),
                                           dbox.data_ptr(), img.data_ptr(), res.data_ptr(),
                                           f_stats.ctypes.data)
    want_img, want_res = sr.soft_forward_reference(cols, dbox, scal, R, Wss, ss)
    assert n_soft == f_stats[0] == rk.visited_pairs(dbox, R, Wss, ss, 1.0, 2.0) >= n_hard
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.numpy(), want_res.numpy(), rtol=1e-5, atol=1e-6)

    dimg = torch.from_numpy(np.random.default_rng(3).standard_normal((3, R, Wss))
                            .astype(np.float32))
    dtab = torch.zeros_like(cols)
    b_stats = np.zeros(len(sr.STATS), np.int64)
    raster_lib.ptre_soft_bwd_host(ctypes.addressof(p), cols.data_ptr(), dbox.data_ptr(),
                                  res.data_ptr(), dimg.data_ptr(), dtab.data_ptr(),
                                  b_stats.ctypes.data)
    # both bodies walk the same gate; its included pairs are the plain version's
    np.testing.assert_array_equal(b_stats, f_stats)
    assert f_stats[3] == sr.included_pairs(cols, dbox, scal, R, Wss, ss) > 0
    want_d = sr.soft_backward_reference(cols, dbox, scal, res, dimg, R, Wss, ss)
    scale = float(want_d.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(dtab.numpy(), want_d.numpy(), rtol=0, atol=1e-4 * scale)
    # each column group on its own: its norms span 1e-15 (1/w, whose exact
    # gradient is zero) to 1e4, so one norm over the table cannot see a
    # group; the yardstick is the plain float32 version's own distance from
    # its float64 evaluation on the same inputs
    exact = sr.soft_backward_reference(cols.double(), dbox, scal, res.double(), dimg.double(),
                                       R, Wss, ss)
    for group, c in sr.GRAD_GROUPS.items():
        e_host = float((dtab.double() - exact)[:, c].norm())
        e_plain = float((want_d.double() - exact)[:, c].norm())
        assert e_host <= max(2.0 * e_plain, 1e-4 * float(exact[:, c].norm())), group


# ---- the soft kernels' row gate (csrc/raster.cuh gate_box, soft_raster_kernel.cu) ----


def _screen_rows(v):
    """(n, 32) float32 soft-table rows of screen triangles ``v`` (n, 3, 2), as
    pack_raster_tris and _soft_cols make them (area, box and edge lengths in
    float32 from the corners), kept, at depths inside [0, 1]; rows of zero
    area dropped, as the packing drops them."""
    v = torch.as_tensor(v, dtype=torch.float32)
    n = v.shape[0]
    x, y = v[..., 0], v[..., 1]
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    g = torch.Generator().manual_seed(n)
    rows = torch.zeros((n, 32))
    rows[:, 0:6] = v.reshape(n, 6)
    rows[:, 6:9] = torch.rand((n, 3), generator=g) * 0.8 + 0.1
    rows[:, 9:12] = 1.0
    rows[:, 12] = 1.0
    rows[:, 13:22] = torch.randn((n, 9), generator=g)
    rows[:, 22] = 1.0 / area
    rows[:, 23], rows[:, 24] = x.amin(1), x.amax(1)
    rows[:, 25], rows[:, 26] = y.amin(1), y.amax(1)
    for j, (a, b) in enumerate(((0, 1), (1, 2), (2, 0))):
        ex, ey = x[:, b] - x[:, a], y[:, b] - y[:, a]
        rows[:, 27 + j] = 1.0 / (ex * ex + ey * ey + 1e-12)
    return rows[area != 0.0]


def _boundary_triangles(px, py, d, sign):
    """Per sample (px, py) four triangles whose nearest corner, the apex,
    lies d (float32, 14 sigma) + sign ulps from it to the right, left, below
    and above, the rest of the triangle beyond."""
    px, py = np.float32(px), np.float32(py)
    step = np.inf if sign > 0 else -np.inf
    out = []
    for ax, ay, ux, uy in ((np.nextafter(px + d, px + step), py, 1, 0),
                           (np.nextafter(px - d, px - step), py, -1, 0),
                           (px, np.nextafter(py + d, py + step), 0, 1),
                           (px, np.nextafter(py - d, py - step), 0, -1)):
        wx, wy = -uy * 6.0, ux * 6.0
        out.append([(ax, ay), (ax + 20 * ux + wx, ay + 20 * uy + wy),
                    (ax + 20 * ux - wx, ay + 20 * uy - wy)])
    return np.asarray(out, np.float32)


def _gate_table(rs, sigma, cfg, ys, Wss):
    """The demo scene's soft rows plus adversarial ones over the window:
    slivers (areas 1e-4 to 1 sample^2, both windings), triangles with an
    edge through sample centres, and triangles whose nearest corner lies 14
    sigma +- 1 ulp from a sample; padded to whole chunks, with the chunk
    boxes."""
    from ptre_tpu_torch.ops.cuda import raster_kernel as rk
    from ptre_tpu_torch.ops.cuda import soft_raster as sr

    pkt = demo.reference_demo_scene(8, 4).build_packet(spheres_as_triangles=True, device="cpu")
    cam = cam_ops.Camera.create(width=cfg.width, height=cfg.height)
    with torch.no_grad():
        cols, _ = sr._soft_cols(pkt, cam, cfg)
    cols = cols[cols[:, 12] > 0.5]
    H = float(ys[-1]) + 1.0
    n = 48
    a = rs.uniform(0.0, 1.0, (n, 2)) * (Wss, H)
    ang = rs.uniform(0.0, 2 * np.pi, n)
    length = rs.uniform(4.0, 60.0, n)
    b = a + length[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
    t = rs.uniform(0.0, 1.0, n)[:, None]
    width = 10.0 ** rs.uniform(-4.0, 0.0, n) / length * rs.choice([-1.0, 1.0], n)
    c = a + t * (b - a) + width[:, None] * np.stack([-np.sin(ang), np.cos(ang)], 1)
    slivers = np.stack([a, b, c], 1)
    # edges through sample centres: corners on the sample lattice
    xs = rs.integers(0, Wss, (16, 3)) + 0.5
    yi = rs.integers(0, len(ys), (16, 3))
    lattice = np.stack([xs, ys.numpy()[yi]], -1)
    d = np.float32(14.0 * sigma)
    bound = np.concatenate([_boundary_triangles(Wss * f + 0.5, ys[len(ys) // 2], d, sign)
                            for f in (0.25, 0.5) for sign in (-1, 1)])
    extra = _screen_rows(np.concatenate([slivers, lattice, bound]).astype(np.float32))
    table = torch.cat([cols, extra])
    table = torch.cat([table, table.new_zeros(((-table.shape[0]) % rk.CHUNK, 32))])
    return table.contiguous(), rk.chunk_boxes(table)


@pytest.mark.parametrize("sigma", [0.5, 2.0])
@pytest.mark.parametrize("ss", [1, 2, 3])
@pytest.mark.parametrize("y0,stride,rows", [(0.0, 1, 32), (5.0, 3, 9)])
def test_host_soft_row_gate_drops_no_pair_that_counts(raster_lib, sigma, ss, y0, stride, rows):
    """The soft kernels' bodies with their row gate (tile row mask, then the
    per-sample gate box) on the demo scene's rows plus slivers, lattice
    edges and corners 14 sigma +- 1 ulp from a sample: every (sample, row)
    pair whose plain coverage exceeds COV_MIN is evaluated and included (the
    brute force over all pairs, and `soft_raster.included_pairs` over the
    chunk windows, count the same), the pairs evaluated lie between those
    inside the row's box dilated 14 sigma and those an ungated sweep takes,
    and the forward and backward bodies count alike."""
    from ptre_tpu_torch.ops.cuda import raster_kernel as rk
    from ptre_tpu_torch.ops.cuda import soft_raster as sr
    from ptre_tpu_torch.utils.config import RasterConfig

    torch.set_num_threads(1)
    W, H = 48, 32
    cfg = RasterConfig(width=W, height=H, supersample=ss)
    R, Wss = rows * ss, W * ss
    ys = rk.sample_ys(R, ss, y0, stride)
    rs = np.random.default_rng(int(100 * sigma) + 10 * ss + stride)
    table, cbox = _gate_table(rs, sigma, cfg, ys, Wss)
    dbox = sr.dilate(cbox, sigma)
    scal = rk.raster_scalars(cfg, 1.0 / sigma, y0, stride)
    p = rk.raster_params(scal, R, Wss, ss, cbox.shape[0])

    img, res = torch.empty((3, R, Wss)), torch.empty((6, R, Wss))
    f_stats = np.zeros(len(sr.STATS), np.int64)
    raster_lib.ptre_soft_fwd_host(ctypes.addressof(p), table.data_ptr(), dbox.data_ptr(),
                                  img.data_ptr(), res.data_ptr(), f_stats.ctypes.data)
    dimg = torch.from_numpy(rs.standard_normal((3, R, Wss)).astype(np.float32))
    dtab = torch.zeros_like(table)
    b_stats = np.zeros(len(sr.STATS), np.int64)
    raster_lib.ptre_soft_bwd_host(ctypes.addressof(p), table.data_ptr(), dbox.data_ptr(),
                                  res.data_ptr(), dimg.data_ptr(), dtab.data_ptr(),
                                  b_stats.ctypes.data)
    np.testing.assert_array_equal(b_stats, f_stats)
    visits, _, evaluated, included = (int(v) for v in f_stats)

    s = [float(v) for v in scal.tolist()]
    xs = torch.arange(Wss, dtype=torch.float32) + 0.5
    brute = 0
    with torch.no_grad():
        for k in range(0, table.shape[0], 16):
            cov = sr.pair_terms(table[k:k + 16], xs[None, :, None], ys[:, None, None], s)[0]
            brute += int((cov > sr.COV_MIN).sum())
    assert included == brute == sr.included_pairs(table, dbox, scal, R, Wss, ss) > 0
    in_box = rk.box_pairs(table, ys, Wss, sr.DILATE_SIGMA * sigma)
    assert in_box <= evaluated <= visits * rk.TILE * rk.TILE * rk.CHUNK
    want_img, _ = sr.soft_forward_reference(table, dbox, scal, R, Wss, ss)
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.5, 2.0])
@pytest.mark.parametrize("sign", [-1, 1])
def test_host_soft_gate_box_at_14_sigma_plus_minus_one_ulp(raster_lib, sigma, sign):
    """A sample 14 sigma +- 1 ulp from a row's box, on each side: the gate
    box (grown by kGatePadRel) holds it, so the pair is evaluated; its
    plain coverage is below COV_MIN either way. A sample 14 sigma plus a
    few pads away is culled, and its coverage is below COV_MIN too."""
    from ptre_tpu_torch.ops.cuda import soft_raster as sr
    from ptre_tpu_torch.utils.config import RasterConfig
    from ptre_tpu_torch.ops.cuda import raster_kernel as rk

    rs = np.random.default_rng(7)
    pts = np.stack([rs.uniform(0.0, 2000.0, 8), rs.uniform(0.0, 1200.0, 8)], 1)
    pts = np.floor(pts) + 0.5
    d = np.float32(sr.DILATE_SIGMA * sigma)
    tri, px, py = [], [], []
    for x, y in pts:
        tri.append(_boundary_triangles(x, y, d, sign))
        px += [x] * 4
        py += [y] * 4
    rows = _screen_rows(np.concatenate(tri)).contiguous()
    px, py = np.asarray(px, np.float32), np.asarray(py, np.float32)
    assert rows.shape[0] == px.size
    scal = rk.raster_scalars(RasterConfig(), 1.0 / sigma)

    def gate(x, y):
        out = np.zeros(px.size, np.int32)
        raster_lib.ptre_soft_gate_host(px.size, rows.data_ptr(), x.ctypes.data, y.ctypes.data,
                                       float(scal[12]), out.ctypes.data)
        return out

    def cov(x, y):
        return sr.pair_terms(rows, torch.from_numpy(x), torch.from_numpy(y),
                             [float(v) for v in scal.tolist()])[0]

    assert gate(px, py).all()
    assert bool((cov(px, py) <= sr.COV_MIN).all())
    # a few pads further out along the apex's axis: culled, and not counting
    far = np.float32(5e-5) * (rows[:, 23:27].abs().amax(1).numpy() + d)
    ax = rows[:, 0].numpy() - px
    ay = rows[:, 1].numpy() - py
    fx = px - np.sign(ax) * np.where(np.abs(ax) > np.abs(ay), far, 0.0).astype(np.float32)
    fy = py - np.sign(ay) * np.where(np.abs(ay) > np.abs(ax), far, 0.0).astype(np.float32)
    assert not gate(fx, fy).any()
    assert bool((cov(fx, fy) <= sr.COV_MIN).all())
