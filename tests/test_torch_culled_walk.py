"""The culled megakernel's per-warp walk, checked on the CPU.

`csrc/host_wave.cpp` `ptre_trace_culled_host` runs the redesigned kernel's
warp (per bounce the supertiles a live lane passes, in them each leaf's box
tested by every live lane, the 64 rows swept only by the lanes whose own
ray passes it) and `csrc/baseline/raster_mega/host_first.cpp` the first
design's block (every live ray sweeping each leaf that some ray of its
block passes), both built with g++, which contracts no a*b+c: their colours
and selections must be EQUAL, on small config 3 and config 4 scenes with
both uniform sources at max_depth 1, 5 and 8, a ray count that is not a
multiple of 32, rays that all miss, and rays grazing leaf and supertile
boxes and triangle corners at one ulp. Against the plain version,
`trace_culled_reference`, the selections are equal and the colours agree
to 1e-5 (libm's cos and sin against PyTorch's, and the r = 10 ground
sphere's ulp of 7.6e-6; `test_torch_csrc_host.py`'s bound).

The counters (megakernel.CULLED_STATS): the warps visit at least the
(ray, leaf) pairs the rays pass themselves, and the live ray-bounces, the
pairs passed and the warps' lane slots equal `trace_culled_reference`'s
counts with 32-ray blocks (a block of 32 is a warp; its ``swept_pairs`` are
the warps' ``warp_slots``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils.config import RenderConfig

W, H = 24, 16
SEED, SAMPLE = 0xC0FFEE, 3


def _build(tmp_path_factory, source):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail(f"no C++ compiler (g++) to build csrc/{source}")
    out = str(tmp_path_factory.mktemp("walk") / "libptre_walk.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-o",
                    out, os.path.join(build.CSRC_DIR, source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    ptr = ctypes.c_void_p
    new = _build(tmp_path_factory, "host_wave.cpp")
    new.ptre_trace_culled_host.restype = None
    new.ptre_trace_culled_host.argtypes = [ptr] * 14
    first = _build(tmp_path_factory, os.path.join("baseline", "raster_mega", "host_first.cpp"))
    first.ptre_trace_culled_host.restype = None
    first.ptre_trace_culled_host.argtypes = [ptr] * 13 + [ctypes.c_int]
    return new, first


SCENES = {
    "config3": lambda: demo.config3_scene(False, 16, 8, diffuse=True),
    "config4": lambda: demo.config4_mixed_scene(16, 8),
}


@pytest.fixture(scope="module")
def scenes():
    return {name: wf.prepare_scene(fn().build_packet(device="cpu")) for name, fn in
            SCENES.items()}


def _camera_rays(R, seed):
    cam = cam_ops.Camera.create(width=W, height=H)
    px, py = pt.pixel_grid(H, W)
    jit = torch.from_numpy(np.random.default_rng(seed).uniform(-0.5, 0.5, (W * H, 2))
                           .astype(np.float32))
    o, d = cam_ops.get_rays(cam, px, py, jit)
    return o[:R].contiguous(), d[:R].contiguous()


def _params(scene, k, B, R, external, cull=True):
    return mk.MegaParams(
        w=mk.wave_params(k, SEED, SAMPLE, scene, n_rays=R, n_sel=R, external_rng=int(external)),
        max_depth=B, n_super=scene.super_boxes.shape[0], cull=int(cull))


def _host(lib, first, scene, p, o, d, urand, R, B, lanes=mk.CULLED_LANES):
    color = torch.empty((R, 3))
    sel = torch.full((B, R), -7, dtype=torch.int32)  # every slot must be written
    args = [ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
            None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
            scene.rows.data_ptr(), scene.cull_boxes.data_ptr(), scene.super_boxes.data_ptr(),
            scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr(),
            color.data_ptr(), sel.data_ptr()]
    if first:
        lib.ptre_trace_culled_host(*args, lanes)
        return color, sel, None
    stats = np.zeros(len(mk.CULLED_STATS), np.int64)
    lib.ptre_trace_culled_host(*args, stats.ctypes.data)
    return color, sel, dict(zip(mk.CULLED_STATS, stats.tolist()))


def _hold(libs, scene, o, d, B, external, rs, cull=True):
    """The walk's colours and selections against the first design's (256-
    and 64-ray blocks) and the plain version's; its counters against the
    plain version's with 32-ray blocks. Returns (colour, selections,
    counters)."""
    torch.set_num_threads(1)
    R = o.shape[0]
    k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=B))
    urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)) if external else None
    p = _params(scene, k, B, R, external, cull)
    color, sel, st = _host(libs[0], False, scene, p, o, d, urand, R, B)
    for lanes in (mk.CULLED_LANES, 64):
        fc, fs, _ = _host(libs[1], True, scene, p, o, d, urand, R, B, lanes)
        assert torch.equal(color, fc) and torch.equal(sel, fs), lanes
    assert bool((sel >= -1).all())
    count = {}
    want, want_sel = mk.trace_culled_reference(o, d, scene, k, B, SEED, SAMPLE, urand,
                                               cull=cull, record=True, lanes=32,
                                               stats=count if cull else None)
    assert torch.equal(sel, want_sel)
    np.testing.assert_allclose(color.numpy(), want.numpy(), rtol=0, atol=1e-5)
    if cull:
        for key, ref in (("ray_bounces", "ray_bounces"), ("own_pairs", "own_pairs"),
                         ("warp_slots", "swept_pairs")):
            assert st[key] == count[ref], key
        assert st["warp_slots"] >= st["own_pairs"]
        assert st["leaf_tests"] >= st["warp_slots"]
        assert st["super_tests"] == st["ray_bounces"] * scene.super_boxes.shape[0]
    return color, sel, st


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("max_depth", [1, 5, 8])
@pytest.mark.parametrize("external", [True, False])
def test_warp_walk_equals_first_design(libs, scenes, name, max_depth, external):
    scene = scenes[name]
    R = W * H - 13  # not a multiple of 32: a ragged last warp
    o, d = _camera_rays(R, max_depth)
    rs = np.random.default_rng(max_depth + 7 * external)
    color, sel, st = _hold(libs, scene, o, d, max_depth, external, rs)
    assert int((sel[0] >= 0).sum()) > R // 4
    assert st["own_pairs"] > 0 and st["ray_bounces"] >= R
    if max_depth > 1:
        assert int((sel[1] >= 0).sum()) > 0


def test_warp_walk_cull_off_equals_first_design(libs, scenes):
    o, d = _camera_rays(W * H, 5)
    _hold(libs, scenes["config4"], o, d, 3, True, np.random.default_rng(5), cull=False)


def test_warp_walk_when_every_ray_misses(libs, scenes):
    """Rays from above the scene looking up: one bounce each, the sky, -1
    selections, and no leaf visited."""
    scene = scenes["config4"]
    R = 77
    o = torch.zeros((R, 3))
    o[:, 0] = torch.linspace(-3.0, 3.0, R)
    o[:, 1] = 50.0
    d = torch.zeros((R, 3))
    d[:, 1] = 1.0
    d[::3, 0] = 0.1
    d = d / d.norm(dim=1, keepdim=True)
    color, sel, st = _hold(libs, scene, o, d, 5, False, np.random.default_rng(1))
    assert bool((sel == -1).all()) and st["ray_bounces"] == R
    assert st["warp_slots"] == st["own_pairs"] == 0


def _grazing_rays(scene, rs, n_leaf_picked=24):
    """Rays that graze boxes: for picked leaves and their supertiles, every
    corner of the dilated cull box and of the union box approached along its
    outward diagonal with the origin moved by -1, 0 and +1 ulp; rays aimed
    exactly at triangle corners (the undilated boxes' extremes) and one ulp
    beside them."""
    o_list, d_list = [], []
    leaves = rs.permutation(scene.n_leaf)[:n_leaf_picked].tolist()
    boxes = [scene.cull_boxes[j, :6] for j in leaves]
    boxes += [scene.super_boxes[j // mk.SUPER, :6] for j in leaves[: n_leaf_picked // 2]]
    for b in boxes:
        lo, hi = b[0:3], b[3:6]
        for corner in range(8):
            bits = torch.tensor([(corner >> a) & 1 for a in range(3)], dtype=torch.bool)
            p = torch.where(bits, hi, lo)
            out = torch.where(bits, 1.0, -1.0) / 3 ** 0.5
            o0 = p + 2.0 * out
            for step in (-1, 0, 1):
                oo = o0.clone()
                if step:
                    oo = torch.nextafter(oo, oo + step * out)
                o_list.append(oo)
                d_list.append(-out)
    rows = scene.rows[: scene.n_leaf * mk.LEAF]
    valid = torch.nonzero(rows[:, 9] > 0.5).flatten()
    for j in valid[torch.from_numpy(rs.permutation(valid.numel())[:64])].tolist():
        v0 = rows[j, 0:3]
        for _ in range(2):
            dvec = torch.from_numpy(rs.normal(size=3).astype(np.float32))
            dvec = dvec / dvec.norm()
            for step in (-1, 0, 1):
                target = v0 if not step else torch.nextafter(v0, v0 + step * dvec)
                o_list.append(target - 3.0 * dvec)
                d_list.append(dvec)
    return torch.stack(o_list).contiguous(), torch.stack(d_list).contiguous()


@pytest.mark.parametrize("name", list(SCENES))
def test_warp_walk_on_rays_grazing_boxes(libs, scenes, name):
    rs = np.random.default_rng(len(name))
    o, d = _grazing_rays(scenes[name], rs)
    R = o.shape[0] - 5 if o.shape[0] % 32 == 0 else o.shape[0]  # a ragged last warp
    o, d = o[:R].contiguous(), d[:R].contiguous()
    _hold(libs, scenes[name], o, d, 3, True, rs)
