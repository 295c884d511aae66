"""The redesigned render and recording kernels' scheduler, checked on the CPU.

`csrc/host_render.cpp` and `csrc/host_grad.cpp` run the kernels' own code
(`csrc/trace.cuh`: the valid triangle rows derived once, `path_bounce`,
`RenderJob` / `RecordJob`) through `host_dense`, a 32-lane warp
simulated in the kernel's order: a lane whose path ended takes the tile's
next item. `csrc/baseline/host_first.cpp` runs the first designs' bodies,
one path at a time, against the frozen headers they shipped with.

* The two are bit-equal (images and colours) and their selections equal:
  g++ contracts no a*b+c without -mfma, and the redesign reorders no float
  operation of a path — it only skips candidates whose result was
  discarded and reads each row's edges from the derived row.
* Both stay within the bounds the host build already held to the plain
  PyTorch versions (`test_torch_csrc_host.py`: rtol 1e-5, atol 1e-5;
  selections exact).
* The counters equal what the paths imply: every item started once, the
  recorded hits, the live ray-bounces (one sweep at bounce 0 and after each
  hit that goes on) and each path's length; refilled lanes issue fewer
  warp-bounces than the first design (`chip_smoke.first_design_warp_bounces`:
  each of its warps runs its longest path).

Cases: the demo at 32x16 (tiles of mixed path lengths), a ragged 100x37
image, the empty scene, max_depth 1 and 8, both uniform sources, and a
scene with invalid rows interleaved and two identical triangles, where the
lowest original index must win and be recorded.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import first_design_warp_bounces, first_render_params
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models.scene import Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils.config import RenderConfig

PTR = ctypes.c_void_p


def _build(tmp_path_factory, source):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail(f"no C++ compiler (g++) to build csrc/{source}")
    out = str(tmp_path_factory.mktemp("sched") / (os.path.basename(source) + ".so"))
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-o",
                    out, os.path.join(build.CSRC_DIR, source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    render = _build(tmp_path_factory, "host_render.cpp")
    render.ptre_render_sample_host.restype = None
    render.ptre_render_sample_host.argtypes = [PTR] * 10
    grad = _build(tmp_path_factory, "host_grad.cpp")
    grad.ptre_trace_record_host.restype = None
    grad.ptre_trace_record_host.argtypes = [PTR] * 12
    first = _build(tmp_path_factory, "baseline/host_first.cpp")
    first.ptre_render_sample_first.restype = None
    first.ptre_render_sample_first.argtypes = [PTR] * 7
    first.ptre_trace_record_first.restype = None
    first.ptre_trace_record_first.argtypes = [PTR] * 10
    return render, grad, first


def _tie_scene():
    """Rows 0, 2, 4, 6 invalid (row 0 a triangle in front of everything);
    row 1 a small triangle in front of the right of the view; rows 3 and 5
    one large triangle twice, so every other ray ties between them."""
    def tri(z, x0=-10.0, y0=-10.0, size=40.0):
        return [x0, y0, z], [x0 + size, y0, z], [x0, y0 + size, z]

    rows = [(tri(-1.0), 0), (tri(-0.5, 0.3, -3.0, 6.0), 1), (tri(-2.0), 0), (tri(0.0), 1),
            (tri(-3.0), 0), (tri(0.0), 1), (tri(-4.0), 0)]
    v = torch.tensor([r[0] for r in rows], dtype=torch.float32)
    n = torch.tensor([[0.0, 0.0, -1.0]], dtype=torch.float32).expand(len(rows), 3)
    valid = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    tris = mk.pack_tri32(v[:, 0], v[:, 1], v[:, 2], n, n, n, valid,
                         torch.zeros(len(rows))).contiguous()
    sphs = torch.zeros((1, 16), dtype=torch.float32)
    mats = mk.pack_mats(torch.tensor([0]), torch.tensor([[0.7, 0.6, 0.5]]),
                        torch.tensor([0.3]))
    sky = torch.tensor([1.0, 1.0, 1.0, 0.5, 0.7, 1.0, 0.0, 0.0])
    return mk.PackedScene(tris=tris, sphs=sphs, mats=mats, sky=sky, n_tri=len(rows), n_sph=1,
                          num_mats=1, tri_rows=len(rows))


TIE_CAM = dict(position=(0.0, 0.0, -5.0), forward=(0.0, 0.0, 1.0))

# name: (packed scene, camera keywords, W, H, max_depth)
CASES = {
    "demo": (lambda: mk.pack_scene(demo.reference_demo_scene(8, 4).build_packet(device="cpu")),
             {}, 32, 16, 5),
    "ragged_100x37": (lambda: mk.pack_scene(
        demo.reference_demo_scene(8, 4).build_packet(device="cpu")), {}, 100, 37, 5),
    "empty": (lambda: mk.pack_scene(Scene().build_packet(device="cpu")), {}, 32, 16, 5),
    "depth1": (lambda: mk.pack_scene(demo.reference_demo_scene(8, 4).build_packet(device="cpu")),
               {}, 32, 16, 1),
    "depth8": (lambda: mk.pack_scene(demo.reference_demo_scene(8, 4).build_packet(device="cpu")),
               {}, 32, 16, 8),
    "tie_invalid_rows": (_tie_scene, TIE_CAM, 32, 16, 3),
}


def _urand(rs, external, shape):
    return torch.from_numpy(rs.random(shape, dtype=np.float32)) if external else None


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("external", [True, False])
def test_render_scheduler_equals_first_design_bit_for_bit(libs, name, external):
    torch.set_num_threads(1)
    render, _, first = libs
    make_scene, cam_kw, W, H, B = CASES[name]
    scene = make_scene()
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H, **cam_kw, device="cpu"))
    rs = np.random.default_rng(len(name) + 11 * B)
    prev = torch.from_numpy(rs.random((H, W, 3), dtype=np.float32))
    urand = _urand(rs, external, (2 + 2 * B, H, W))
    params = rk.render_params(H, W, scene, 3, cfg, 0xC0FFEE, external_rng=external)
    tables = (scene.tris.data_ptr(), scene.sphs.data_ptr(), scene.mats.data_ptr(),
              scene.sky.data_ptr())
    ur = None if urand is None else urand.data_ptr()
    got, want_first = prev.clone(), prev.clone()
    stats = np.zeros(len(mk.DENSE_STATS), dtype=np.uint64)
    lens = torch.zeros((H, W), dtype=torch.int32)
    render.ptre_render_sample_host(ctypes.addressof(params), rows.data_ptr(), got.data_ptr(),
                                   ur, *tables, stats.ctypes.data, lens.data_ptr())
    # the first design takes the camera rows by value (`first_render_params`)
    first_params = first_render_params(params, rows)
    first.ptre_render_sample_first(ctypes.addressof(first_params), want_first.data_ptr(), ur,
                                   *tables)
    assert torch.equal(got, want_first)
    want = rk.sample_accum_reference(prev, scene, rows, 3, cfg, 0xC0FFEE, urand)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, prev)

    started, live, hits, issued, tested = (int(x) for x in stats)
    issued_first = first_design_warp_bounces(lens)
    assert started == W * H
    assert W * H <= live <= W * H * B and hits <= live
    assert int(lens.sum()) == live and 1 <= int(lens.min()) <= int(lens.max()) <= B
    assert live <= 32 * issued and live <= 32 * issued_first
    assert tested <= live * scene.n_tri
    if name == "empty":
        assert (live, hits, tested) == (W * H, 0, 0)
    if name == "demo":
        # the cube's group boxes: most ray-bounces test none of its rows
        assert 0 < tested < live * 12 // 2
    if name in ("demo", "depth8", "ragged_100x37"):
        # tiles of mixed path lengths: refilled lanes issue fewer warp-bounces
        assert issued < issued_first


def _path_lengths(sel, scene, B):
    """Sweeps a path made (one at bounce 0 and one after every hit that
    goes on) and its hits, from its recorded selections."""
    kind = scene.mats[:, 0]
    emissive = torch.zeros(scene.tri_rows + scene.n_sph, dtype=torch.bool)
    emissive[:scene.n_tri] = kind[scene.tris[:, 19].long()] > 0.5
    emissive[scene.tri_rows:] = kind[scene.sphs[:, 5].long()] > 0.5
    hit = sel >= 0
    on = hit & ~emissive[sel.clamp(min=0).long()]
    return 1 + on[:B - 1].sum(dim=0), hit.sum(dim=0)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("external", [True, False])
def test_record_scheduler_equals_first_design_bit_for_bit(libs, name, external):
    torch.set_num_threads(1)
    _, grad, first = libs
    make_scene, cam_kw, W, H, B = CASES[name]
    scene = make_scene()
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    k = mk.TraceConsts.from_config(cfg)
    cam = cam_ops.Camera.create(width=W, height=H, **cam_kw, device="cpu")
    px, py = pt.pixel_grid(H, W, device="cpu")
    rs = np.random.default_rng(len(name) + 7 * B)
    jit = torch.from_numpy(rs.random((H * W, 2), dtype=np.float32)) - 0.5
    o, d = (t.contiguous() for t in cam_ops.get_rays(cam, px, py, jit))
    R = o.shape[0]
    urand = _urand(rs, external, (2 + 2 * B, R))
    params = mk.trace_params(R, k, B, 0xABC, 2, external, scene=scene)
    args = (ctypes.addressof(params), o.data_ptr(), d.data_ptr(),
            None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
            scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr())
    color, color_first = torch.zeros((R, 3)), torch.zeros((R, 3))
    sel = torch.full((B, R), 7, dtype=torch.int32)
    sel_first = sel.clone()
    stats = np.zeros(len(mk.DENSE_STATS), dtype=np.uint64)
    lens = torch.zeros(R, dtype=torch.int32)
    grad.ptre_trace_record_host(*args, color.data_ptr(), sel.data_ptr(), stats.ctypes.data,
                                lens.data_ptr())
    first.ptre_trace_record_first(*args, color_first.data_ptr(), sel_first.data_ptr())
    assert torch.equal(color, color_first) and torch.equal(sel, sel_first)
    want_c, want_s = mk.trace_record_reference(o, d, scene, k, B, 0xABC, 2, urand)
    assert torch.equal(sel, want_s)
    np.testing.assert_allclose(color.numpy(), want_c.numpy(), rtol=1e-5, atol=1e-5)

    length, n_hits = _path_lengths(sel, scene, B)
    started, live, hits, issued, tested = (int(x) for x in stats)
    assert started == R and hits == int(n_hits.sum()) and tested <= live * scene.n_tri
    assert torch.equal(lens, length.int()) and live == int(length.sum())
    pad = (-R) % 32
    warps = torch.cat([length, length.new_zeros(pad)]).reshape(-1, 32)
    assert first_design_warp_bounces(lens) == int(warps.amax(dim=1).sum())
    assert live <= 32 * issued
    if name == "tie_invalid_rows":
        # the lowest original index of the tie wins and is recorded; the
        # invalid rows in front of both accept nothing
        first_hit = sel[0]
        assert set(first_hit.tolist()) == {1, 3}
        assert int((first_hit == 3).sum()) > int((first_hit == 1).sum()) > 0


def test_group_box_cull_drops_no_hit_on_grazing_rays(libs):
    """The group boxes cull no hit the full sweep finds: rays aimed at the
    demo cube's vertices, edge midpoints and centroids (and one float32 ulp
    beside them on each axis), and axis-aligned rays in the planes of the
    cube's box faces, recorded by the redesign and by the first design (which
    tests every row): selections and colours equal."""
    torch.set_num_threads(1)
    _, grad, first = libs
    scene = mk.pack_scene(demo.reference_demo_scene(8, 4).build_packet(device="cpu"))
    tris = scene.tris[scene.tris[:, 18] > 0.5]
    v = tris[:, 0:9].reshape(-1, 3, 3)
    targets = torch.cat([v.reshape(-1, 3), (v + v.roll(1, dims=1)).reshape(-1, 3) * 0.5,
                         v.mean(dim=1)])
    ulp = torch.nextafter(targets, torch.full_like(targets, np.inf)) - targets
    shifts = [torch.zeros(3)] + [s * torch.eye(3)[k] for k in range(3) for s in (-1.0, 1.0)]
    targets = torch.cat([targets + ulp * s for s in shifts])
    rs = np.random.default_rng(5)
    origins = torch.from_numpy(rs.normal(size=targets.shape).astype(np.float32))
    origins = targets + 6.0 * origins / origins.norm(dim=1, keepdim=True)
    origins[:, 1] = origins[:, 1].abs() + 1.0  # above the ground sphere
    d = targets - origins
    d = d / d.norm(dim=1, keepdim=True)
    lo, hi = v.reshape(-1, 3).amin(dim=0), v.reshape(-1, 3).amax(dim=0)
    axis = []  # rays along x in the planes y = lo, hi and z = lo, hi of the box
    for t in np.linspace(0.0, 1.0, 33, dtype=np.float32):
        for y, z in ((lo[1], lo[2] + t * (hi[2] - lo[2])), (hi[1], lo[2] + t * (hi[2] - lo[2])),
                     (lo[1] + t * (hi[1] - lo[1]), lo[2]), (lo[1] + t * (hi[1] - lo[1]), hi[2])):
            axis.append([float(lo[0]) - 3.0, float(y), float(z)])
    o = torch.cat([origins, torch.tensor(axis)]).contiguous()
    d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]]).expand(len(axis), 3)]).contiguous()
    R, B = o.shape[0], 2
    k = mk.TraceConsts.from_config(RenderConfig(width=8, height=8, max_depth=B))
    params = mk.trace_params(R, k, B, 0x5EED, 1, False, scene=scene)
    args = (ctypes.addressof(params), o.data_ptr(), d.data_ptr(), None, scene.tris.data_ptr(),
            scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr())
    color, color_first = torch.zeros((R, 3)), torch.zeros((R, 3))
    sel = torch.full((B, R), 7, dtype=torch.int32)
    sel_first = sel.clone()
    grad.ptre_trace_record_host(*args, color.data_ptr(), sel.data_ptr(), None, None)
    first.ptre_trace_record_first(*args, color_first.data_ptr(), sel_first.data_ptr())
    assert torch.equal(sel, sel_first) and torch.equal(color, color_first)
    cube = (sel[0] >= 0) & (sel[0] < scene.tri_rows)
    assert int(cube.sum()) > R // 4  # most rays hit the cube, many on an edge
