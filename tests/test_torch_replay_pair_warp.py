"""The redesigned replay kernels' warp body against the first design's, on the CPU.

`csrc/host_replay.cpp` runs the redesigned kernels' body with g++: a warp
of 32 rays emulated on the per-lane code of `csrc/replay.cuh` (the vote
that ends the warp's recompute once no lane's path is alive, the saved
states in a strided slice, d(g) staged as slabs or written as zeros, d(sky)
summed by warp, block and block order). `csrc/baseline/replay_pair/
host_first.cpp` runs the first design's per-ray bodies against the frozen
headers there. g++ contracts no a*b+c, so the two run the same float
operations unless the redesign reordered some: the colour, d(o), d(d) and
d(g) must be EQUAL; d(sky), summed in another order, within 1e-6 relative
(L2). The slab counters the twin reports equal `chip_smoke.warp_slabs`
(what the chip's phase 21 prints), and the twin stays within
`test_torch_csrc_replay_host.py`'s bounds of the plain versions.

Cases: the demo scene (cube diffuse) and a config 4-style dense scene
(`config4_mixed_scene(8, 4)`, 60 triangles and 2 spheres), both uniform
sources, max_depth 1, 5 and 8, at R = 407 rays (neither a multiple of 32
nor of 4: a ragged last warp, a block with warps past the rays); every ray
missing; every first hit emissive.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils.config import RenderConfig

W, H = 37, 11
R = W * H
SEED, SAMPLE = 91, 3
STATS = ("skipped", "zero_slabs", "staged")


def _build(tmp_path_factory, source, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail(f"no C++ compiler (g++) to build csrc/{source}")
    out = str(tmp_path_factory.mktemp(name) / f"lib{name}.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-o", out,
                    os.path.join(build.CSRC_DIR, source)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(out)
    for kind, n in (("fwd", 8), ("bwd", 13 if name == "twin" else 12)):
        for dt in ("f", "d"):
            fn = getattr(lib, f"ptre_replay_{kind}_host_{dt}")
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p] * n
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(the twin of the redesign, the first design's host build)"""
    return (_build(tmp_path_factory, "host_replay.cpp", "twin"),
            _build(tmp_path_factory, os.path.join("baseline", "replay_pair", "host_first.cpp"),
                   "first"))


def _paths(scene, external, max_depth, case="recorded"):
    """Recorded paths at W x H: rays, selections, gathered rows, sky,
    uniforms, consts and a colour cotangent."""
    torch.set_num_threads(1)
    if scene == "demo":
        pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
        pkt = dataclasses.replace(pkt, mat_kind=torch.zeros_like(pkt.mat_kind),
                                  mat_param=torch.tensor([1.0, 0.4]))
    else:
        pkt = demo.config4_mixed_scene(8, 4).build_packet(device="cpu")
    if case == "emissive":  # every material an emitter: every path ends at its first hit
        pkt = dataclasses.replace(pkt, mat_kind=torch.ones_like(pkt.mat_kind))
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    px, py = pt.pixel_grid(H, W, device="cpu")
    rs = np.random.default_rng(max_depth + 10 * external)
    jit = torch.from_numpy(rs.random((R, 2), np.float32)) - 0.5
    o, d = (t.contiguous() for t in cam_ops.get_rays(cam, px, py, jit))
    if case == "miss":  # every ray leaves upwards, over the whole scene
        d = torch.nn.functional.normalize(
            torch.from_numpy(rs.normal(size=(R, 3)).astype(np.float32)) * 0.2
            + torch.tensor([0.0, 1.0, 0.0]), dim=1).contiguous()
        o = (o + torch.tensor([0.0, 50.0, 0.0])).contiguous()
    k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=max_depth))
    urand = (torch.from_numpy(rs.random((2 + 2 * max_depth, R), np.float32))
             if external else None)
    _, sel = mk.trace_record_reference(o, d, mk.pack_scene(pkt), k, max_depth, SEED, SAMPLE,
                                       urand)
    table, T, sky6 = (x.detach() if torch.is_tensor(x) else x
                      for x in path_replay.build_table(pkt))
    g = path_replay.gather_rows(table, sel).contiguous()
    dcol = torch.from_numpy(rs.normal(size=(R, 3)).astype(np.float32))
    return dict(o=o, d=d, sel=sel.contiguous(), g=g, sky6=sky6.contiguous(), T=T, k=k,
                urand=urand, dcol=dcol, B=max_depth)


def _run(lib, p, kind, dtype=torch.float32, stats=None):
    params = mk.trace_params(R, p["k"], p["B"], SEED, SAMPLE, p["urand"] is not None,
                             sph_offset=p["T"], n_rows=rpk._ANY_ROW)
    g, sky6, o, d, dcol = (p[x].to(dtype).contiguous() for x in ("g", "sky6", "o", "d", "dcol"))
    ur = None if p["urand"] is None else p["urand"].data_ptr()
    dt = "d" if dtype == torch.float64 else "f"
    common = (ctypes.addressof(params), g.data_ptr(), sky6.data_ptr(), o.data_ptr(),
              d.data_ptr(), p["sel"].data_ptr(), ur)
    if kind == "fwd":
        color = torch.full((R, 3), 7.0, dtype=dtype)
        getattr(lib, f"ptre_replay_fwd_host_{dt}")(*common, color.data_ptr())
        return color
    out = [torch.full_like(o, 7.0), torch.full_like(d, 7.0), torch.full_like(g, 7.0),
           torch.zeros(6, dtype=dtype)]
    extra = () if stats is False else (None if stats is None else stats.ctypes.data,)
    getattr(lib, f"ptre_replay_bwd_host_{dt}")(*common, dcol.data_ptr(),
                                                *(x.data_ptr() for x in out), *extra)
    return out


def _hold(libs, p):
    """Twin vs first design, both dtypes; the counters; returns the twin's
    float outputs (colour, backward) and counters."""
    twin, first = libs
    for dtype in (torch.float32, torch.float64):
        col = _run(twin, p, "fwd", dtype)
        assert torch.equal(col, _run(first, p, "fwd", dtype)), dtype
        stats = np.zeros(len(STATS), np.int64)
        got = _run(twin, p, "bwd", dtype, stats)
        want = _run(first, p, "bwd", dtype, stats=False)
        for name, a, b in zip(("d(o)", "d(d)", "d(g)"), got, want):
            assert torch.equal(a, b), (name, dtype)
        if float(want[3].norm()) == 0.0:
            assert float(got[3].abs().max()) == 0.0
        else:
            assert float((got[3] - want[3]).norm() / want[3].norm()) <= 1e-6, dtype
        if dtype == torch.float32:
            out = (col, got, dict(zip(STATS, stats.tolist())))
    counts = chip_smoke.warp_slabs(p["g"], p["sel"], p["B"])
    assert out[2] == {key: counts[key] for key in STATS}
    assert counts["zero_slabs"] + counts["staged"] == counts["warp_bounces"]
    return out


def _close(name, got, want, rtol, atol_rel):
    scale = float(want.abs().max())
    assert bool(torch.isfinite(got).all()), name
    if scale == 0.0:
        assert float(got.abs().max()) == 0.0, name
        return
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol_rel * scale,
                               err_msg=name)


def _hold_plain(p, col, bwd):
    """The twin against the plain versions, under the bounds of
    test_torch_csrc_replay_host.py (float)."""
    args = (p["sel"], p["sky6"])
    want = rpk.replay_fwd_reference(p["o"], p["d"], p["g"], *args, p["T"], p["k"], p["B"], SEED,
                                    SAMPLE, p["urand"])
    _close("colour", col, want, 1e-5, 1e-5)
    ref = rpk.replay_bwd_reference(p["o"], p["d"], p["g"], *args, p["dcol"], p["T"], p["k"],
                                   p["B"], SEED, SAMPLE, p["urand"])
    for name, a, b in zip(("d(o)", "d(d)", "d(g)", "d(sky)"), bwd, ref):
        _close(name, a, b, 5e-4, 1e-5)


@pytest.mark.parametrize("max_depth", [1, 5, 8])
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("scene", ["demo", "config4"])
def test_warp_body_equals_first_design(libs, scene, external, max_depth):
    p = _paths(scene, external, max_depth)
    col, bwd, stats = _hold(libs, p)
    _hold_plain(p, col, bwd)
    sel = p["sel"]
    assert bool((bwd[2][sel < 0] == 0).all())  # the 7.0 fill is overwritten with zeros
    assert bool((sel >= 0).any()) and bool((sel < 0).any())
    if max_depth > 1:
        # warps with no hit at a bounce they entered, and dead tails skipped
        assert stats["zero_slabs"] > stats["skipped"] > 0
        assert ((sel >= 0) & (sel < p["T"])).any() and (sel >= p["T"]).any()


@pytest.mark.parametrize("external", [True, False])
def test_warp_body_every_ray_missing(libs, external):
    p = _paths("demo", external, 5, case="miss")
    assert bool((p["sel"] < 0).all())
    col, bwd, stats = _hold(libs, p)
    _hold_plain(p, col, bwd)
    n_warps = -(-R // 32)
    assert stats == {"skipped": 4 * n_warps, "zero_slabs": 5 * n_warps, "staged": 0}
    assert float(bwd[2].abs().max()) == 0.0 and float(bwd[3].abs().max()) > 0  # d(sky) only


@pytest.mark.parametrize("external", [True, False])
def test_warp_body_every_first_hit_emissive(libs, external):
    p = _paths("config4", external, 8, case="emissive")
    sel = p["sel"]
    assert bool((sel[1:] < 0).all()) and bool((sel[0] >= 0).any())
    col, bwd, stats = _hold(libs, p)
    _hold_plain(p, col, bwd)
    n_warps = -(-R // 32)
    assert stats["skipped"] == 7 * n_warps
    assert float(bwd[2][0, :, 23:27].abs().max()) > 0  # albedo and param of the emitters
