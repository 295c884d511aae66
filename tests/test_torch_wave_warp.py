"""The wavefront bounce kernel's warp walk, checked on the CPU.

`csrc/host_wave.cpp` `ptre_wave_bounce_host` runs the kernel's warps of 32
columns (per listed leaf every live lane's own box test, bounded by its
closest hit so far, a ballot of the lanes that pass, and the warp sweeping
their rays one at a time, two rows a lane, with a (t, row) minimum by the
kernel's butterfly) and `csrc/baseline/wave_lane/host_lane.cpp` the design
before it (each passing ray swept on its own lane, `wave.cuh sweep_leaf`).
Both are built with g++, which contracts no a*b+c: their next states and
selections must be EQUAL bit for bit. Against the plain version,
`wave_bounce_reference`, fed the same state: the selections equal bit for
bit, the counters (`wavefront.BOUNCE_STATS`) equal, and the state within
1e-4 with >= 99 % of it within 1e-6 (libm's cos and sin against PyTorch's;
`test_torch_csrc_host.py`'s bound).

Cases: small config 3 and config 4 scenes at bounces 0-4 (each bounce fed
the plain version's previous state, sorted as `trace` sorts it), recording
and not, both uniform sources, blocks of 256 and 64 rays, a ray count that
is not a multiple of 32 (the last warp ragged: dead padding lanes); rays
that all miss; rays grazing leaf boxes and triangle corners at one ulp;
duplicated rows, where a tie must go to the lowest row, within a lane,
across lanes and across leaves.
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

from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.utils.config import RenderConfig
from ptre_tpu_torch.utils.errors import RendererError
from test_torch_culled_walk import SCENES, W, H, _camera_rays, _grazing_rays

SEED, SAMPLE, B = 0xBADCAB, 2, 5


def _build(tmp_path_factory, source):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail(f"no C++ compiler (g++) to build csrc/{source}")
    out = str(tmp_path_factory.mktemp("wave_warp") / "libptre_wave_warp.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-I",
                    build.CSRC_DIR, "-o", out, os.path.join(build.CSRC_DIR, source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    ptr = ctypes.c_void_p
    warp = _build(tmp_path_factory, "host_wave.cpp")
    warp.ptre_wave_bounce_host.restype = None
    warp.ptre_wave_bounce_host.argtypes = [ptr] * 15 + [ctypes.c_int]
    lane = _build(tmp_path_factory, os.path.join("baseline", "wave_lane", "host_lane.cpp"))
    lane.ptre_wave_bounce_host.restype = None
    lane.ptre_wave_bounce_host.argtypes = [ptr] * 14 + [ctypes.c_int]
    return warp, lane


@pytest.fixture(scope="module")
def scenes():
    return {name: wf.prepare_scene(fn().build_packet(device="cpu")) for name, fn in
            SCENES.items()}


def _host(lib, counted, state, ids, short, cnt, scene, p, urand, sel, lanes):
    """One bounce of a host build: (next state, counters or None)."""
    out = torch.empty_like(state)
    args = [ctypes.addressof(p), state.data_ptr(), ids.data_ptr(), short.data_ptr(),
            cnt.data_ptr(), scene.tris.data_ptr(), scene.rows.data_ptr(),
            scene.cull_boxes.data_ptr(), scene.sphs.data_ptr(), scene.mats.data_ptr(),
            scene.sky.data_ptr(), None if urand is None else urand.data_ptr(),
            out.data_ptr(), None if sel is None else sel.data_ptr()]
    if not counted:
        lib.ptre_wave_bounce_host(*args, lanes)
        return out, None
    stats = np.zeros(len(wf.BOUNCE_STATS), np.int64)
    lib.ptre_wave_bounce_host(*args, stats.ctypes.data, lanes)
    return out, dict(zip(wf.BOUNCE_STATS, stats.tolist()))


def _hold(libs, scene, state, ids, k, b, urand, lanes):
    """Bounce ``b`` of ``state`` (the mask's shortlists) through the warp
    walk, recording and not, the per-lane design and the plain version:
    returns (the plain version's next state, the walk's counters,
    the walk's selection row)."""
    torch.set_num_threads(1)
    R = ids.shape[0]
    short, cnt = wf.shortlists_from_mask(wf.wave_mask_reference(state, scene.boxes, k.t_min,
                                                                lanes))
    p = mk.wave_params(k, SEED, SAMPLE, scene, n_rays=0 if urand is None else urand.shape[1],
                       r_pad=state.shape[1], list_stride=short.shape[1], bounce=b,
                       external_rng=int(urand is not None), n_sel=R)
    warp, lane = libs
    sel, lane_sel, want_sel = (torch.full((B, R), -7, dtype=torch.int32) for _ in range(3))
    got, st = _host(warp, True, state, ids, short, cnt, scene, p, urand, sel, lanes)
    plain, st_plain = _host(warp, True, state, ids, short, cnt, scene, p, urand, None, lanes)
    per_lane, _ = _host(lane, False, state, ids, short, cnt, scene, p, urand, lane_sel, lanes)
    count = {}
    want = wf.wave_bounce_reference(state, ids, short, cnt, scene, k, b, SEED, SAMPLE, urand,
                                    lanes, sel=want_sel, stats=count)
    assert torch.equal(got, plain) and torch.equal(got, per_lane), b
    assert torch.equal(sel, lane_sel) and torch.equal(sel, want_sel), b
    assert st == st_plain == count, (b, st, count)
    err = (got - want).abs()
    assert float((err <= 1e-6).float().mean()) >= 0.99, (b, float(err.max()))
    assert float(err.max()) <= 1e-4, b
    dead = state[9] < 0.5
    assert torch.equal(got[:, dead], state[:, dead])
    return want, st, sel[b]


def _walk(libs, scene, o, d, k, urand, lanes, bounces=B):
    """Bounces 0 .. ``bounces`` - 1 of fresh rays, each `_hold`, the state
    sorted between them as `trace` sorts it: the counters of each bounce
    entered with a live ray, and the selection rows."""
    state, ids = wf.initial_state(o, d, lanes)
    stats, rows = [], []
    for b in range(bounces):
        if not bool((state[9] > 0.5).any()):
            break
        nxt, st, sel_b = _hold(libs, scene, state, ids, k, b, urand, lanes)
        stats.append(st)
        rows.append(sel_b)
        perm = wf.coherence_order(nxt, scene)
        state, ids = nxt[:, perm].contiguous(), ids[perm].contiguous()
    return stats, rows


def _consts(max_depth=B):
    return mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=max_depth))


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("lanes", [wf.LANES, 64])
def test_warp_bounce_equals_per_lane_design_and_plain(libs, scenes, name, external, lanes):
    scene = scenes[name]
    R = W * H - 13  # not a multiple of 32: a ragged last warp
    o, d = _camera_rays(R, 3 + external)
    rs = np.random.default_rng(lanes + external)
    urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)) if external else None
    stats, rows = _walk(libs, scene, o, d, _consts(), urand, lanes)
    assert len(stats) >= 3
    assert stats[0]["ray_bounces"] == R and int((rows[0] >= 0).sum()) > R // 4
    for st in stats:
        assert st["own_pairs"] <= st["lane_slots"] <= st["listed_tests"]
        assert st["warp_visits"] <= st["own_pairs"]
    assert stats[0]["own_pairs"] > 0 and stats[1]["own_pairs"] > 0


def test_warp_bounce_when_every_ray_misses(libs, scenes):
    """Rays from above the scene looking up: the sky, -1 selections, and no
    leaf swept."""
    R = 77
    o = torch.zeros((R, 3))
    o[:, 0] = torch.linspace(-3.0, 3.0, R)
    o[:, 1] = 50.0
    d = torch.zeros((R, 3))
    d[:, 1] = 1.0
    d[::3, 0] = 0.1
    d = d / d.norm(dim=1, keepdim=True)
    stats, rows = _walk(libs, scenes["config4"], o, d, _consts(), None, wf.LANES)
    assert len(stats) == 1 and stats[0]["ray_bounces"] == R
    assert bool((rows[0][:R] == -1).all())
    assert stats[0]["own_pairs"] == stats[0]["warp_visits"] == stats[0]["lane_slots"] == 0


@pytest.mark.parametrize("name", list(SCENES))
def test_warp_bounce_on_rays_grazing_boxes(libs, scenes, name):
    rs = np.random.default_rng(len(name) + 1)
    o, d = _grazing_rays(scenes[name], rs)
    R = o.shape[0] - 5 if o.shape[0] % 32 == 0 else o.shape[0]  # a ragged last warp
    urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32))
    stats, _ = _walk(libs, scenes[name], o[:R].contiguous(), d[:R].contiguous(), _consts(),
                     urand, 64, bounces=3)
    assert stats[0]["own_pairs"] > 0


def _duplicated(scene):
    """``scene`` with tied rows, among its whole leaves (the packet's rows
    only): in each, every even row j < 32 copied to rows j + 1, j + 32 and
    j + 33 (a tie on one lane, across lanes and both), then each odd leaf
    replaced by the leaf before it (a tie across leaves); the compact rows
    and every box table rebuilt as `prepare_scene` builds them. Returns
    (scene, whole leaves, leaves paired)."""
    tris = scene.tris.clone()
    T = scene.tri_rows
    m = T // mk.LEAF
    q = m // 2 * 2
    leaves = tris[:m * mk.LEAF].view(m, mk.LEAF, 32)
    for j in range(0, 32, 2):
        for dup in (j + 1, j + 32, j + 33):
            leaves[:, dup] = leaves[:, j]
    leaves[1:q:2] = leaves[0:q:2]
    v0, v1, v2 = tris[:T, 0:3], tris[:T, 3:6], tris[:T, 6:9]
    boxes = mk.pack_tile_boxes(v0, v1, v2, tris[:T, 18] > 0.5, mk.LEAF)
    scale = torch.maximum(scene.scene_lo.abs().amax(), scene.scene_hi.abs().amax())
    cull_boxes, super_boxes = wf.cull_tables(boxes, scale)
    return dataclasses.replace(
        scene, tris=tris, rows=wf.pack_rows(tris, scene.perm_tri), boxes=boxes.contiguous(),
        cull_boxes=cull_boxes, super_boxes=super_boxes,
        mask_supers=mk.pack_super_boxes(boxes).contiguous()), m, q


@pytest.mark.parametrize("name", list(SCENES))
def test_warp_bounce_ties_go_to_the_lowest_row(libs, scenes, name):
    scene, m, q = _duplicated(scenes[name])
    R = W * H
    o, d = _camera_rays(R, 11)
    _, rows = _walk(libs, scene, o, d, _consts(), None, wf.LANES, bounces=3)
    won = torch.cat([r[(r >= 0) & (r < scene.tri_rows)] for r in rows]).long()
    leaf, j = won // mk.LEAF, won % mk.LEAF
    assert int((leaf < m).sum()) >= 16 and int((leaf < q).sum()) > 0
    # every winner is the first of its copies: in a whole leaf an even row
    # below 32, and of a pair of leaves the even one
    assert bool(((j < 32) & (j % 2 == 0))[leaf < m].all())
    assert bool((leaf[leaf < q] % 2 == 0).all())


def test_wave_bounce_and_trace_count_on_the_cpu(scenes):
    """`wave_bounce(stats=)` and `trace(bounce_stats=)` on CPU tensors add
    the plain version's counters; counting changes no colour; a counter
    tensor of another shape or dtype is refused."""
    torch.set_num_threads(1)
    scene = scenes["config4"]
    k = _consts(3)
    o, d = _camera_rays(W * H, 5)
    state, ids = wf.initial_state(o, d)
    short, cnt = wf.all_leaves(state.shape[1] // wf.LANES, scene.n_leaf, device="cpu")
    stats = torch.zeros(len(wf.BOUNCE_STATS), dtype=torch.int64)
    count = {}
    got = wf.wave_bounce(state, ids, short, cnt, scene, k, 0, 3, 1, stats=stats)
    want = wf.wave_bounce_reference(state, ids, short, cnt, scene, k, 0, 3, 1, stats=count)
    assert torch.equal(got, want)
    assert stats.tolist() == [count[n] for n in wf.BOUNCE_STATS]
    assert count["listed_tests"] == W * H * scene.n_leaf
    with pytest.raises(RendererError, match="shape"):
        wf.wave_bounce(state, ids, short, cnt, scene, k, 0, stats=stats[:4].contiguous())
    with pytest.raises(RendererError, match="contiguous int64"):
        wf.trace(o, d, scene, k, 3, bounce_stats=stats.int())
    bounce_stats = torch.zeros(len(wf.BOUNCE_STATS), dtype=torch.int64)
    color = wf.trace(o, d, scene, k, 3, seed=3, sample=1, bounce_stats=bounce_stats)
    plain = torch.zeros_like(bounce_stats)
    color_plain = wf.trace(o, d, scene, k, 3, seed=3, sample=1, plain=True,
                           bounce_stats=plain)
    assert torch.equal(color, wf.trace(o, d, scene, k, 3, seed=3, sample=1))
    assert torch.equal(color, color_plain) and torch.equal(bounce_stats, plain)
    st = dict(zip(wf.BOUNCE_STATS, bounce_stats.tolist()))
    assert st["ray_bounces"] > W * H and 0 < st["own_pairs"] <= st["lane_slots"]
    assert st["lane_slots"] <= st["listed_tests"] and 0 < st["warp_visits"] <= st["own_pairs"]
