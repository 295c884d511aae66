"""The hard raster kernel's row gate, checked on the CPU.

`csrc/host_raster.cpp` runs the redesigned kernel's body (the chunk gate,
the row gate of `raster.cuh` hard_gate_box, and covers() only where a mask
row's gate box holds the sample) and `csrc/baseline/raster_mega/
host_first.cpp` the first design's (every row of every visited chunk), both
built with g++, which contracts no a*b+c: their images must be EQUAL, on the
demo scene and on tables built to break a box gate — slivers whose area is
a few ulps, samples exactly on and one ulp outside rows' boxes, z ties on
shared edges and on duplicated rows. Against the plain version,
`raster_reference`, the images agree to 1.2e-7 (one ulp of a colour <= 1:
PyTorch's vectorised division and square root against libm's in the
shading), the winners' coverage the same.

The gate boxes of `raster_kernel.hard_gate_boxes` (PyTorch, for counting)
equal the kernel's (`ptre_hard_gate_host`) bit for bit, and the counters
(raster_kernel.STATS) are checked against what the inputs give: the
visited (block, chunk) pairs of `visited_pairs`, and pairs evaluated between
the pairs with the sample inside the row's own box and inside its gate box
(`box_pairs`), equal to the latter where every reach is finite and under
half a sample.
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
from ptre_tpu_torch.models.scene import Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import raster_kernel as rk
from ptre_tpu_torch.utils.config import RasterConfig

ULP_ONE = 1.2e-7  # an ulp of a colour in [0.5, 1]


def _build(tmp_path_factory, source):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail(f"no C++ compiler (g++) to build csrc/{source}")
    out = str(tmp_path_factory.mktemp("gate") / "libptre_gate.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-o",
                    out, os.path.join(build.CSRC_DIR, source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    ptr = ctypes.c_void_p
    new = _build(tmp_path_factory, "host_raster.cpp")
    new.ptre_raster_hard_host.restype = ctypes.c_longlong
    new.ptre_raster_hard_host.argtypes = [ptr] * 5
    new.ptre_hard_gate_host.restype = None
    new.ptre_hard_gate_host.argtypes = [ctypes.c_int, ptr, ptr, ptr]
    first = _build(tmp_path_factory, os.path.join("baseline", "raster_mega", "host_first.cpp"))
    first.ptre_raster_hard_host.restype = ctypes.c_longlong
    first.ptre_raster_hard_host.argtypes = [ptr] * 4
    return new, first


def _run(libs, tris, cbox, scal, rows_ss, width_ss, ss):
    """(gated image, first design's image, counters, plain image)"""
    new, first = libs
    p = rk.raster_params(scal, rows_ss, width_ss, ss, cbox.shape[0])
    got, fst = torch.empty((3, rows_ss, width_ss)), torch.empty((3, rows_ss, width_ss))
    stats = np.zeros(len(rk.STATS), np.int64)
    n_new = new.ptre_raster_hard_host(ctypes.addressof(p), tris.data_ptr(), cbox.data_ptr(),
                                      got.data_ptr(), stats.ctypes.data)
    n_first = first.ptre_raster_hard_host(ctypes.addressof(p), tris.data_ptr(), cbox.data_ptr(),
                                          fst.data_ptr())
    assert n_new == n_first == stats[0]
    want = rk.raster_reference(tris, cbox, scal, rows_ss, width_ss, ss)
    return got, fst, dict(zip(rk.STATS, stats.tolist())), want


def _check(libs, tris, cbox, scal, rows_ss, width_ss, ss, y0=0.0, stride=1.0):
    """Hold the gated body to the first design and the plain version, and its
    counters to the inputs' pair counts; returns (counters, gate boxes)."""
    torch.set_num_threads(1)
    got, fst, st, want = _run(libs, tris, cbox, scal, rows_ss, width_ss, ss)
    assert torch.equal(got, fst)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ULP_ONE)
    assert st["visits"] == rk.visited_pairs(cbox, rows_ss, width_ss, ss, y0, stride)
    ys = rk.sample_ys(rows_ss, ss, y0, stride)
    span = rk.window_span(rows_ss, width_ss, ss, y0, stride)
    boxes = rk.hard_gate_boxes(tris, span)
    # the PyTorch gate boxes that count the pairs are the kernel's, bit for bit
    host_boxes = torch.empty((tris.shape[0], 4))
    p = rk.raster_params(scal, rows_ss, width_ss, ss, cbox.shape[0])
    libs[0].ptre_hard_gate_host(tris.shape[0], tris.data_ptr(), ctypes.addressof(p),
                                host_boxes.data_ptr())
    keep = tris[:, 12] > 0.5
    assert torch.equal(host_boxes[keep], boxes[keep])
    n_box, n_gate = rk.box_pairs(tris, ys, width_ss), rk.box_pairs(tris, ys, width_ss,
                                                                  boxes=boxes)
    assert n_box <= st["pairs_evaluated"] <= n_gate
    assert st["pairs_covering"] <= st["pairs_evaluated"]
    reach = (boxes[:, 1] - tris[:, 24])[keep]
    if reach.numel() and bool(torch.isfinite(reach).all()) and float(reach.max()) < 0.5:
        assert st["pairs_evaluated"] == n_gate
    return st, boxes


def _demo(W, H, ss, y0=0.0, stride=1, rows=None, scene=None):
    cfg = RasterConfig(width=W, height=H, supersample=ss)
    scene = demo.reference_demo_scene(16, 8) if scene is None else scene
    pkt = scene.build_packet(spheres_as_triangles=True, device="cpu")
    with torch.no_grad():
        tris, cbox = rk.pack_raster_tris(pkt, cam_ops.Camera.create(width=W, height=H), cfg)
    rows = H if rows is None else rows
    return tris, cbox, rk.raster_scalars(cfg, 0.0, y0, stride), rows * ss, W * ss, ss


DEMO_CASES = {
    "demo_64x36_ss2": dict(W=64, H=36, ss=2),
    "ragged_37x23_ss2": dict(W=37, H=23, ss=2),
    "strided_y0_5_stride_3": dict(W=48, H=40, ss=2, y0=5.0, stride=3, rows=9),
    "ss3": dict(W=40, H=24, ss=3),
}


@pytest.mark.parametrize("name", list(DEMO_CASES))
def test_gated_hard_body_equals_first_design_on_the_demo(libs, name):
    kw = DEMO_CASES[name]
    tris, cbox, scal, rows_ss, width_ss, ss = _demo(**kw)
    st, _ = _check(libs, tris, cbox, scal, rows_ss, width_ss, ss, kw.get("y0", 0.0),
                   kw.get("stride", 1))
    # the gate skips most of what the first design swept
    swept = st["visits"] * rk.TILE * rk.TILE * rk.CHUNK
    assert 0 < st["pairs_covering"] <= st["pairs_evaluated"] < swept // 4
    assert st["rows_passed"] < st["visits"] * rk.CHUNK


def test_gated_hard_body_on_the_empty_scene(libs):
    tris, cbox, scal, rows_ss, width_ss, ss = _demo(32, 16, 2, scene=Scene())
    got, fst, st, want = _run(libs, tris, cbox, scal, rows_ss, width_ss, ss)
    clear = scal[9:12][:, None, None].expand_as(got)
    assert torch.equal(got, fst) and torch.equal(got, clear) and torch.equal(want, clear)
    assert st == dict.fromkeys(rk.STATS, 0)


# ---- adversarial tables ------------------------------------------------------------


def _table(v, z=None, seed=0):
    """A hard-raster table of screen triangles ``v`` (n, 3, 2) float32, kept,
    at depths ``z`` (n, 3) (default inside [0.1, 0.9]), the area, its inverse
    and the box in float32 from the corners as pack_raster_tris makes them;
    rows of zero area are dropped as the packing drops them. The rows keep
    their order (tie rules are about the order, not the Morton sort), padded
    to whole chunks; returns (table, chunk boxes)."""
    v = torch.as_tensor(np.asarray(v, np.float32))
    n = v.shape[0]
    g = torch.Generator().manual_seed(seed)
    x, y = v[..., 0], v[..., 1]
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    rows = torch.zeros((n, 32))
    rows[:, 0:6] = v.reshape(n, 6)
    rows[:, 6:9] = (torch.rand((n, 3), generator=g) * 0.8 + 0.1) if z is None else torch.as_tensor(
        np.asarray(z, np.float32))
    rows[:, 9:12] = 1.0
    rows[:, 12] = 1.0
    rows[:, 13:22] = torch.randn((n, 9), generator=g)
    rows[:, 22] = 1.0 / area
    rows[:, 23], rows[:, 24] = x.amin(1), x.amax(1)
    rows[:, 25], rows[:, 26] = y.amin(1), y.amax(1)
    rows = rows[area != 0.0]
    pad = (-rows.shape[0]) % rk.CHUNK
    rows = torch.cat([rows, torch.zeros((pad, 32))]).contiguous()
    return rows, rk.chunk_boxes(rows)


def _slivers(rs, n, W, H):
    """Triangles whose third corner lies a hair (1e-7 to 1e-2 samples) off
    the line through the other two, the line often through sample centres,
    in both windings and every direction, with areas down to a few ulps."""
    out = []
    for i in range(n):
        a = rs.uniform(0, W, 2)
        if i % 3 == 0:  # corners on sample centres
            a = np.floor(a) + 0.5
        ang = rs.uniform(0, 2 * np.pi)
        length = rs.uniform(2, 0.8 * max(W, H))
        b = a + length * np.array([np.cos(ang), np.sin(ang)])
        if i % 3 == 0:
            b = np.floor(b) + 0.5
        t = rs.uniform(-0.2, 1.2)
        off = 10.0 ** rs.uniform(-7, -2) * rs.choice([-1, 1])
        nrm = np.array([-(b - a)[1], (b - a)[0]]) / np.linalg.norm(b - a)
        c = a + t * (b - a) + off * nrm
        out.append([a, b, c] if i % 2 else [a, c, b])
    return np.asarray(out, np.float32)


def _covering_outside_box(tris, ys, xs):
    """(sample, kept row) pairs that covers() accepts (the plain version's
    float32 arithmetic) with the sample outside the row's own screen box."""
    n = 0
    for c in tris[tris[:, 12] > 0.5]:
        w0, w1, w2, z = rk.barycentric(lambda j: c[j], xs[None, :], ys[:, None])
        cov = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z >= 0) & (z <= 1)
        out = ((xs[None, :] < c[23]) | (xs[None, :] > c[24]) | (ys[:, None] < c[25])
               | (ys[:, None] > c[26]))
        n += int((cov & out).sum())
    return n


def test_slivers_near_an_ulp_of_area(libs):
    """Slivers on a 64x48 window: the plain arithmetic covers samples outside
    their boxes (so a gate on the bare box would drop winners), the gate
    leaves such rows ungated or grown enough, and the image is the first
    design's."""
    rs = np.random.default_rng(12)
    W, H = 64, 48
    v = _slivers(rs, 180, W, H)
    tris, cbox = _table(v, seed=1)
    keep = tris[:, 12] > 0.5
    area = 1.0 / tris[keep, 22].abs()
    assert float(area.min()) < 1e-4  # a few ulps of the corners' products
    ys = rk.sample_ys(H, 1, 0.0, 1.0)
    xs = torch.arange(W, dtype=torch.float32) + 0.5
    assert _covering_outside_box(tris, ys, xs) > 0
    scal = rk.raster_scalars(RasterConfig(width=W, height=H, supersample=1))
    _, boxes = _check(libs, tris, cbox, scal, H, W, 1)
    reach = (boxes[:, 1] - tris[:, 24])[keep]
    assert int(torch.isinf(reach).sum()) > 0  # some rows are left ungated


def _edge_cases(W, H):
    """Triangles with a corner exactly on a sample centre and one ulp off it
    on either side, on every side of the box, small and large, both
    windings."""
    out = []
    for cx, cy in ((10.5, 7.5), (31.5, 20.5), (50.5, 3.5)):
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            for sgn in (-1, 0, 1):
                ax = np.float32(cx) if dx == 0 or sgn == 0 else np.nextafter(
                    np.float32(cx), np.float32(cx + sgn * dx * 10))
                ay = np.float32(cy) if dy == 0 or sgn == 0 else np.nextafter(
                    np.float32(cy), np.float32(cy + sgn * dy * 10))
                for size in (1.0, 6.0):
                    wx, wy = -dy * size * 0.5, dx * size * 0.5
                    far = (ax + dx * size, ay + dy * size)
                    tri = [(ax, ay), (far[0] + wx, far[1] + wy), (far[0] - wx, far[1] - wy)]
                    out += [tri, tri[::-1]]
    return np.asarray(out, np.float32)


def test_samples_on_and_one_ulp_outside_row_boxes(libs):
    W, H = 64, 24
    tris, cbox = _table(_edge_cases(W, H), seed=2)
    scal = rk.raster_scalars(RasterConfig(width=W, height=H, supersample=1))
    st, _ = _check(libs, tris, cbox, scal, H, W, 1)
    assert st["pairs_covering"] > 0


def test_z_ties_on_shared_edges_and_duplicate_rows(libs):
    """Quads split along diagonals through sample centres at one depth, so
    both halves cover the diagonal's samples at equal z, and the same
    triangles again 64 rows later (another chunk): the lowest row wins
    every tie in both bodies."""
    W, H = 48, 32
    quads, zs = [], []
    for x0, y0, s, z in ((2.5, 2.5, 12.0, 0.5), (20.5, 4.5, 9.0, 0.25), (30.5, 14.5, 14.0, 0.75),
                         (6.5, 17.5, 11.0, 0.5)):
        p00, p10, p01, p11 = (x0, y0), (x0 + s, y0), (x0, y0 + s), (x0 + s, y0 + s)
        quads += [[p00, p10, p11], [p00, p11, p01]]
        zs += [[z] * 3, [z] * 3]
    v = np.asarray(quads, np.float32)
    z = np.asarray(zs, np.float32)
    far = np.asarray([[[100, 100], [101, 100], [100, 101]]], np.float32)  # off the window
    pad_v = np.tile(far, (64 - len(v), 1, 1))
    pad_z = np.full((64 - len(v), 3), 0.5, np.float32)
    v = np.concatenate([v, pad_v, v])
    z = np.concatenate([z, pad_z, z])
    tris, cbox = _table(v, z, seed=3)
    scal = rk.raster_scalars(RasterConfig(width=W, height=H, supersample=1))
    st, _ = _check(libs, tris, cbox, scal, H, W, 1)
    # every covered sample is covered at least twice (the duplicate chunk)
    assert st["pairs_covering"] >= 2 * 4 * 9 * 9
