"""The staged route's intersection (`ptre_tpu_torch/ops/intersect.py`) and
the sweep kernel's body (`csrc/sweep.cuh`) against the JAX package.

Selections are integers and held exactly:

  * the plain `intersect.sweep` against JAX's XLA sweep, on the same world
    triangles, primary rays and bounce-1 rays (leaving surfaces, so t_min
    self-hits are exercised). XLA contracts a*b+c into FMAs on the CPU where
    the port rounds each operation, so a near tie could flip a winner: the
    test counts the rays that differ (0 measured on these scenes) and allows
    at most 1e-3 of them;
  * the TPU kernel (`intersect_kernel.sweep`, interpret mode) on one small
    case, the same way;
  * the g++ build of the kernel body (`csrc/host_sweep.cpp`) against the
    plain sweep, and both against the dense bounce loop's own sweep
    (`megakernel.trace_record_reference`, bounce 0) on one scene, so that
    the copies of the quirks cannot drift apart.

Floats: the hit attributes and `closest_hit` within 1e-5 (relative, 1e-6
absolute) of JAX, and the attributes' autograd within 1e-4 of ``jax.grad``:
the same formulas, rounded in another order; a primitive test's t within
1e-4 (a ray leaving the r = 10 ground cancels |oc|^2 - r^2, ROADMAP C2);
`closest_hit`'s gradients, summed over a scene's rays, within 2e-3
relative L2 per leaf (grazing rays reach the gradsafe floors).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import intersect as jint
from ptre_tpu.ops.pallas import intersect_kernel as jik
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models.scene import Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import intersect
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import sweep_kernel as sk
from ptre_tpu_torch.ops.cuda.take_rows import take_rows
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils.config import RenderConfig

W, H = 48, 24
K = mk.TraceConsts.from_config(RenderConfig())
SCENES = {
    "demo": (lambda: jdemo.reference_demo_scene(8, 4), lambda: demo.reference_demo_scene(8, 4)),
    "config4": (lambda: jdemo.config4_mixed_scene(24, 12),
                lambda: demo.config4_mixed_scene(24, 12)),
    "config3": (lambda: jdemo.config3_scene(False, 32, 16),
                lambda: demo.config3_scene(False, 32, 16)),
}


def _np(t):
    return np.asarray(t)


def _rays(pkt, seed=0):
    """Jittered primary rays, and bounce-1 rays leaving the surfaces they hit
    (offset by shadow_eps along the normal, a random outward direction)."""
    rs = np.random.default_rng(seed)
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    px, py = pt.pixel_grid(H, W, device="cpu")
    jit = torch.from_numpy(rs.uniform(-0.5, 0.5, (W * H, 2)).astype(np.float32))
    o, d = cam_ops.get_rays(cam, px, py, jit)
    hit = intersect.closest_hit(o, d, pkt, pkt.world_triangles(), K.t_min, K.t_max, K.det_eps)
    dirs = torch.from_numpy(rs.normal(size=(W * H, 3)).astype(np.float32))
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    dirs = torch.where((dirs * hit.normal).sum(1, keepdim=True) < 0, -dirs, dirs)
    o1 = (hit.position + K.shadow_eps * hit.normal)[hit.hit]
    return [(o, d), (o1.contiguous(), dirs[hit.hit].contiguous())]


def _world(jp):
    """JAX's world triangles, handed to both sides: the sweep is compared
    on identical inputs."""
    return tuple(torch.from_numpy(_np(w).copy()) for w in jp.world_triangles())


def _flips(got, want):
    return int(sum((g.numpy().astype(np.int64) != _np(w).astype(np.int64)) for g, w
                   in zip(got, want)).astype(bool).sum())


@pytest.mark.parametrize("name", list(SCENES))
def test_sweep_matches_jax_xla_sweep(name):
    torch.set_num_threads(1)
    jp, pkt = SCENES[name][0]().build_packet(), SCENES[name][1]().build_packet(device="cpu")
    wt = _world(jp)
    jwt = tuple(jnp.asarray(w.numpy()) for w in wt)
    for o, d in _rays(pkt):
        got = intersect.sweep(o, d, pkt, wt, K.t_min, K.t_max, K.det_eps)
        want = jint.sweep(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jp, jwt,
                          K.t_min, K.t_max, K.det_eps)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        flips = _flips(got, want)
        assert flips <= 1e-3 * o.shape[0], flips
        assert bool(got[1].any()) and bool(got[3].any())


def test_sweep_matches_tpu_kernel_in_interpret_mode():
    jp, pkt = SCENES["demo"][0]().build_packet(), SCENES["demo"][1]().build_packet(device="cpu")
    wt = _world(jp)
    o, d = _rays(pkt)[0]
    o, d = o[:384], d[:384]
    got = intersect.sweep(o, d, pkt, wt, K.t_min, K.t_max, K.det_eps)
    want = jik.sweep(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jp,
                     tuple(jnp.asarray(w.numpy()) for w in wt), K.t_min, K.t_max, K.det_eps,
                     interpret=True)
    assert _flips(got, want) == 0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no C++ compiler (g++) to build csrc/host_sweep.cpp")
    out = str(tmp_path_factory.mktemp("host") / "libptre_host_sweep.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-o",
                    out, os.path.join(build.CSRC_DIR, "host_sweep.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.ptre_sweep_host.restype = None
    lib.ptre_sweep_host.argtypes = [ctypes.c_void_p] * 9
    return lib


def _host_sweep(lib, o, d, scene, active=None):
    R = o.shape[0]
    out = torch.full((4, R), -7, dtype=torch.int32)
    p = sk.sweep_params(scene, R, K.t_min, K.t_max, K.det_eps)
    lib.ptre_sweep_host(ctypes.addressof(p), o.contiguous().data_ptr(),
                        d.contiguous().data_ptr(),
                        None if active is None else active.contiguous().data_ptr(),
                        scene.rows.data_ptr(), scene.cull_boxes.data_ptr(),
                        scene.super_boxes.data_ptr(), scene.sphs.data_ptr(), out.data_ptr())
    return out[0], out[1].bool(), out[2], out[3].bool()


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name", list(SCENES))
def test_host_build_of_sweep_body_equals_plain_sweep(host_lib, name):
    torch.set_num_threads(1)
    pkt = SCENES[name][1]().build_packet(device="cpu")
    wt = pkt.world_triangles()
    scene = sk.prepare(pkt)
    assert scene.rows.shape == (scene.n_leaf * 64, 12)
    for o, d in _rays(pkt, seed=1):
        want = intersect.sweep(o, d, pkt, wt, K.t_min, K.t_max, K.det_eps)
        for got in (_host_sweep(host_lib, o, d, scene),
                    sk.sweep_packed(o, d, scene, K.t_min, K.t_max, K.det_eps)):
            _assert_equal(got, want)


@pytest.mark.parametrize("name", list(SCENES))
def test_compact_rows_equal_the_packet_rows_edges(name):
    # prepare_scene's compact rows carry the bits of the sweep's former
    # packing, [v0, v1 - v0, v2 - v0, valid] of the packet's rows (one
    # float32 subtraction each), in Morton order, and perm_tri maps a Morton
    # row back to its packet row, also stored in the row (column 10)
    pkt = SCENES[name][1]().build_packet(device="cpu")
    v0, v1, v2 = pkt.world_triangles()[:3]
    old = torch.cat([v0, v1 - v0, v2 - v0, pkt.tri_valid.float()[:, None]], dim=1)
    scene = sk.prepare(pkt)
    T = scene.tri_rows
    assert T == old.shape[0] and sorted(scene.perm_tri.tolist()) == list(range(T))
    assert torch.equal(scene.rows[:T, :10], old[scene.perm_tri])
    assert torch.equal(scene.rows.view(torch.int32)[:T, 10].long(), scene.perm_tri)
    assert torch.equal(sk.packet_rows(scene)[:, :10], old)
    assert not bool((scene.rows[T:, 9] > 0.5).any())  # padding rows are invalid


def test_sweep_of_empty_tables_misses_with_index_zero(host_lib):
    pkt = Scene().build_packet(device="cpu")  # padding rows only: nothing valid
    o = torch.zeros((5, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(5, 3).contiguous()
    scene = sk.prepare(pkt)
    # and no triangle or sphere row at all (T = 0)
    empty = dataclasses.replace(scene, n_leaf=0, tri_rows=0, perm_tri=scene.perm_tri[:0],
                                sphs=scene.sphs[:0].contiguous(), n_sph=0)
    for sc in (scene, empty):
        for got in (_host_sweep(host_lib, o, d, sc),
                    sk.sweep_packed_reference(o, d, sc, K.t_min, K.t_max, K.det_eps)):
            assert [int(g.long().abs().sum()) for g in got] == [0, 0, 0, 0]


def test_every_copy_of_the_sweep_agrees_on_one_scene(host_lib):
    # the plain sweep, the kernel body's host build, and the dense bounce
    # loop's sweep (trace_block, the plain version of trace.cuh trace_path)
    torch.set_num_threads(1)
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    assert mk.dense_supported(pkt)
    scene = mk.pack_scene(pkt)
    wt = pkt.world_triangles()
    T = scene.tri_rows
    for o, d in _rays(pkt, seed=2):
        i_tri, hit_tri, i_sph, hit_sph = intersect.sweep(o, d, pkt, wt, K.t_min, K.t_max,
                                                          K.det_eps)
        unified = torch.where(hit_sph, T + i_sph, torch.where(hit_tri, i_tri, -1))
        _, sel = mk.trace_record_reference(o.contiguous(), d.contiguous(), scene, K, 1,
                                           seed=4)
        assert torch.equal(sel[0], unified.to(torch.int32))
        host = _host_sweep(host_lib, o, d, sk.prepare(pkt))
        assert all(torch.equal(a, b) for a, b in zip(host, (i_tri, hit_tri, i_sph, hit_sph)))
        assert bool((unified >= T).any()) and bool(((unified >= 0) & (unified < T)).any())


# ---- the culled sweep on adversarial geometry ----------------------------------------
# The kernel culls by boxes; the plain version does not. A box that culled a
# row the triangle test accepts would change a selection, so the host build
# of the kernel's walk is held EQUAL to the brute force on the cases where
# the slab test and Moller-Trumbore round apart: flat axis-aligned leaves
# (zero-thickness boxes), rays with zero direction components (slab_inv's
# 1e-12 path), origins inside boxes, hits on edges and vertices that
# triangles share, duplicate triangles spread over two leaves (exact t ties,
# the lowest packet row wins), invalid rows, T not a multiple of 64, T = 0,
# and dead rays.


def _stand_in_packet(v0, v1, v2, valid, center, radius):
    """The fields `wavefront.prepare_scene` and the plain sweep read, for
    world-space triangles given as they are (no model transforms)."""
    T, S = v0.shape[0], center.shape[0]
    n = torch.zeros((T, 3))
    n[:, 1] = 1.0
    return types.SimpleNamespace(
        world_triangles=lambda: (v0, v1, v2, n, n, n), device=torch.device("cpu"),
        tri_valid=valid, tri_mat=torch.zeros(T, dtype=torch.int32), sph_center=center,
        sph_radius=radius, sph_valid=torch.ones(S, dtype=torch.bool),
        sph_mat=torch.zeros(S, dtype=torch.int32), mat_kind=torch.zeros(1, dtype=torch.int32),
        mat_albedo=torch.full((1, 3), 0.5), mat_param=torch.zeros(1), sky_bottom=torch.ones(3),
        sky_top=torch.ones(3), num_materials=1)


def _adversarial_scene(rs):
    """A flat floor (y = 0) and a flat wall (x = 2.5) of unit-grid cells,
    two triangles each, sharing edges and vertices; 70 copies of one tilted
    triangle (equal centroids: Morton-adjacent, over two leaves); rows made
    invalid, one of them in front of everything. 395 rows."""
    tris = []
    for i in range(12):
        for j in range(12):
            x0, z0 = -3.0 + 0.5 * i, -3.0 + 0.5 * j
            a, b = (x0, 0.0, z0), (x0 + 0.5, 0.0, z0)
            c, e = (x0 + 0.5, 0.0, z0 + 0.5), (x0, 0.0, z0 + 0.5)
            tris += [(a, b, c), (a, c, e)]
    for i in range(4):
        for j in range(4):
            y0, z0 = 0.25 * i, -0.5 + 0.25 * j
            a, b = (2.5, y0, z0), (2.5, y0 + 0.25, z0)
            c, e = (2.5, y0 + 0.25, z0 + 0.25), (2.5, y0, z0 + 0.25)
            tris += [(a, b, c), (a, c, e)]
    tris += [((-0.5, 0.5, -0.25), (0.5, 0.75, -0.25), (0.0, 0.625, 0.5))] * 70
    tris += [((-9.0, 3.0, -9.0), (9.0, 3.0, -9.0), (0.0, 3.0, 9.0))]  # made invalid
    tris += [tuple(tuple(rs.uniform(-2, 2, 3)) for _ in range(3)) for _ in range(4)]
    v = torch.tensor(np.asarray(tris, np.float32))
    valid = torch.ones(v.shape[0], dtype=torch.bool)
    valid[-5:-2] = False  # the big one, two random ones
    valid[7] = False  # a floor triangle: its rays fall through to the one below none
    return _stand_in_packet(v[:, 0].contiguous(), v[:, 1].contiguous(), v[:, 2].contiguous(),
                            valid, torch.tensor([[0.0, 0.5, -1.0], [1.0, 0.25, 1.0]]),
                            torch.tensor([0.3, 0.2]))


def _adversarial_rays(rs):
    """(o, d): straight down onto grid vertices, edge midpoints and cell
    centres (two zero direction components); along +x onto the wall's grid;
    grazing the floor; from inside the floor's and the copies' boxes; random."""
    g = np.arange(-3.0, 3.01, 0.25, dtype=np.float32)
    xs, zs = np.meshgrid(g, g)
    down_o = np.stack([xs.ravel(), np.full(xs.size, 1.0, np.float32), zs.ravel()], 1)
    down_d = np.tile(np.float32([0.0, -1.0, 0.0]), (xs.size, 1))
    gy, gz = np.meshgrid(np.arange(0.0, 1.01, 0.125, dtype=np.float32),
                         np.arange(-0.5, 0.51, 0.125, dtype=np.float32))
    side_o = np.stack([np.full(gy.size, -3.0, np.float32), gy.ravel(), gz.ravel()], 1)
    side_d = np.tile(np.float32([1.0, 0.0, 0.0]), (gy.size, 1))
    n = 256
    graze_o = np.stack([np.full(n, -4.0), rs.uniform(1e-7, 1e-5, n), rs.uniform(-3, 3, n)], 1)
    graze_d = np.stack([np.ones(n), -rs.uniform(0, 1e-5, n), rs.uniform(-1e-3, 1e-3, n)], 1)
    inside_o = np.concatenate([
        np.stack([rs.uniform(-3, 3, n), np.full(n, 1e-7), rs.uniform(-3, 3, n)], 1),
        np.stack([rs.uniform(-0.4, 0.4, n), rs.uniform(0.5, 0.75, n),
                  rs.uniform(-0.25, 0.5, n)], 1)])
    inside_d = rs.normal(size=(2 * n, 3))
    tie_o = np.stack([rs.uniform(-0.2, 0.2, n), np.full(n, 3.0), rs.uniform(-0.1, 0.3, n)], 1)
    tie_d = np.stack([rs.uniform(-0.05, 0.05, n), -np.ones(n), rs.uniform(-0.05, 0.05, n)], 1)
    rand_o = rs.uniform(-3, 3, (n, 3))
    rand_d = rs.normal(size=(n, 3))
    o = np.concatenate([down_o, side_o, graze_o, inside_o, tie_o, rand_o]).astype(np.float32)
    d = np.concatenate([down_d, side_d, graze_d, inside_d, tie_d, rand_d])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _brute_force(o, d, pkt):
    v0, v1, v2 = pkt.world_triangles()[:3]
    return intersect.sweep_edges(o, d, v0, v1 - v0, v2 - v0, pkt.tri_valid, pkt.sph_center,
                                 pkt.sph_radius, pkt.sph_valid, K.t_min, K.t_max, K.det_eps)


def test_culled_sweep_equals_brute_force_on_adversarial_geometry(host_lib):
    rs = np.random.default_rng(11)
    pkt = _adversarial_scene(rs)
    scene = sk.prepare(pkt)
    T = pkt.tri_valid.shape[0]
    assert T == 395 and scene.n_leaf == 7 and scene.rows.shape[0] == 448
    flat = scene.boxes[:, 0:3] == scene.boxes[:, 3:6]
    assert bool(flat.any(dim=1).any())  # zero-thickness leaves
    o, d = _adversarial_rays(rs)
    assert bool((d == 0).any())
    want = _brute_force(o, d, pkt)
    got = _host_sweep(host_lib, o, d, scene)
    _assert_equal(got, want)
    _assert_equal(sk.sweep_packed(o, d, scene, K.t_min, K.t_max, K.det_eps), want)
    i_tri, hit_tri, _, hit_sph = want
    copies = hit_tri & (i_tri >= 320) & (i_tri < 390)
    assert int(copies.sum()) > 100 and bool((i_tri[copies] == 320).all())  # ties: row 320
    morton_row = torch.empty(T, dtype=torch.int64)
    morton_row[scene.perm_tri] = torch.arange(T)
    assert len(set((morton_row[320:390] // 64).tolist())) >= 2  # copies over two leaves
    assert int((hit_tri & (i_tri < 288)).sum()) > 100 and int(hit_sph.sum()) > 0
    assert not bool((hit_tri & (i_tri == 7)).any()) and not bool((i_tri == 390).any())
    # dead rays: not swept, selections (0, False, 0, False)
    active = torch.from_numpy(rs.random(o.shape[0]) < 0.7)
    got = _host_sweep(host_lib, o, d, scene, active.to(torch.uint8))
    masked = sk.sweep_packed_reference(o, d, scene, K.t_min, K.t_max, K.det_eps, active)
    _assert_equal(got, masked)
    for g, w in zip(got, want):
        assert torch.equal(g[active], w[active]) and not bool(g[~active].any())


def test_gather_rows_sums_its_backward_in_float64():
    # a training step's gather: a million winners on a few rows under a
    # one-sign cotangent (an MSE against a zero target). Summed in float32,
    # a hot row's million terms drift ~1e-5 from the exact sum; the gather's
    # backward sums in float64 and rounds once to float32: each entry within
    # 2^-23 of the float64 sum, relative
    rs = np.random.default_rng(6)
    n = 1_000_000
    idx = torch.from_numpy(rs.integers(0, 3, n)) + 2  # rows 2-4 of 6
    table = torch.from_numpy(rs.random((6, 4), dtype=np.float32)).requires_grad_(True)
    cot = torch.from_numpy(rs.random((n, 4), dtype=np.float32))
    exact = torch.zeros((6, 4), dtype=torch.float64).index_add_(0, idx, cot.double())
    (got,) = torch.autograd.grad(take_rows(table, idx), table, cot)
    assert got.dtype == torch.float32
    rel = ((got.double() - exact).abs() / exact.abs().clamp_min(1e-300))[2:5]
    assert float(rel.max()) <= 2.0 ** -23, float(rel.max())
    assert not bool(got[[0, 1, 5]].any())


def _aimed_batch(n=64, seed=3):
    """Rays aimed at a triangle or a sphere of their own (and some past
    them), with the triangles' and spheres' data per ray."""
    rs = np.random.default_rng(seed)
    v0, v1, v2 = (rs.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    nrm = [rs.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    nrm = [x / np.linalg.norm(x, axis=1, keepdims=True) for x in nrm]
    bary = rs.dirichlet((1, 1, 1), size=n).astype(np.float32)
    target = bary[:, :1] * v0 + bary[:, 1:2] * v1 + bary[:, 2:] * v2
    o = (target + 4.0 * rs.normal(size=(n, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    center = (o + d * rs.uniform(2, 6, (n, 1)) + 0.3 * rs.normal(size=(n, 3))).astype(np.float32)
    radius = rs.uniform(0.3, 1.5, n).astype(np.float32)
    inside = rs.random(n) < 0.25  # some origins inside their sphere: far root
    o[inside] = center[inside]
    return dict(o=o, d=d, v0=v0, v1=v1, v2=v2, n0=nrm[0], n1=nrm[1], n2=nrm[2],
                center=center, radius=radius)


def test_hit_attrs_values_and_gradients_match_jax():
    b = _aimed_batch()
    rs = np.random.default_rng(4)
    w = [rs.normal(size=s).astype(np.float32) for s in ((64,), (64, 3), (64, 3))]

    def loss_j(t, p, n):
        return jnp.sum(t * w[0]) + jnp.sum(p * w[1]) + jnp.sum(n * w[2])

    def loss_t(t, p, n):
        return (torch.sum(t * torch.from_numpy(w[0])) + torch.sum(p * torch.from_numpy(w[1]))
                + torch.sum(n * torch.from_numpy(w[2])))

    tri_keys = ("o", "d", "v0", "v1", "v2", "n0", "n1", "n2")
    sph_keys = ("o", "d", "center", "radius")
    for keys, jfn, tfn in (
            (tri_keys, jint.triangle_hit_attrs_t, intersect.triangle_hit_attrs_t),
            (sph_keys, lambda *a: jint.sphere_hit_attrs_t(*a, K.t_min),
             lambda *a: intersect.sphere_hit_attrs_t(*a, K.t_min))):
        jargs = [jnp.asarray(b[k]) for k in keys]
        targs = [torch.from_numpy(b[k]).requires_grad_(True) for k in keys]
        jout = jfn(*jargs)
        tout = tfn(*targs)
        for a, c in zip(jout[:3], tout[:3]):
            np.testing.assert_allclose(c.detach().numpy(), _np(a), rtol=1e-5, atol=1e-6)
        assert np.array_equal(tout[3].numpy(), _np(jout[3]))
        jg = jax.grad(lambda *a: loss_j(*jfn(*a)[:3]), argnums=tuple(range(len(keys))))(*jargs)
        tg = torch.autograd.grad(loss_t(*tout[:3]), targs)
        for k, a, c in zip(keys, jg, tg):
            np.testing.assert_allclose(c.numpy(), _np(a), rtol=1e-4,
                                       atol=1e-4 * float(np.abs(_np(a)).max()), err_msg=k)
    p, n, front = intersect.triangle_hit_attrs(*(torch.from_numpy(b[k]) for k in tri_keys[:2]),
                                               torch.ones(64), *(torch.from_numpy(b[k])
                                                                 for k in tri_keys[2:]))
    jp_, jn, jf = jint.triangle_hit_attrs(*(jnp.asarray(b[k]) for k in tri_keys[:2]),
                                          jnp.ones(64), *(jnp.asarray(b[k]) for k in tri_keys[2:]))
    np.testing.assert_allclose(n.numpy(), _np(jn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), _np(jp_), rtol=1e-6, atol=1e-6)
    ts = torch.from_numpy(np.abs(b["radius"]) + 1.0)
    sp = intersect.sphere_hit_attrs(torch.from_numpy(b["o"]), torch.from_numpy(b["d"]), ts,
                                    torch.from_numpy(b["center"]), torch.from_numpy(b["radius"]))
    jsp = jint.sphere_hit_attrs(jnp.asarray(b["o"]), jnp.asarray(b["d"]), jnp.asarray(ts.numpy()),
                                jnp.asarray(b["center"]), jnp.asarray(b["radius"]))
    for a, c in zip(jsp, sp):
        np.testing.assert_allclose(c.numpy(), _np(a), rtol=1e-5, atol=1e-6)


def test_intersect_primitives_match_jax():
    jp = jdemo.config4_mixed_scene(12, 6).build_packet()
    pkt = demo.config4_mixed_scene(12, 6).build_packet(device="cpu")
    wt = _world(jp)
    (o, d), (o1, d1) = _rays(pkt, seed=5)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    tv = pkt.tri_valid
    args = (K.t_min, K.t_max)
    for got, want in (
            (intersect.intersect_triangles(o, d, *wt[:3], tv, *args),
             jint.intersect_triangles(jo, jd, *(jnp.asarray(w.numpy()) for w in wt[:3]),
                                      jnp.asarray(tv.numpy()), *args)),
            (intersect.intersect_spheres(o, d, pkt.sph_center, pkt.sph_radius, pkt.sph_valid,
                                         *args),
             jint.intersect_spheres(jo, jd, jp.sph_center, jp.sph_radius, jp.sph_valid, *args)),
            (intersect.intersect_triangles_plane_edges(o, d, *wt[:3], tv, *args),
             jint.intersect_triangles_plane_edges(jo, jd, *(jnp.asarray(w.numpy())
                                                           for w in wt[:3]),
                                                  jnp.asarray(tv.numpy()), *args))):
        # 1e-4: |oc|^2 - r^2 of the r = 10 ground cancels (ROADMAP C2), and
        # XLA's FMA rounds it differently (3.4e-5 measured on one ray)
        np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-4)
        assert _flips(got[1:], want[1:]) <= 1e-3 * o.shape[0]
        assert bool(got[2].any())
    # the plane/edge test and Moller-Trumbore pick the same triangles
    mt = intersect.intersect_triangles(o, d, *wt[:3], tv, *args)
    pe = intersect.intersect_triangles_plane_edges(o, d, *wt[:3], tv, *args)
    assert float((mt[1] == pe[1]).float().mean()) > 0.99
    assert torch.equal(mt[2], pe[2]) or float((mt[2] == pe[2]).float().mean()) > 0.99


def test_closest_hit_values_and_gradients_match_jax():
    jp = jdemo.config4_mixed_scene(12, 6).build_packet()
    pkt = demo.config4_mixed_scene(12, 6).build_packet(device="cpu")
    o, d = _rays(pkt, seed=6)[1]
    rs = np.random.default_rng(7)
    w = rs.normal(size=(o.shape[0], 3)).astype(np.float32)

    def jloss(wt, center, radius):
        jpk = jp.replace(sph_center=center, sph_radius=radius)
        h = jint.closest_hit(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jpk, wt,
                             K.t_min, K.t_max, K.det_eps)
        return jnp.sum(h.position * w) + jnp.sum(h.normal * w[:, ::-1]) + jnp.sum(
            jnp.where(h.hit, h.t, 0.0)), h

    jwt = tuple(jnp.asarray(x) for x in jp.world_triangles())
    (jl, jh), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jwt, jp.sph_center, jp.sph_radius)
    wt = tuple(torch.from_numpy(_np(x).copy()).requires_grad_(True) for x in jwt)
    center = pkt.sph_center.clone().requires_grad_(True)
    radius = pkt.sph_radius.clone().requires_grad_(True)
    tp = dataclasses.replace(pkt, sph_center=center, sph_radius=radius)
    h = intersect.closest_hit(o, d, tp, wt, K.t_min, K.t_max, K.det_eps)
    assert np.array_equal(h.hit.numpy(), _np(jh.hit))
    assert np.array_equal(h.mat_id.numpy(), _np(jh.mat_id).astype(np.int64))
    assert np.array_equal(h.front_face.numpy(), _np(jh.front_face))
    np.testing.assert_allclose(h.position.detach().numpy(), _np(jh.position), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.normal.detach().numpy(), _np(jh.normal), rtol=1e-5, atol=1e-5)
    loss = (torch.sum(h.position * torch.from_numpy(w))
            + torch.sum(h.normal * torch.from_numpy(w[:, ::-1].copy()))
            + torch.sum(torch.where(h.hit, h.t, torch.zeros_like(h.t))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(loss, list(wt) + [center, radius])
    jflat = list(jg[0]) + [jg[1], jg[2]]
    # summed over rays, each leaf within 2e-3 relative L2 (measured <= 6.8e-4,
    # v1: grazing rays reach the gradsafe floors of 1/det, whose gradient
    # amplifies the rounding differences to |d v1| ~ 1e5)
    for a, c in zip(jflat, tg):
        a = _np(a)
        assert np.linalg.norm(c.numpy() - a) <= 2e-3 * np.linalg.norm(a)
