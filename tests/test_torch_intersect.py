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
    cam = cam_ops.Camera.create(width=W, height=H)
    px, py = pt.pixel_grid(H, W)
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
    lib.ptre_sweep_host.argtypes = [ctypes.c_void_p] * 6
    return lib


def _host_sweep(lib, o, d, tables):
    R = o.shape[0]
    out = torch.full((4, R), -7, dtype=torch.int32)
    p = sk.SweepParams(K.t_min, K.t_max, K.det_eps, R, tables.tris.shape[0],
                       tables.sphs.shape[0])
    lib.ptre_sweep_host(ctypes.addressof(p), o.contiguous().data_ptr(),
                        d.contiguous().data_ptr(), tables.tris.data_ptr(),
                        tables.sphs.data_ptr(), out.data_ptr())
    return out[0], out[1].bool(), out[2], out[3].bool()


@pytest.mark.parametrize("name", list(SCENES))
def test_host_build_of_sweep_body_equals_plain_sweep(host_lib, name):
    torch.set_num_threads(1)
    pkt = SCENES[name][1]().build_packet(device="cpu")
    wt = pkt.world_triangles()
    tables = sk.prepare(pkt, wt)
    assert tables.tris.shape[1] == sk.TRI_COLS and tables.sphs.shape[1] == sk.SPH_COLS
    for o, d in _rays(pkt, seed=1):
        want = intersect.sweep(o, d, pkt, wt, K.t_min, K.t_max, K.det_eps)
        for got in (_host_sweep(host_lib, o, d, tables),
                    sk.sweep_packed(o, d, tables, K.t_min, K.t_max, K.det_eps)):
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_sweep_of_empty_tables_misses_with_index_zero(host_lib):
    pkt = Scene().build_packet(device="cpu")  # padding rows only: nothing valid
    o = torch.zeros((5, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(5, 3).contiguous()
    tables = sk.prepare(pkt, pkt.world_triangles())
    empty = sk.SweepTables(tables.tris[:0].contiguous(), tables.sphs[:0].contiguous())
    for tabs in (tables, empty):
        for got in (_host_sweep(host_lib, o, d, tabs),
                    sk.sweep_packed_reference(o, d, tabs, K.t_min, K.t_max, K.det_eps)):
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
        host = _host_sweep(host_lib, o, d, sk.prepare(pkt, wt))
        assert all(torch.equal(a, b) for a, b in zip(host, (i_tri, hit_tri, i_sph, hit_sph)))
        assert bool((unified >= T).any()) and bool(((unified >= 0) & (unified < T)).any())


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
