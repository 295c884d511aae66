"""The gradient kernels' math, checked on the CPU.

`csrc/replay.cuh` (the replay chain's bounce and its hand-written adjoint,
the fused backward of one ray) and `csrc/trace.cuh` (the recording trace)
are written ``__host__ __device__`` behind a macro, so `csrc/host_grad.cpp`
compiles them with g++.

* In double, the hand adjoint must equal torch autograd of the plain chain
  (`ops/cuda/replay_kernel.chain_bounce`) in float64 to 1e-10 relative to
  each quantity's largest entry, over rays that hit triangles and spheres,
  miss, hit emitters, are dead, take the degenerate-pdf fallback and sit on
  the clip ties. At that bound any difference is a bug in the adjoint, not
  float noise: both sides run the same formulas in double.
* In float, the same within the bound the fused backward is held to
  (`test_fused_grad.py`: rtol 5e-4, atol 1e-5 of the largest entry): the
  two sides round in other places.
* The host recorder's selections equal the plain ``trace_block(record=True)``
  exactly, and its color matches to 1e-5 (cos/sin from libm vs PyTorch, as
  in `test_torch_csrc_host.py`).
* The host fused backward of whole paths, as fused_grad_kernel.cu runs it
  (saved states in a [bounce][field][thread] slice, the table in place or
  padded to 28 columns), matches `fused_bwd_reference` at max_depth 1, 2, 5
  and 8.
* The kernel's row-grouped accumulation, replayed warp by warp, matches a
  float64 `index_add_` of the same cotangents.
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
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import build, fused_grad
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
from ptre_tpu_torch.ops.gradsafe import f32
from ptre_tpu_torch.render import pathtracer as pt

N_RAYS = 600


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no C++ compiler (g++) to build csrc/host_grad.cpp")
    out = str(tmp_path_factory.mktemp("grad_host") / "libptre_grad_host.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-o", out,
                    os.path.join(build.CSRC_DIR, "host_grad.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    for name in ("ptre_chain_host_f", "ptre_chain_host_d"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 22
    lib.ptre_trace_record_host.restype = None
    lib.ptre_trace_record_host.argtypes = [ctypes.c_void_p] * 12
    lib.ptre_fused_bwd_host.restype = None
    lib.ptre_fused_bwd_host.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int]
    lib.ptre_grouped_rows_host.restype = None
    lib.ptre_grouped_rows_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _bounce_batch(seed: int, n: int = N_RAYS):
    """Per-ray inputs of one bounce: rays aimed at a triangle or a sphere of
    their own, with every branch of the chain represented."""
    rs = np.random.default_rng(seed)
    g = np.zeros((n, 27))
    use_sph = rs.random(n) < 0.5
    o = rs.uniform(-1.0, 1.0, (n, 3))
    o[:, 2] -= 4.0
    target = rs.uniform(-0.8, 0.8, (n, 3))
    # triangles around the target, smooth normals near the face normal
    v0 = target + rs.uniform(-1.0, 1.0, (n, 3))
    v1 = target + rs.uniform(-1.0, 1.0, (n, 3))
    v2 = 3.0 * target - v0 - v1
    face = _unit(np.cross(v1 - v0, v2 - v0))
    g[:, 0:3], g[:, 3:6], g[:, 6:9] = v0, v1, v2
    for k in range(3):
        g[:, 9 + 3 * k:12 + 3 * k] = _unit(face + 0.3 * rs.normal(size=(n, 3)))
    # spheres: the target is their center
    radius = rs.uniform(0.3, 1.5, n)
    g[:, 18:21] = np.where(use_sph[:, None], target, 0.0)
    g[:, 21] = np.where(use_sph, radius, 0.0)
    g[~use_sph, 18:22] = 0.0
    g[use_sph, 0:18] = 0.0
    aim = np.where(use_sph[:, None], target + 0.7 * radius[:, None] *
                   rs.uniform(-1.0, 1.0, (n, 3)), target)
    d = _unit(aim - o)
    # materials: emitters, and roughness on clip's ties, inside and beyond
    g[:, 22] = (rs.random(n) < 0.15).astype(np.float64)
    g[:, 23:26] = rs.uniform(0.1, 1.0, (n, 3))
    g[:, 26] = rs.choice([0.0, 1.0, 0.3, 0.7, 1.5, 12.0], n)
    u = rs.random((n, 2))
    u[rs.random(n) < 0.1, 1] = 1.0  # lz = 0: the degenerate-pdf fallback
    hit = rs.random(n) < 0.9
    active = rs.random(n) < 0.9
    c = rs.uniform(0.2, 1.0, (n, 3))
    sky = rs.uniform(0.2, 1.0, 6)
    cot = rs.normal(size=(3, n, 3))
    return dict(o=o, d=d, c=c, active=active, g=g, use_sph=use_sph, hit=hit,
                u=u, sky=sky, go=cot[0], gd=cot[1], gc=cot[2])


CONSTS = (f32(1e-6), f32(1e-4), f32(1e-5))  # t_min, shadow_eps, pdf_eps


class _Consts:
    t_min, shadow_eps, pdf_eps = CONSTS


def _host_chain(lib, b, dtype):
    n = b["o"].shape[0]
    npdt = np.float64 if dtype == torch.float64 else np.float32
    ins = {k: np.ascontiguousarray(b[k], dtype=npdt)
           for k in ("o", "d", "c", "g", "u", "sky", "go", "gd", "gc")}
    flags = {k: np.ascontiguousarray(b[k], dtype=np.int32)
             for k in ("active", "use_sph", "hit")}
    consts = np.asarray(CONSTS, dtype=npdt)
    out = {k: np.zeros((n, w), npdt) for k, w in
           (("o2", 3), ("d2", 3), ("c2", 3), ("dO", 3), ("dD", 3), ("dC", 3),
            ("dg", 27), ("dsky", 6))}
    nxt = np.zeros(n, np.int32)
    fn = lib.ptre_chain_host_d if dtype == torch.float64 else lib.ptre_chain_host_f

    def p(a):
        return a.ctypes.data

    fn(n, p(ins["o"]), p(ins["d"]), p(ins["c"]), p(flags["active"]), p(ins["g"]),
       p(flags["use_sph"]), p(flags["hit"]), p(ins["u"]), p(ins["sky"]),
       p(consts), p(ins["go"]), p(ins["gd"]), p(ins["gc"]), p(out["o2"]),
       p(out["d2"]), p(out["c2"]), p(nxt), p(out["dO"]), p(out["dD"]),
       p(out["dC"]), p(out["dg"]), p(out["dsky"]))
    out["next"] = nxt.astype(bool)
    return out


def _autograd_chain(b, dtype):
    def t(k, grad=False):
        return torch.tensor(b[k], dtype=dtype, requires_grad=grad)

    o, d, c, g = t("o", True), t("d", True), t("c", True), t("g", True)
    n = o.shape[0]
    sky = torch.tensor(np.broadcast_to(b["sky"], (n, 6)).copy(), dtype=dtype,
                       requires_grad=True)
    u = t("u")
    o2, d2, c2, nxt = rpk.chain_bounce(
        o.unbind(1), d.unbind(1), c.unbind(1), torch.tensor(b["active"]),
        g.unbind(1), torch.tensor(b["use_sph"]), torch.tensor(b["hit"]),
        u[:, 0], u[:, 1], sky.unbind(1), _Consts)
    o2, d2, c2 = (torch.stack(x, 1) for x in (o2, d2, c2))
    loss = ((o2 * t("go")).sum() + (d2 * t("gd")).sum() + (c2 * t("gc")).sum())
    grads = torch.autograd.grad(loss, (o, d, c, g, sky))
    out = {k: v.detach().numpy() for k, v in
           zip(("o2", "d2", "c2", "dO", "dD", "dC", "dg", "dsky"),
               (o2, d2, c2) + grads)}
    out["next"] = nxt.numpy()
    return out


def _assert_close(got, want, rtol, atol_rel):
    np.testing.assert_array_equal(got["next"], want["next"])
    for k in ("o2", "d2", "c2", "dO", "dD", "dC", "dg", "dsky"):
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=atol_rel * scale, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjoint_equals_autograd_in_double(lib, seed):
    torch.set_num_threads(1)
    b = _bounce_batch(seed)
    got = _host_chain(lib, b, torch.float64)
    want = _autograd_chain(b, torch.float64)
    _assert_close(got, want, rtol=1e-10, atol_rel=1e-10)
    # the batch reaches every branch the adjoint has
    live_hit = b["active"] & b["hit"]
    emissive = b["g"][:, 22] > 0.5
    assert (live_hit & b["use_sph"] & ~emissive).sum() > 50
    assert (live_hit & ~b["use_sph"] & ~emissive).sum() > 50
    assert (live_hit & emissive).sum() > 10 and (b["active"] & ~b["hit"]).sum() > 10
    assert (live_hit & (b["u"][:, 1] == 1.0)).sum() > 10
    # roughness on clip's upper bound gets half the gradient, as jnp.clip
    on_tie = live_hit & ~emissive & (b["g"][:, 26] == 1.0)
    assert on_tie.sum() > 10 and np.abs(got["dg"][on_tie, 26]).max() > 0


def test_adjoint_in_float_within_fused_backward_bound(lib):
    torch.set_num_threads(1)
    b = _bounce_batch(7)
    got = _host_chain(lib, b, torch.float32)
    want = _autograd_chain(b, torch.float32)
    _assert_close(got, want, rtol=5e-4, atol_rel=1e-5)


def _demo_rays(W=32, H=16, seed=3):
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    px, py = pt.pixel_grid(H, W, device="cpu")
    jit = torch.from_numpy(np.random.default_rng(seed).random((H * W, 2), np.float32)) - 0.5
    o, d = cam_ops.get_rays(cam, px, py, jit)
    return pkt, o.contiguous(), d.contiguous()


@pytest.mark.parametrize("external", [True, False])
def test_host_recorder_equals_plain_trace_block(lib, external):
    torch.set_num_threads(1)
    pkt, o, d = _demo_rays()
    cfg = RenderConfig(width=32, height=16, max_depth=5)
    scene = mk.pack_scene(pkt)
    k = mk.TraceConsts.from_config(cfg)
    R = o.shape[0]
    urand = (torch.from_numpy(np.random.default_rng(4).random((12, R), np.float32))
             if external else None)
    want_c, want_s = mk.trace_record_reference(o, d, scene, k, 5, 0xABC, 2, urand)
    params = mk.trace_params(R, k, 5, 0xABC, 2, external, scene=scene)
    color = torch.zeros((R, 3))
    sel = torch.full((5, R), 7, dtype=torch.int32)
    lib.ptre_trace_record_host(
        ctypes.addressof(params), o.data_ptr(), d.data_ptr(),
        None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
        scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr(),
        color.data_ptr(), sel.data_ptr(), None, None)
    np.testing.assert_array_equal(sel.numpy(), want_s.numpy())
    np.testing.assert_allclose(color.numpy(), want_c.numpy(), rtol=1e-5, atol=1e-5)
    assert (want_s >= scene.tri_rows).any() and ((want_s >= 0) & (want_s < 12)).any()
    assert (want_s == -1).any()


# (external uniforms, max_depth, table source): the dense instantiation's
# table read in place ("pointer") or the global one's padded to 28 columns
# ("padded"); the first two cases keep their original ids
BWD_CASES = [pytest.param(True, 5, "pointer", id="True"),
             pytest.param(False, 5, "pointer", id="False")] + [
    pytest.param(ext, depth, src, id=f"{ext}-{depth}-{src}")
    for src in ("pointer", "padded") for depth in (1, 2, 5, 8) for ext in (True, False)
    if (depth, src) != (5, "pointer")]


@pytest.mark.parametrize("external, max_depth, source", BWD_CASES)
def test_host_fused_backward_matches_reference(lib, external, max_depth, source):
    """Whole paths of a diffuse demo scene (triangle and sphere hits, misses,
    paths ended early, the emissive cube); rtol 5e-4, atol 1e-5 of each
    output's largest entry, as the float adjoint test. The padded table's
    column 27 stays 0 in d(table)."""
    torch.set_num_threads(1)
    pkt, o, d = _demo_rays(seed=5)
    # a diffuse cube too, so triangle geometry gets gradient
    pkt.mat_kind = torch.zeros_like(pkt.mat_kind)
    pkt.mat_param = torch.tensor([1.0, 0.4])
    cfg = RenderConfig(width=32, height=16, max_depth=max_depth)
    scene = mk.pack_scene(pkt)
    k = mk.TraceConsts.from_config(cfg)
    R = o.shape[0]
    B = max_depth
    urand = (torch.from_numpy(np.random.default_rng(6).random((2 + 2 * B, R), np.float32))
             if external else None)
    _, sel = mk.trace_record_reference(o, d, scene, k, B, 99, 1, urand)
    table, T, sky6 = path_replay.build_table(pkt)
    dcol = torch.from_numpy(np.random.default_rng(8).normal(size=(R, 3)).astype(np.float32))
    want = fused_grad.fused_bwd_reference(table, sky6, o, d, sel, dcol, k, B, T,
                                          99, 1, urand)
    params = mk.trace_params(R, k, B, 99, 1, external, sph_offset=T,
                             n_rows=table.shape[0])
    width = 28 if source == "padded" else 27
    tab = torch.nn.functional.pad(table.detach(), (0, width - 27)).contiguous()
    got = [torch.zeros((table.shape[0], width)), torch.zeros(6), torch.zeros_like(o),
           torch.zeros_like(d)]
    lib.ptre_fused_bwd_host(
        ctypes.addressof(params), tab.data_ptr(), sky6.contiguous().data_ptr(),
        o.data_ptr(), d.data_ptr(), sel.data_ptr(),
        None if urand is None else urand.data_ptr(), dcol.data_ptr(),
        got[2].data_ptr(), got[3].data_ptr(), got[0].data_ptr(), got[1].data_ptr(),
        int(source == "padded"))
    assert not got[0][:, 27:].any()
    got[0] = got[0][:, :27]
    for name, a, b in zip(("dtable", "dsky", "do", "dd"), got, want):
        scale = float(b.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=1e-5 * scale, err_msg=name)
    # bounces beyond the first reach the adjoint
    assert B == 1 or bool((sel[B - 1] >= 0).any()) or bool((sel[1] >= 0).any())


def _grouped_rows(rs, n, n_rows, kind):
    """Row indices of n rays: runs of one row (a warp's rays on one sphere),
    every row distinct, or a mix with misses (-1)."""
    if kind == "repeat":
        return np.repeat(rs.integers(0, n_rows, -(-n // 8)), 8)[:n]
    if kind == "distinct":
        return rs.permutation(n_rows)[:n]
    idx = np.where(rs.random(n) < 0.6, rs.integers(0, 4, n), rs.integers(0, n_rows, n))
    return np.where(rs.random(n) < 0.2, -1, idx)


@pytest.mark.parametrize("kind", ["repeat", "distinct", "mixed"])
@pytest.mark.parametrize("padded", [False, True])
def test_host_grouped_accumulation_matches_float64_index_add(lib, kind, padded):
    """fused_grad_kernel.cu's row-grouped accumulation (lanes grouped by row,
    a lane alone adding its own row, a group summed through the warp's slice
    by the kernel's own code, replay.cuh group_sum4, and added once; the
    sphere rows of the global instantiation through their own accumulator),
    replayed over warps of 32 consecutive rays with a ragged last warp,
    against float64 index_add_ of the same float32 cotangents: float32 sums
    of at most a few hundred terms, so within 1e-5 of the largest entry and
    2e-6 relative L2; rows never hit stay exactly 0."""
    rs = np.random.default_rng({"repeat": 1, "distinct": 2, "mixed": 3}[kind])
    n, n_rows, sph_offset, n_sph = 1000, 1200, 1100, 64
    idx = _grouped_rows(rs, n, n_rows, kind).astype(np.int32)
    if kind == "mixed":
        idx[::7] = sph_offset + rs.integers(0, n_sph, idx[::7].shape[0])  # sphere rows
    dg = rs.normal(size=(n, 27)).astype(np.float32)
    stride = 28 if padded else 27
    dtable = np.zeros((n_rows, stride), np.float32)
    n_acc = n_sph if padded else 0
    dsph = np.zeros((max(n_acc, 1), 27), np.float32)
    lib.ptre_grouped_rows_host(n, idx.ctypes.data, dg.ctypes.data, dtable.ctypes.data,
                               stride, sph_offset, n_acc, dsph.ctypes.data)
    got = dtable[:, :27].astype(np.float64)
    got[sph_offset:sph_offset + n_acc] += dsph[:n_acc]
    want = torch.zeros((n_rows, 27), dtype=torch.float64)
    live = idx >= 0
    want.index_add_(0, torch.from_numpy(idx[live]).long(),
                    torch.from_numpy(dg[live]).double())
    want = want.numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert np.linalg.norm(got - want) <= 2e-6 * np.linalg.norm(want)
    never = np.setdiff1d(np.arange(n_rows), idx[live])
    assert not got[never].any() and (padded is False or not dtable[:, 27].any())
    if kind == "repeat":  # groups of several lanes did occur
        assert (np.diff(idx[:32]) == 0).sum() >= 16
