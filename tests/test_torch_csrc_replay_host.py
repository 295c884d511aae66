"""The replay kernels' per-ray bodies, checked on the CPU.

`csrc/replay.cuh` writes the replay pair's per-lane code (``replay_step``,
``replay_unstep``: one bounce of the chain over winner rows gathered outside
the kernel, and of its hand-written adjoint) ``__host__ __device__``,
templated on the scalar, so `csrc/host_replay.cpp` compiles what
`csrc/replay_kernel.cu` runs per thread with g++, in float and in double,
around an emulation of the kernel's warp (the dead-tail vote, d(g) written
as slabs). Inputs: the demo scene with a diffuse cube at 32x16, max_depth
5, the plain recording trace's selections, the rows gathered by
`path_replay.gather_rows`; uniforms external or Philox.

* Forward in float against `replay_fwd_reference` within rtol / atol 1e-5
  (cos/sin from libm vs PyTorch, as in `test_torch_csrc_grad_host.py`); in
  double against the float64 plain version within 1e-10 of the largest.
* Backward in double against autograd of the float64 plain version
  (`replay_bwd_reference`) to 1e-10 relative to each quantity's largest
  entry: both sides run the same formulas in double, so any difference is a
  bug in the adjoint or in the gathered-rows policies. In float within the
  bound the fused backward is held to (rtol 5e-4, atol 1e-5 of the largest).
* d(g) is exactly zero on every (bounce, ray) that was not live or did not
  hit, so only zeros reach the gather's backward from them.
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

from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils.config import RenderConfig

W, H, B = 32, 16, 5
R = W * H
SEED, SAMPLE = 77, 2


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no C++ compiler (g++) to build csrc/host_replay.cpp")
    out = str(tmp_path_factory.mktemp("replay_host") / "libptre_replay_host.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror",
                    "-o", out, os.path.join(build.CSRC_DIR, "host_replay.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    for name, n in (("fwd", 8), ("bwd", 13)):
        for dt in ("f", "d"):
            fn = getattr(lib, f"ptre_replay_{name}_host_{dt}")
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p] * n
    return lib


@pytest.fixture(scope="module", params=["external", "philox"])
def paths(request):
    """Recorded paths over the demo scene, its cube diffuse so that
    triangle rows get gradient too."""
    torch.set_num_threads(1)
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    pkt = dataclasses.replace(pkt, mat_kind=torch.zeros_like(pkt.mat_kind),
                              mat_param=torch.tensor([1.0, 0.4]))
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    px, py = pt.pixel_grid(H, W, device="cpu")
    jit = torch.from_numpy(np.random.default_rng(3).random((R, 2), np.float32)) - 0.5
    o, d = (t.contiguous() for t in cam_ops.get_rays(cam, px, py, jit))
    k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=B))
    urand = (torch.from_numpy(np.random.default_rng(4).random((2 + 2 * B, R), np.float32))
             if request.param == "external" else None)
    _, sel = mk.trace_record_reference(o, d, mk.pack_scene(pkt), k, B, SEED, SAMPLE, urand)
    table, T, sky6 = (x.detach() if torch.is_tensor(x) else x
                      for x in path_replay.build_table(pkt))
    dcol = torch.from_numpy(np.random.default_rng(8).normal(size=(R, 3)).astype(np.float32))
    return dict(o=o, d=d, sel=sel.contiguous(), urand=urand, table=table, T=T, sky6=sky6,
                k=k, dcol=dcol)


def _inputs(p, dtype):
    g = path_replay.gather_rows(p["table"].to(dtype), p["sel"]).contiguous()
    return (g, p["sky6"].to(dtype).contiguous(), p["o"].to(dtype).contiguous(),
            p["d"].to(dtype).contiguous(), p["dcol"].to(dtype).contiguous())


def _params(p):
    return mk.trace_params(R, p["k"], B, SEED, SAMPLE, p["urand"] is not None,
                           sph_offset=p["T"], n_rows=rpk._ANY_ROW)


def _host_fwd(lib, p, dtype):
    g, sky6, o, d, _ = _inputs(p, dtype)
    color = torch.zeros((R, 3), dtype=dtype)
    params = _params(p)
    fn = lib.ptre_replay_fwd_host_d if dtype == torch.float64 else lib.ptre_replay_fwd_host_f
    fn(ctypes.addressof(params), g.data_ptr(), sky6.data_ptr(), o.data_ptr(), d.data_ptr(),
       p["sel"].data_ptr(), None if p["urand"] is None else p["urand"].data_ptr(),
       color.data_ptr())
    return color


def _host_bwd(lib, p, dtype):
    g, sky6, o, d, dcol = _inputs(p, dtype)
    out = [torch.zeros_like(o), torch.zeros_like(d), torch.full_like(g, 7.0),
           torch.zeros(6, dtype=dtype)]
    params = _params(p)
    fn = lib.ptre_replay_bwd_host_d if dtype == torch.float64 else lib.ptre_replay_bwd_host_f
    fn(ctypes.addressof(params), g.data_ptr(), sky6.data_ptr(), o.data_ptr(), d.data_ptr(),
       p["sel"].data_ptr(), None if p["urand"] is None else p["urand"].data_ptr(),
       dcol.data_ptr(), *(x.data_ptr() for x in out), None)
    return out


def _reference(p, dtype, which):
    g, sky6, o, d, dcol = _inputs(p, dtype)
    args = (p["sel"], sky6)
    if which == "fwd":
        return rpk.replay_fwd_reference(o, d, g, *args, p["T"], p["k"], B, SEED, SAMPLE,
                                        p["urand"])
    return rpk.replay_bwd_reference(o, d, g, *args, dcol, p["T"], p["k"], B, SEED, SAMPLE,
                                    p["urand"])


def _assert_close(name, got, want, rtol, atol_rel):
    scale = float(want.abs().max())
    assert scale > 0 and bool(torch.isfinite(got).all()), name
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol_rel * scale,
                               err_msg=name)


def test_host_forward_matches_plain_version(lib, paths):
    _assert_close("colour", _host_fwd(lib, paths, torch.float32),
                  _reference(paths, torch.float32, "fwd"), 1e-5, 1e-5)
    _assert_close("colour f64", _host_fwd(lib, paths, torch.float64),
                  _reference(paths, torch.float64, "fwd"), 1e-10, 1e-10)
    sel = paths["sel"]
    assert (sel >= paths["T"]).any() and ((sel >= 0) & (sel < paths["T"])).any()
    assert (sel == -1).any()


def test_host_backward_equals_autograd_in_double(lib, paths):
    got = _host_bwd(lib, paths, torch.float64)
    want = _reference(paths, torch.float64, "bwd")
    for name, a, b in zip(("d(o)", "d(d)", "d(g)", "d(sky)"), got, want):
        _assert_close(name, a, b, 1e-10, 1e-10)
    # triangle rows (the diffuse cube) and sphere rows both get gradient
    dg, sel = got[2], paths["sel"]
    tri = (sel >= 0) & (sel < paths["T"])
    assert float(dg[tri][:, :9].abs().max()) > 0 and float(dg[sel >= paths["T"]][:, 18:22]
                                                            .abs().max()) > 0


def test_host_backward_in_float_within_fused_backward_bound(lib, paths):
    got = _host_bwd(lib, paths, torch.float32)
    want = _reference(paths, torch.float32, "bwd")
    for name, a, b in zip(("d(o)", "d(d)", "d(g)", "d(sky)"), got, want):
        _assert_close(name, a, b, 5e-4, 1e-5)


def test_host_backward_writes_zero_rows_where_nothing_was_hit(lib, paths):
    dg = _host_bwd(lib, paths, torch.float32)[2]
    miss = paths["sel"] < 0
    assert bool(miss.any()) and bool((dg[miss] == 0).all())  # the 7.0 fill is overwritten
    # and the gather's backward then sums them into d(table) as autograd does
    table = paths["table"].clone().requires_grad_(True)
    g = path_replay.gather_rows(table, paths["sel"])
    (dtable,) = torch.autograd.grad(g, table, dg)
    want = torch.zeros_like(table).index_add_(
        0, paths["sel"][~miss].long(), dg[~miss])
    np.testing.assert_allclose(dtable.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
