"""The replay route (``grad_sweep="replay"``) of the port vs the JAX package.

One case, built once (the JAX recording kernel in interpret mode is the
cost): the demo packet with its cube made Oren-Nayar, so triangle geometry
gets gradient too, at 16x8, max_depth 3, with the JAX recording kernel's
selections and threefry uniforms (`megakernel.trace_fused_sel`, external
uniforms), which the port receives as ``urand``.

* The plain replay pair (`replay_kernel.replay_core` on CPU tensors: the
  chain over gathered rows and autograd through it) vs the JAX replay pair,
  `replay_kernel.replay_core(..., interpret=True)` and its ``jax.vjp``, on
  one (8, 16) block of the same 128 rays: colour rtol 2e-5 / atol 5e-6;
  d(o), d(d), d(sky) and d(g) summed to d(table) through the gather within
  rtol 5e-4 / atol 1e-5, the bound `test_torch_replay.py` uses. The colour's
  atol is not `test_torch_replay.py`'s 2e-6 (the port against JAX's XLA
  replay): one ray of the 128 leaves the r = 10 ground sphere, whose
  float32 normal is ill-conditioned (ROADMAP C2), and there JAX's Pallas
  kernel, JAX's XLA replay and the port round it three ways, 4.9e-6 apart,
  with the float64 chain between them.
* `integrator.trace(grad_sweep="replay")` vs `path_replay.trace_fused_grad`
  (interpret mode) with the same uniforms: colour and the ten parameter
  gradients of a weighted-sum loss, same bounds.
* `integrator.grad_route` equals JAX's ``_grad_route`` under "replay" on a
  dense and a triangle packet: replay, staged. A nine-material packet takes
  the port's replay route (its recording kernel reads any material table)
  where JAX's takes its staged route (its kernels hold 8 materials), and
  both take the staged route under ``grad_sweep="staged"``.
* `mse_step` and `two_pass_mse_step` on the replay route vs the fused route
  on the same seed: the same selections and the same adjoint, summed in
  another order, with the replay chain's colour as the primal: loss within
  1e-5 relative, every gradient within 1e-4 relative L2.
* Dispatch without a card: the route, the replay wrappers and
  `replay_core` on CUDA tensors reach the kernel library or raise, never
  the plain chain.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ptre_tpu.models import demo as jdemo
from ptre_tpu.models import scene as jscene
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import integrator as jint
from ptre_tpu.ops import path_replay as jpr
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.ops.pallas import replay_kernel as jrk
from ptre_tpu.parallel import sharding as jsh
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu.utils.config import RenderConfig as JConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models import scene as tscene
from ptre_tpu_torch.models.scene import PACKET_LEAVES
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator, path_replay
from ptre_tpu_torch.ops.cuda import build, fused_grad
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils import interop
from ptre_tpu_torch.utils.config import RenderConfig
from ptre_tpu_torch.utils.errors import RendererError

W, H, DEPTH = 16, 8, 3
R = W * H
LANES = W  # the JAX pair on one (8, 16) block: ray r at (r // 16, r % 16)
RTOL, ATOL = 5e-4, 1e-5  # gradients (test_torch_replay.py's bound)


def _weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32).reshape(shape))


def _planar(rows):
    """(C, R) → JAX's (C, 8, L) block, ray r at sublane r // L, lane r % L."""
    return jnp.asarray(np.asarray(rows, np.float32).reshape(rows.shape[0], 8, LANES))


def _jax_pair(jp, cfg, o, d, jsel, jur):
    """JAX's replay pair on the recorded paths: colour (R, 3) and the vjp
    of the weighted-sum cotangent → (d o, d d, d table, d sky)."""
    table, T, sky6 = jpr._build_table(jp)
    table = np.asarray(table)
    idx = np.where(jsel[:, 2] > 0.5, T + jsel[:, 1], jsel[:, 0]).astype(np.int64)  # (B, R)
    rays = _planar(np.concatenate([o.T, d.T, np.zeros((2, R), np.float32)]))
    g = _planar(np.concatenate([table[idx[b]].T for b in range(DEPTH)]))
    flags = _planar(np.stack([jsel[b, k] for b in range(DEPTH) for k in (2, 3)]))
    ur = _planar(jur)

    def f(rays, g, sky):
        return jrk.replay_core(rays, g, flags, ur, sky, cfg, interpret=True, lanes=LANES)

    col, vjp = jax.vjp(f, rays, g, sky6)
    dcol = _planar(_weights((R, 3)).T)
    drays, dg, dsky = (np.asarray(x) for x in vjp(dcol))
    dg = dg.reshape(DEPTH, 27, R)
    dtable = np.zeros_like(table)
    for b in range(DEPTH):  # the one-hot gather's transpose
        np.add.at(dtable, idx[b], dg[b].T)
    drays = drays.reshape(8, R)
    return (np.asarray(col).reshape(3, R).T, drays[0:3].T, drays[3:6].T, dtable, dsky)


@pytest.fixture(scope="module")
def case():
    jp = jdemo.reference_demo_scene(8, 4).build_packet()
    jp = jp.replace(mat_kind=jnp.zeros_like(jp.mat_kind),
                    mat_param=jnp.asarray([1.0, 0.4], jnp.float32))
    jc = jcam.Camera.create(width=W, height=H)
    cfg = JConfig(width=W, height=H, max_depth=DEPTH)
    px, py = jpt.pixel_grid(H, W)
    key = jrng.key_for(1984)
    jitter = jrng.pixel_jitter(jrng.fold(key, 0x9E37), (px.shape[0],))
    o, d = jcam.get_rays(jc, px, py, jitter)
    jsel, jur = jmk.trace_fused_sel(key, o, d, jp, cfg, interpret=True)
    jsel, jur = np.asarray(jsel), np.asarray(jur)

    params = jsh.differentiable_params(jp, jc)
    wts = jnp.asarray(_weights((R, 3)))

    def loss(par, oo, dd):
        pk, _ = jsh._apply_params(par, jp, jc)
        c = jpr.trace_fused_grad(key, oo, dd, pk, cfg, interpret=True)
        return jnp.sum(c * wts), c

    (_, c_route), g = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(params, o, d)
    o, d = np.asarray(o), np.asarray(d)
    return dict(
        jp=jp, pkt=interop.packet_from_reference(jp, device="cpu"), o=o, d=d, sel=jsel, ur=jur,
        pair=_jax_pair(jp, cfg, o, d, jsel, jur), route_color=np.asarray(c_route),
        route_grads=({k: np.asarray(v) for k, v in g[0].items()}, np.asarray(g[1]),
                     np.asarray(g[2])),
        params={k: np.asarray(v) for k, v in params.items()})


def _urand(case):
    """The port's (2 + 2B, R) layout: two unused jitter rows first."""
    return torch.from_numpy(np.concatenate(
        [np.zeros((2, R), np.float32), case["ur"]]).astype(np.float32))


def _port_cfg(**kw):
    return RenderConfig(width=W, height=H, max_depth=DEPTH, **kw)


def test_plain_replay_pair_forward_matches_jax_kernel(case):
    torch.set_num_threads(1)
    pkt = case["pkt"]
    table, T, sky6 = path_replay.build_table(pkt)
    sel = interop.selections_from_jax(case["sel"], T)
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    before = (rpk.fwd_launches, rpk.bwd_launches)
    with torch.no_grad():
        color = rpk.replay_core(o, d, path_replay.gather_rows(table, sel), sel, sky6, T,
                                mk.TraceConsts.from_config(_port_cfg()), DEPTH,
                                urand=_urand(case))
    assert (rpk.fwd_launches, rpk.bwd_launches) == before
    np.testing.assert_allclose(color.numpy(), case["pair"][0], rtol=2e-5, atol=5e-6)
    # every branch the pair has: misses, emitter hits, triangle and sphere hits
    hit = sel >= 0
    assert (~hit).any() and (sel[hit] >= T).any() and (sel[hit] < T).any()


def test_plain_replay_pair_vjp_matches_jax_kernel(case):
    torch.set_num_threads(1)
    table, T, sky6 = path_replay.build_table(case["pkt"])
    table = table.detach().requires_grad_(True)
    sky6 = sky6.detach().requires_grad_(True)
    sel = interop.selections_from_jax(case["sel"], T)
    o = torch.tensor(case["o"], requires_grad=True)
    d = torch.tensor(case["d"], requires_grad=True)
    g = path_replay.gather_rows(table, sel)
    color = rpk.replay_core(o, d, g, sel, sky6, T, mk.TraceConsts.from_config(_port_cfg()),
                            DEPTH, urand=_urand(case))
    grads = torch.autograd.grad(color, (o, d, table, sky6),
                                grad_outputs=torch.from_numpy(_weights((R, 3))))
    _, jo, jd, jtable, jsky = case["pair"]
    for name, got, want in (("d(o)", grads[0], jo), ("d(d)", grads[1], jd),
                            ("d(table)", grads[2], jtable), ("d(sky)", grads[3], jsky)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=name)
    # triangle geometry and both classes' rows receive gradient
    assert np.abs(jtable[:T, :9]).max() > 0 and np.abs(jtable[T:, 18:22]).max() > 0


def test_replay_route_matches_jax_trace_fused_grad(case):
    torch.set_num_threads(1)
    leaves = {k: v.requires_grad_(True)
              for k, v in interop.params_from_numpy(case["params"], device="cpu").items()}
    o = torch.tensor(case["o"], requires_grad=True)
    d = torch.tensor(case["d"], requires_grad=True)
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    pk, _ = sh.apply_params(leaves, case["pkt"], cam)
    cfg = _port_cfg(grad_sweep="replay")
    assert integrator.grad_route(cfg, pk) == "replay"
    color = integrator.trace(o, d, pk, cfg, urand=_urand(case))
    np.testing.assert_allclose(color.detach().numpy(), case["route_color"],
                               rtol=2e-5, atol=2e-6)
    loss = torch.sum(color * torch.from_numpy(_weights((R, 3))))
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [o, d], allow_unused=True)
    jg, jo, jd = case["route_grads"]
    assert len(names) == 10
    for k, g in zip(names, grads):
        got = np.zeros_like(jg[k]) if g is None else g.numpy()
        np.testing.assert_allclose(got, jg[k], rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(grads[-2].numpy(), jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[-1].numpy(), jd, rtol=RTOL, atol=2e-5)
    assert np.abs(jg["transforms"]).max() > 0 and np.abs(jg["sph_radius"]).max() > 0


def _nine(mod, dm):
    scn = dm.reference_demo_scene(8, 4)
    for i in range(7):
        scn.add_material(mod.Material(mod.MaterialKind.OREN_NAYAR, (0.1 * i, 0.5, 0.3),
                                      0.4 + 0.1 * i))
    scn.set_model_material("ground", 8)
    return scn.build_packet(**({"device": "cpu"} if mod is tscene else {}))


#: name: (JAX packet, port packet, grad_sweep, the port's route, JAX's route)
ROUTE_PACKETS = {
    "dense": (lambda: jdemo.reference_demo_scene(8, 4).build_packet(),
              lambda: demo.reference_demo_scene(8, 4).build_packet(device="cpu"), "replay",
              "replay", "replay"),
    "triangle": (lambda: jdemo.config4_mixed_scene(12, 6).build_packet(),
                 lambda: demo.config4_mixed_scene(12, 6).build_packet(device="cpu"), "replay",
                 "staged", "staged"),
    "nine_materials": (lambda: _nine(jscene, jdemo), lambda: _nine(tscene, demo), "replay",
                       "replay", "staged"),
    "nine_materials_staged": (lambda: _nine(jscene, jdemo), lambda: _nine(tscene, demo),
                              "staged", "staged", "staged"),
}


@pytest.mark.parametrize("name", list(ROUTE_PACKETS))
def test_grad_route_under_replay_equals_jax(name):
    jfn, tfn, sweep, want, jax_want = ROUTE_PACKETS[name]
    jp, pkt = jfn(), tfn()
    assert integrator.grad_route(_port_cfg(grad_sweep=sweep), pkt) == want
    assert jint._grad_route(JConfig(width=W, height=H, grad_sweep=sweep), jp) == jax_want


def _diffuse_demo():
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    return dataclasses.replace(pkt, mat_kind=torch.zeros_like(pkt.mat_kind),
                               mat_param=torch.tensor([1.0, 0.4]))


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("step", ["mse_step", "two_pass_mse_step"])
def test_replay_step_equals_fused_step(step):
    torch.set_num_threads(1)
    pkt = _diffuse_demo()
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    params = sh.differentiable_params(pkt, cam)
    target = torch.from_numpy(np.random.default_rng(4).uniform(0.0, 0.3, (R, 3))
                              .astype(np.float32))
    before = (mk.record_launches, rpk.fwd_launches, rpk.bwd_launches, fused_grad.launches)
    out = {sweep: getattr(train, step)(params, pkt, cam, target, _port_cfg(grad_sweep=sweep),
                                       seed=11, spp=3)
           for sweep in ("replay", "fused")}
    assert (mk.record_launches, rpk.fwd_launches, rpk.bwd_launches,
            fused_grad.launches) == before  # CPU tensors: plain versions only
    (lr, gr), (lf, gf) = out["replay"], out["fused"]
    assert abs(float(lr) - float(lf)) <= 1e-5 * abs(float(lf))
    assert set(gr) == set(sh.PARAM_KEYS)
    for k in gf:
        assert bool(torch.isfinite(gr[k]).all()), k
        assert _rel(gr[k], gf[k]) <= 1e-4, (k, _rel(gr[k], gf[k]))
    assert float(gr["transforms"].abs().max()) > 0 and float(gr["cam_position"].abs().max()) > 0


def _no_cuda(*args, **kwargs):
    raise AssertionError("a CUDA call was made")


def _no_plain(*args, **kwargs):
    raise AssertionError("the plain chain ran")


def test_replay_on_cuda_tensors_reaches_the_kernels_or_raises(monkeypatch):
    """Fake CUDA tensors (nothing may touch them): the route
    (`trace_fused_grad`), `replay_core` and both wrappers go to the kernel
    library, never to the plain chain; a bad shape raises before any
    launch."""
    cfg = _port_cfg()
    host = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    monkeypatch.setattr(build, "load_library", _no_cuda)
    for plain in ("replay_fwd_reference", "replay_bwd_reference"):
        monkeypatch.setattr(rpk, plain, _no_plain)
    monkeypatch.setattr(path_replay, "replay_table", _no_plain)
    k = mk.TraceConsts.from_config(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        pkt = dataclasses.replace(host, **{
            key: torch.empty_like(getattr(host, key), device="cuda") for key in PACKET_LEAVES})
        o = torch.zeros((R, 3), device="cuda")
        sel = torch.zeros((DEPTH, R), dtype=torch.int32, device="cuda")
        g = torch.zeros((DEPTH, R, 27), device="cuda")
        sky6 = torch.zeros((6,), device="cuda")
        # the recording kernel and the table's gathers have no fake-CUDA path
        # in this torch; the route is checked from the selections on
        table = torch.zeros((15, 27), device="cuda")
        monkeypatch.setattr(path_replay, "build_table", lambda packet: (table, 14, sky6))
        monkeypatch.setattr(mk, "trace_fused_sel", lambda o, *args: (o, sel))
        with pytest.raises(AssertionError, match="CUDA call"):
            path_replay.trace_fused_grad(o, o, pkt, cfg, forward=types.SimpleNamespace(scene=None))
        with pytest.raises(AssertionError, match="CUDA call"):
            rpk.replay_core(o, o, g, sel, sky6, 14, k, DEPTH)
        with pytest.raises(AssertionError, match="CUDA call"):
            rpk.replay_bwd(o, o, g, sel, sky6, o, 14, k, DEPTH)
        with pytest.raises(RendererError, match="shape"):  # checked before any launch
            rpk.replay_fwd(o, o, torch.zeros((DEPTH, 4, 27), device="cuda"), sel, sky6, 14,
                           k, DEPTH)


def test_replay_wrappers_refuse_other_devices():
    k = mk.TraceConsts.from_config(_port_cfg())
    meta = torch.empty((R, 3), device="meta")
    g = torch.empty((DEPTH, R, 27), device="meta")
    sel = torch.empty((DEPTH, R), dtype=torch.int32, device="meta")
    sky6 = torch.empty((6,), device="meta")
    with pytest.raises(RendererError, match="cuda or cpu"):
        rpk.replay_fwd(meta, meta, g, sel, sky6, 14, k, DEPTH)
    with pytest.raises(RendererError, match="cuda or cpu"):
        rpk.replay_bwd(meta, meta, g, sel, sky6, meta, 14, k, DEPTH)
    with pytest.raises(RendererError, match="cuda or cpu"):
        rpk.replay_core(meta, meta, g, sel, sky6, 14, k, DEPTH)


def test_gather_rows_zero_row_for_misses_and_embedding_backward():
    table = torch.arange(4 * 27, dtype=torch.float32).reshape(4, 27).requires_grad_(True)
    sel = torch.tensor([[0, -1, 3, 3], [2, 2, -1, 1]], dtype=torch.int32)
    g = path_replay.gather_rows(table, sel)
    assert g.shape == (2, 4, 27)
    want = torch.where((sel >= 0)[..., None], table.detach()[sel.clamp(min=0).long()], 0.0)
    assert torch.equal(g.detach(), want)
    (dt,) = torch.autograd.grad(g, table, torch.ones_like(g))
    counts = torch.bincount(sel[sel >= 0].long(), minlength=4).float()
    assert torch.equal(dt, counts[:, None].expand(4, 27))
