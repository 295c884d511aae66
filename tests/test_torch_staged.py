"""The staged route (`ops/integrator.trace_staged`) and the routes that reach
it, against the JAX package's staged route on the CPU.

Same threefry key on both sides (`rng.Key`, the bit-exact twin): the port
draws exactly the reference's uniforms, so both trace the same paths.
JAX's side runs with ``remat_bounces=False`` (values identical either way,
`RenderConfig`) so that no rematerialisation enters its gradients.

Tolerances: colour and loss within 1e-5 relative (same formulas, rounded in
another order; XLA contracts FMAs); gradients per leaf within 5e-4 relative
L2 (measured <= 1.2e-4, config 4's camera: rays near the gradsafe floors
amplify rounding, ROADMAP C2); images within 1e-5. The staged route against the
port's fused route with the same ``urand``: the fused kernels' plain
versions use other operation orders (1/pi multiplied vs divided, the
dense normal flipped before it is normalised, the replay chain's own
recompute), so colour within 1e-5 and gradients within 1e-3 relative L2
per leaf (rays near the gradsafe floors amplify rounding, ROADMAP C2).

The packets: the demo scene with 7 more materials (9: past the JAX
kernels' 8-row SMEM select, so JAX routes it to its staged route; the
port's render kernel and fused route take it, so the tests here force it
onto the staged route with ``intersect_backend="pallas"`` and
``grad_sweep="staged"``, and hold its default route to JAX's staged route
under JAX's draws); and a 120-triangle uv-sphere over
the ground padded to 49,280 triangle rows, past the reference's 49,152-row
VMEM cap, which the port's wavefront and fused route take and the staged
route takes when forced (``intersect_backend="pallas"``,
``grad_sweep="staged"``), as JAX's routes it there.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ptre_tpu.models import demo as jdemo
from ptre_tpu.models import scene as jscene
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import path_replay as jpr
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.ops.pallas import wavefront as jwf
from ptre_tpu.parallel import sharding as jsh
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu.render import train as jtrain
from ptre_tpu.utils.config import RenderConfig as JConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models import scene as tscene
from ptre_tpu_torch.models.scene import PACKET_LEAVES
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator, path_replay, rng
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import fused_grad
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils import interop
from ptre_tpu_torch.utils.config import RenderConfig
from ptre_tpu_torch.utils.errors import ConfigError

W, H = 16, 8
R = W * H
OVER_ROWS = 49280


def _nine(mod, dm, segments=8, rings=4):
    scn = dm.reference_demo_scene(segments, rings)
    for i in range(7):
        scn.add_material(mod.Material(mod.MaterialKind.OREN_NAYAR,
                                      (0.1 * i, 0.5, 0.3), 0.4 + 0.1 * i))
    scn.set_model_material("ground", 8)
    scn.set_model_material("wall", 5)
    return scn.build_packet(**({"device": "cpu"} if mod is tscene else {}))


def _packets(kind):
    """(JAX packet, port packet) of a named case."""
    if kind == "nine":
        return _nine(jscene, jdemo), _nine(tscene, demo)
    if kind == "over_rows":  # 120 triangles (past the dense class) in 49,280 rows
        return (jdemo.config3_scene(False, 12, 6, diffuse=True).build_packet(tri_pad=OVER_ROWS),
                demo.config3_scene(False, 12, 6, diffuse=True).build_packet(tri_pad=OVER_ROWS, device="cpu"))
    if kind == "config4":
        return (jdemo.config4_mixed_scene(12, 6).build_packet(),
                demo.config4_mixed_scene(12, 6).build_packet(device="cpu"))
    return (jdemo.reference_demo_scene(8, 4).build_packet(),
            demo.reference_demo_scene(8, 4).build_packet(device="cpu"))


def _cams(w=W, h=H):
    return (jcam.Camera.create(width=w, height=h),
            cam_ops.Camera.create(width=w, height=h, device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def test_over_cap_packets_take_the_staged_route():
    """Nine materials take the render kernel and the fused route, and the
    staged route when forced (JAX's kernels take at most 8). The 49,280-row
    packet and the 65,024-row mesh, past the reference's 49,152-row VMEM
    cap, take the wavefront and the fused route (and the culled megakernel
    when forced); the staged route under ``intersect_backend="pallas"``,
    ``grad_sweep="staged"`` or max_depth 9. A packet past the mask kernel's
    leaves takes the staged route."""
    cfg = RenderConfig(width=W, height=H)
    nine = _packets("nine")[1]
    assert nine.num_materials == 9 and mk.dense_supported(nine)
    assert fused_grad.supported(nine) and wf.supports(nine)
    assert pt.route(nine) == pt.route(nine, cfg) == "dense"
    assert integrator.grad_route(cfg, nine) == "fused"
    assert integrator.grad_route(dataclasses.replace(cfg, grad_sweep="fused"), nine) == "fused"
    assert pt.route(nine, dataclasses.replace(cfg, intersect_backend="pallas")) == "staged"
    assert integrator.grad_route(dataclasses.replace(cfg, grad_sweep="staged"), nine) == "staged"
    over = _packets("over_rows")[1]
    mesh = demo.config3_scene(False, 256, 128, diffuse=True).build_packet(device="cpu")
    assert over.tri_valid.shape[0] == OVER_ROWS > 49152
    assert mesh.tri_valid.shape[0] == 65024
    for pkt in (over, mesh):
        assert fused_grad.supported(pkt) and wf.supports(pkt)
        assert pt.route(pkt) == pt.route(pkt, cfg) == "wavefront"
        assert integrator.grad_route(cfg, pkt) == "fused"
        fused_grad.check_supported(pkt, "culled")
        assert pt.route(pkt, dataclasses.replace(cfg, intersect_backend="pallas")) == "staged"
        assert integrator.grad_route(dataclasses.replace(cfg, grad_sweep="staged"),
                                     pkt) == "staged"
        assert integrator.grad_route(dataclasses.replace(cfg, max_depth=9), pkt) == "staged"
    past = dataclasses.replace(over, tri_valid=torch.zeros(1, dtype=torch.bool).expand(
        wf.MAX_MASK_LEAVES * wf.LEAF + 1))
    assert not fused_grad.supported(past)
    assert pt.route(past) == "staged" and integrator.grad_route(cfg, past) == "staged"


@pytest.mark.parametrize("kind", ["config4", "nine"])
def test_staged_trace_matches_jax_with_the_same_key(kind):
    # colour and the gradients of every parameter leaf (albedo, radius,
    # transforms, sky, camera through the rays) of one sample
    torch.set_num_threads(1)
    jp, pkt = _packets(kind)
    jc, cam = _cams()
    jcfg = JConfig(width=W, height=H, remat_bounces=False, grad_sweep="staged")
    cfg = RenderConfig(width=W, height=H, grad_sweep="staged")
    key = jrng.fold(jrng.key_for(7), 2)
    wts = np.random.default_rng(1).normal(size=(R, 3)).astype(np.float32)

    def jloss(par):
        c = jtrain.sample_color(par, jp, jc, jcfg, jrng.fold(key, 0))
        return jnp.sum(c * wts), c

    (jl, jcol), jg = jax.value_and_grad(jloss, has_aux=True)(jsh.differentiable_params(jp, jc))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in sh.differentiable_params(pkt, cam).items()}
    col = train.sample_color(leaves, pkt, cam, cfg, interop.key_from_jax(np.asarray(key)), 0)
    np.testing.assert_allclose(col.detach().numpy(), np.asarray(jcol), rtol=1e-5, atol=1e-5)
    loss = torch.sum(col * torch.from_numpy(wts))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for k, g in zip(leaves, grads):
        assert _rel(jg[k], g.numpy()) <= 5e-4, (k, _rel(jg[k], g.numpy()))
    for k in ("mat_albedo", "sph_radius", "sky_top", "cam_position"):
        assert float(np.abs(np.asarray(jg[k])).max()) > 0, k


@pytest.mark.parametrize("kind", ["config4", "nine"])
def test_dead_ray_mask_changes_no_colour_or_gradient(kind, monkeypatch):
    # trace_staged sweeps only the rays still live at each bounce; a dead
    # ray's selection is never read (its factor is masked by `active`), so
    # the colour is bit-equal and every gradient equal (a dead ray's
    # cotangents are exact zeros on either selection: the float64 sums of
    # the gathers do not move) with the sweep of every ray
    torch.set_num_threads(1)
    pkt = _packets(kind)[1]
    cam = _cams(32, 16)[1]
    cfg = RenderConfig(width=32, height=16, grad_sweep="staged", max_depth=4)
    wts = torch.from_numpy(np.random.default_rng(2).normal(size=(512, 3)).astype(np.float32))
    swept = []

    def run():
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in sh.differentiable_params(pkt, cam).items()}
        col = train.sample_color(leaves, pkt, cam, cfg, 7, 0)
        return col.detach(), torch.autograd.grad(torch.sum(col * wts), list(leaves.values()))

    masked = run()
    unmasked_fn = integrator._sweep_fn

    def every_ray(scene, consts, active):
        swept.append(int(active.sum()))
        return unmasked_fn(scene, consts, None)

    monkeypatch.setattr(integrator, "_sweep_fn", every_ray)
    full = run()
    assert swept[0] == 512 and min(swept) < 512  # rays died before the last bounce
    assert torch.equal(masked[0], full[0])
    for a, b in zip(masked[1], full[1]):
        assert torch.equal(a, b)


def test_staged_route_matches_fused_route_with_the_same_urand():
    # the same packet, the same uniforms: the same paths through two routes
    torch.set_num_threads(1)
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    urand = torch.from_numpy(np.random.default_rng(3).random(
        (1, 12, H, W), dtype=np.float32))
    target = torch.from_numpy(np.random.default_rng(4).uniform(0, 0.5, (R, 3)).astype(np.float32))
    out = {}
    for sweep in ("fused", "staged"):
        cfg = RenderConfig(width=W, height=H, grad_sweep=sweep)
        assert integrator.grad_route(cfg, pkt) == sweep
        out[sweep] = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg,
                                    seed=0, spp=1, urand=urand)
    (lf, gf), (ls, gs) = out["fused"], out["staged"]
    np.testing.assert_allclose(float(ls), float(lf), rtol=1e-5)
    for k in gf:
        if float(gf[k].abs().max()) > 0:
            assert _rel(gf[k].numpy(), gs[k].numpy()) <= 1e-3, k
        else:
            assert float(gs[k].abs().max()) <= 1e-6, k


def test_render_step_nine_materials_matches_jax_render_step():
    # JAX's route for this packet is its staged route; the port's is the
    # render kernel, so the staged route is forced to hold it to JAX's draws
    jp, pkt = _packets("nine")
    jc, cam = _cams()
    jcfg = JConfig(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, intersect_backend="pallas")
    assert pt.route(pkt, cfg) == "staged"
    key = jrng.key_for(11)
    prev = np.random.default_rng(2).random((H, W, 3), dtype=np.float32)
    jacc = jpt.AccumState(linear=jnp.asarray(prev), frame=jnp.asarray(3, jnp.int32))
    want = np.asarray(jpt.render_step(jp, jc, jacc, key, jcfg, spp=2).linear)
    acc = pt.render_step(pkt, cam, pt.AccumState(torch.from_numpy(prev.copy()), 3),
                         interop.key_from_jax(np.asarray(key)), cfg, spp=2)
    assert acc.frame == 5
    np.testing.assert_allclose(acc.linear.numpy(), want, rtol=1e-5, atol=1e-5)
    # ray_chunk: each chunk keyed fold(key, chunk), as JAX's lax.map keys it
    want = np.asarray(jpt.render_step(jp, jc, jpt.AccumState.create(H, W), key, jcfg, spp=1,
                                      ray_chunk=32).linear)
    got = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"),
                         interop.key_from_jax(np.asarray(key)), cfg, spp=1, ray_chunk=32)
    np.testing.assert_allclose(got.linear.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_render_urand(key, frame, spp, w=W, h=H, depth=5):
    """(spp, 2 + 2*depth, h, w): the draws of JAX's staged `render_step`
    (`test_torch_pathtracer.jax_urand`)."""
    out = []
    for s in range(spp):
        skey = jrng.fold(jrng.fold(key, s), frame + s + 1)
        jit = np.asarray(jrng.pixel_jitter(jrng.fold(skey, 0x9E37), (w * h,)))
        ur = np.asarray(jmk._build_urand(skey, w * h, depth))
        out.append(np.concatenate([jit.T + np.float32(0.5), ur]).reshape(-1, h, w))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def test_render_step_nine_materials_default_route_matches_jax_render_step():
    """The twin of the test above on the port's default route, the render
    kernel (its plain version here), fed JAX's staged draws: within
    `test_torch_pathtracer`'s staged-vs-fused bound (atol = rtol = 2e-3,
    >= 95 % of pixels within 1e-4), since the render kernel builds its
    primary rays in closed form."""
    torch.set_num_threads(1)
    jp, pkt = _packets("nine")
    jc, cam = _cams()
    cfg = RenderConfig(width=W, height=H)
    assert pt.route(pkt, cfg) == "dense"
    key = jrng.key_for(11)
    prev = np.random.default_rng(2).random((H, W, 3), dtype=np.float32)
    jacc = jpt.AccumState(linear=jnp.asarray(prev), frame=jnp.asarray(3, jnp.int32))
    want = np.asarray(jpt.render_step(jp, jc, jacc, key, JConfig(width=W, height=H),
                                      spp=2).linear)
    before = rk.launches
    acc = pt.render_step(pkt, cam, pt.AccumState(torch.from_numpy(prev.copy()), 3), 0, cfg,
                         spp=2, urand=_jax_render_urand(key, 3, 2))
    assert acc.frame == 5 and rk.launches == before  # plain on the CPU
    got = acc.linear.numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    assert np.all(np.abs(got - want) < 1e-4, axis=-1).mean() > 0.95


def test_ray_chunk_changes_nothing_without_a_key():
    # ray_chunk splits the staged route's rays, which this test forces
    pkt = _packets("nine")[1]
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    cfg = RenderConfig(width=W, height=H, intersect_backend="pallas")
    whole = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 9, cfg, spp=2)
    for chunk in (32, 50):  # 50: a ragged last chunk
        part = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 9, cfg, spp=2,
                              ray_chunk=chunk)
        assert torch.equal(part.linear, whole.linear)
    # Philox draws: the staged route traces the fused routes' paths
    forced = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 9,
                            dataclasses.replace(cfg, intersect_backend="xla"), spp=2)
    assert torch.equal(forced.linear, whole.linear)


def _jax_rays(key, w, h):
    """JAX's camera, the (R, 2) jitter its training step draws from ``key``
    (`train.py:56-70`) and the jittered primary rays."""
    jc = jcam.Camera.create(width=w, height=h)
    px, py = jpt.pixel_grid(h, w)
    jit = jrng.pixel_jitter(jrng.fold(key, 0x9E37), (w * h,))
    o, d = jcam.get_rays(jc, px, py, jit)
    return jc, jit, o, d


@pytest.fixture(scope="module")
def over_rows_jax():
    """JAX's wavefront trace of the 49,280-row packet at 8x4 in record mode
    (interpret mode, ~25 s on a CPU): its colour, selections (B, 4, R),
    uniforms (2B, R) and Morton permutation, with the key, the camera, the
    jitter and the rays."""
    jp, pkt = _packets("over_rows")
    w, h = 8, 4
    key = jrng.key_for(3)
    jc, jit, o, d = _jax_rays(key, w, h)
    jcfg = JConfig(width=w, height=h, remat_bounces=False)
    col, sel, ur, perm = jwf.trace(key, o, d, jp, jcfg, record=True, interpret=True)
    return dict(jp=jp, pkt=pkt, w=w, h=h, jcfg=jcfg, jc=jc, jit=jit, o=o, d=d, col=col,
                sel=sel, ur=ur, perm=perm)


def test_wavefront_trace_past_the_row_cap_matches_jax_wavefront(over_rows_jax):
    """The port's wavefront trace (plain versions: CPU tensors) on the
    49,280-row packet, which its route now takes, against JAX's
    `wavefront.trace` in interpret mode (it takes any table; JAX's VMEM gate
    is in its route) on the same uniforms, `megakernel._build_urand(key, R,
    B)`: within 1e-6, `test_torch_wavefront`'s
    test_trace_matches_jax_wavefront_and_staged_route bound."""
    torch.set_num_threads(1)
    j = over_rows_jax
    R, cfg = j["w"] * j["h"], RenderConfig(width=j["w"], height=j["h"])
    urand = torch.from_numpy(np.concatenate([np.zeros((2, R), np.float32), np.asarray(j["ur"])]))
    before = wf.mask_launches, wf.bounce_launches
    got = wf.trace(torch.from_numpy(np.array(j["o"])), torch.from_numpy(np.array(j["d"])),
                   wf.prepare_scene(j["pkt"]), mk.TraceConsts.from_config(cfg), cfg.max_depth,
                   urand=urand).numpy()
    assert (wf.mask_launches, wf.bounce_launches) == before  # plain on the CPU
    want = np.asarray(j["col"])
    assert np.isfinite(got).all() and got.max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(j["ur"]), np.asarray(
        jmk._build_urand(jrng.key_for(3), R, cfg.max_depth)))


def test_fused_route_gradients_past_the_row_cap_match_jax(over_rows_jax):
    """`train.mse_step` on the default route — the fused route, which now
    takes the 49,280-row packet: the wavefront in record mode and the
    backward over the Morton-permuted table, plain versions on the CPU —
    against JAX on the same uniforms (`megakernel._build_urand` and the
    training step's jitter, passed as ``urand``). JAX's reference is the one
    its own fused backward is held to (`test_fused_grad.py`, and
    test_torch_culled.py): its wavefront's recorded selections
    (`wavefront.trace(record=True)`, interpret mode) replayed by the XLA
    replay under `jax.value_and_grad`. JAX's fused backward kernel itself,
    in interpret mode, gathers each winner's row by a one-hot product over
    the whole 49,280-row table and takes tens of minutes on a CPU. Tolerances
    of test_torch_culled.py's fused route: the loss within 1e-5 relative,
    every gradient within rtol 5e-4, atol 2e-5."""
    torch.set_num_threads(1)
    j = over_rows_jax
    jp, pkt, w, h, jcfg, jc, jit = (j[k] for k in ("jp", "pkt", "w", "h", "jcfg", "jc", "jit"))
    R = w * h
    cfg = RenderConfig(width=w, height=h)
    assert integrator.grad_route(cfg, pkt) == "fused"
    jur = j["ur"]
    sel = np.array(j["sel"])  # (B, 4, R): Morton rows -> the packet's own rows
    sel[:, 0] = np.asarray(j["perm"])[sel[:, 0].astype(np.int64)]
    target = np.random.default_rng(0).uniform(0, 0.5, (R, 3)).astype(np.float32)
    px, py = jpt.pixel_grid(h, w)

    def jloss(par):
        pk, cm = jsh._apply_params(par, jp, jc)
        oo, dd = jcam.get_rays(cm, px, py, jit)
        c = jpr.replay(oo, dd, jnp.asarray(sel), jur, pk, jcfg, backend="xla")
        return jnp.mean((c - jnp.asarray(target)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jsh.differentiable_params(jp, jc))
    urand = np.concatenate([np.asarray(jit).T + np.float32(0.5), np.asarray(jur)])
    before = fused_grad.launches
    loss, grads = train.mse_step(sh.differentiable_params(pkt, _cams(w, h)[1]), pkt,
                                 _cams(w, h)[1], torch.from_numpy(target), cfg, seed=0,
                                 urand=torch.from_numpy(urand.reshape(1, -1, h, w)))
    assert fused_grad.launches == before  # plain versions on the CPU
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        want = np.asarray(jg[k])
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), want, rtol=5e-4, atol=2e-5, err_msg=k)
    assert float(np.abs(np.asarray(jg["transforms"])).max()) > 1e-4


def test_render_step_past_the_wavefront_row_cap_matches_jax():
    # JAX routes this packet to its staged route; the port's takes it forced
    jp, pkt = _packets("over_rows")
    jc, cam = _cams(8, 4)
    jcfg = JConfig(width=8, height=4)
    cfg = RenderConfig(width=8, height=4, intersect_backend="pallas")
    assert pt.route(pkt, cfg) == "staged"
    key = jrng.key_for(5)
    want = np.asarray(jpt.render_step(jp, jc, jpt.AccumState.create(4, 8), key, jcfg).linear)
    got = pt.render_step(pkt, cam, pt.AccumState.create(4, 8, device="cpu"),
                         interop.key_from_jax(np.asarray(key)), cfg)
    np.testing.assert_allclose(got.linear.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(got.linear.sum()) > 0


@pytest.mark.parametrize("kind", ["nine", "over_rows"])
def test_training_steps_on_over_cap_packets_match_jax(kind):
    torch.set_num_threads(1)
    jp, pkt = _packets(kind)
    w, h = (W, H) if kind == "nine" else (8, 4)
    jc, cam = _cams(w, h)
    jcfg = JConfig(width=w, height=h, remat_bounces=False, grad_sweep="staged")
    # both packets take the port's fused route by default (JAX's staged
    # route: its kernels take neither) and are forced onto the staged route
    cfg = RenderConfig(width=w, height=h, grad_sweep="staged")
    assert integrator.grad_route(cfg, pkt) == "staged"
    target = np.random.default_rng(0).uniform(0, 0.5, (w * h, 3)).astype(np.float32)
    key = jrng.key_for(3)
    tkey = interop.key_from_jax(np.asarray(key))
    jparams = jsh.differentiable_params(jp, jc)
    params = sh.differentiable_params(pkt, cam)
    jl, jg = jtrain.mse_step(jparams, jp, jc, jnp.asarray(target), key, jcfg, spp=2)
    steps = [train.mse_step(params, pkt, cam, torch.from_numpy(target), cfg, seed=tkey, spp=2)]
    if kind == "nine":
        jl2, jg2 = jtrain.two_pass_mse_step(jparams, jp, jc, jnp.asarray(target), key, jcfg,
                                            spp=2, samples_per_call=1)
        np.testing.assert_allclose(float(jl2), float(jl), rtol=1e-6)
        steps.append(train.two_pass_mse_step(params, pkt, cam, torch.from_numpy(target), cfg,
                                             seed=tkey, spp=2))
    for loss, grads in steps:
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for k in grads:
            assert _rel(jg[k], grads[k].numpy()) <= 5e-4, (k, _rel(jg[k], grads[k].numpy()))
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def _jax_train_urand(key, spp, w=W, h=H, depth=5):
    """(spp, 2 + 2*depth, h, w): the draws of JAX's staged `mse_step`
    (`test_torch_train.jax_urand`)."""
    out = []
    for s in range(spp):
        skey = jrng.fold(key, s)
        jit = np.asarray(jrng.pixel_jitter(jrng.fold(skey, 0x9E37), (w * h,)))
        ur = np.asarray(jmk._build_urand(skey, w * h, depth))
        out.append(np.concatenate([jit.T + np.float32(0.5), ur]).reshape(-1, h, w))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def test_training_step_nine_materials_default_route_matches_jax():
    """The twin of the "nine" case above on the port's default route, the
    fused route (the recording kernel and the fused backward, plain
    versions here), fed JAX's staged draws: `test_torch_train`'s bound (loss
    within 1e-5 relative, gradients rtol 2e-3 with atol 1e-4 of the leaf's
    largest entry); the material gradients reach row 8."""
    torch.set_num_threads(1)
    jp, pkt = _packets("nine")
    jc, cam = _cams()
    jcfg = JConfig(width=W, height=H, remat_bounces=False)
    cfg = RenderConfig(width=W, height=H)
    assert integrator.grad_route(cfg, pkt) == "fused"
    target = np.random.default_rng(0).uniform(0, 0.5, (R, 3)).astype(np.float32)
    key = jrng.key_for(3)
    jl, jg = jtrain.mse_step(jsh.differentiable_params(jp, jc), jp, jc, jnp.asarray(target),
                             key, jcfg, spp=2)
    before = mk.record_launches, fused_grad.launches
    loss, grads = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam,
                                 torch.from_numpy(target), cfg, seed=0, spp=2,
                                 urand=_jax_train_urand(key, 2))
    assert (mk.record_launches, fused_grad.launches) == before  # plain on the CPU
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k, g in grads.items():
        want = np.asarray(jg[k])
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30), err_msg=k)
    assert float(grads["mat_albedo"][8].abs().max()) > 0


def test_route_fields_are_validated_and_read():
    for field in ("intersect_backend", "grad_sweep"):
        with pytest.raises(ConfigError, match=field):
            RenderConfig(**{field: "bogus"})
    for b in ("auto", "xla", "pallas", "fused"):
        assert RenderConfig(intersect_backend=b).intersect_backend == b
    dense = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    tri = demo.config4_mixed_scene(12, 6).build_packet(device="cpu")
    nine = _packets("nine")[1]
    table = {"auto": ("dense", "wavefront", "dense"), "fused": ("dense", "wavefront", "dense"),
             "pallas": ("staged",) * 3, "xla": ("staged",) * 3}
    for backend, want in table.items():
        cfg = RenderConfig(intersect_backend=backend)
        assert tuple(pt.route(p, cfg) for p in (dense, tri, nine)) == want, backend
    for sweep, want in {"auto": ("fused",) * 3, "fused": ("fused",) * 3,
                        "staged": ("staged",) * 3}.items():
        cfg = RenderConfig(grad_sweep=sweep)
        assert tuple(integrator.grad_route(cfg, p) for p in (dense, tri, nine)) == want, sweep
    # the replay route runs: dense-class packets only, the rest staged
    cfg = RenderConfig(width=W, height=H, grad_sweep="replay")
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    assert tuple(integrator.grad_route(cfg, p) for p in (dense, tri, nine)) == (
        "replay", "staged", "replay")
    o, d = torch.zeros((R, 3)), torch.nn.functional.normalize(torch.ones((R, 3)), dim=1)
    color = integrator.trace(o, d, dense, cfg, seed=3)
    assert torch.equal(color, path_replay.trace_fused_grad(o, d, dense, cfg, seed=3))
    loss, grads = train.mse_step(sh.differentiable_params(dense, cam), dense, cam,
                                 torch.zeros((R, 3)), cfg, seed=0)
    assert math.isfinite(float(loss)) and set(grads) == set(sh.PARAM_KEYS)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    # a threefry key on a fused route of render_step: its kernels draw Philox,
    # seeded by `fused_seed` of the key as the reference seeds them; training's
    # fused routes refuse a key
    key, cfg = rng.key_for(1), RenderConfig(width=W, height=H)
    keyed = pt.render_step(dense, cam, pt.AccumState.create(H, W, device="cpu"), key, cfg)
    seeded = pt.render_step(dense, cam, pt.AccumState.create(H, W, device="cpu"),
                            pt.fused_seed(key), cfg)
    assert torch.equal(keyed.linear, seeded.linear)
    with pytest.raises(ConfigError, match="staged route only"):
        train.mse_step(sh.differentiable_params(dense, cam), dense, cam, torch.zeros((R, 3)),
                       RenderConfig(width=W, height=H), seed=rng.key_for(1))


def test_xla_sweep_on_cuda_tensors_raises_before_any_library_load(monkeypatch):
    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA call was made")

    monkeypatch.setattr(build, "load_library", no_cuda)
    host = _packets("nine")[1]
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    # the packet's default routes are fused: the staged one is forced
    cfg = RenderConfig(width=W, height=H, intersect_backend="xla", grad_sweep="staged")
    with FakeTensorMode(allow_non_fake_inputs=True):
        pkt = dataclasses.replace(host, **{
            k: torch.empty_like(getattr(host, k), device="cuda") for k in PACKET_LEAVES})
        o = torch.zeros((R, 3), device="cuda")
        params = {k: torch.empty_like(v, device="cuda")
                  for k, v in sh.differentiable_params(host, cam).items()}
        with pytest.raises(ConfigError, match="xla"):
            pt.render_step(pkt, cam, pt.AccumState(torch.zeros((H, W, 3), device="cuda")), 1,
                           cfg)
        with pytest.raises(ConfigError, match="xla"):
            integrator.trace(o, o, pkt, cfg)
        for step in (train.mse_step, train.two_pass_mse_step):
            with pytest.raises(ConfigError, match="xla"):
                step(params, pkt, cam, o, cfg, seed=1, spp=1)
        pt.check_dispatch(pkt, "cuda", RenderConfig())  # the render kernel: accepted
        pt.check_dispatch(pkt, "cuda", RenderConfig(intersect_backend="pallas"))  # the sweep
