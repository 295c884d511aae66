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

The packets past the fused kernels' caps: the demo scene with 7 more
materials (9, past the 8-material cap; it used to die with a bare
``ValueError`` on the CPU), and a 120-triangle uv-sphere over the ground
padded to 49,280 triangle rows (past the wavefront's 49,152).
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
from ptre_tpu.ops import rng as jrng
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
    return jcam.Camera.create(width=w, height=h), cam_ops.Camera.create(width=w, height=h)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def test_over_cap_packets_take_the_staged_route():
    cfg = RenderConfig(width=W, height=H)
    for kind in ("nine", "over_rows"):
        pkt = _packets(kind)[1]
        assert not fused_grad.supported(pkt) and not wf.supports(pkt)
        assert pt.route(pkt) == pt.route(pkt, cfg) == "staged"
        assert integrator.grad_route(cfg, pkt) == "staged"
        assert integrator.grad_route(dataclasses.replace(cfg, grad_sweep="fused"), pkt) == "staged"
    assert _packets("over_rows")[1].tri_valid.shape[0] == OVER_ROWS > wf.MAX_WAVE_TRIS


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
    cam = cam_ops.Camera.create(width=W, height=H)
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
    # before the staged route this packet died with a bare ValueError on the CPU
    jp, pkt = _packets("nine")
    jc, cam = _cams()
    jcfg = JConfig(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
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


def test_ray_chunk_changes_nothing_without_a_key():
    pkt = _packets("nine")[1]
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    whole = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 9, cfg, spp=2)
    for chunk in (32, 50):  # 50: a ragged last chunk
        part = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 9, cfg, spp=2,
                              ray_chunk=chunk)
        assert torch.equal(part.linear, whole.linear)
    # Philox draws: the staged route traces the fused routes' paths
    forced = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 9,
                            dataclasses.replace(cfg, intersect_backend="xla"), spp=2)
    assert torch.equal(forced.linear, whole.linear)


def test_render_step_past_the_wavefront_row_cap_matches_jax():
    jp, pkt = _packets("over_rows")
    jc, cam = _cams(8, 4)
    jcfg, cfg = JConfig(width=8, height=4), RenderConfig(width=8, height=4)
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
    cfg = RenderConfig(width=w, height=h)
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


def test_route_fields_are_validated_and_read():
    for field in ("intersect_backend", "grad_sweep"):
        with pytest.raises(ConfigError, match=field):
            RenderConfig(**{field: "bogus"})
    for b in ("auto", "xla", "pallas", "fused"):
        assert RenderConfig(intersect_backend=b).intersect_backend == b
    dense = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    tri = demo.config4_mixed_scene(12, 6).build_packet(device="cpu")
    nine = _packets("nine")[1]
    table = {"auto": ("dense", "wavefront", "staged"), "fused": ("dense", "wavefront", "staged"),
             "pallas": ("staged",) * 3, "xla": ("staged",) * 3}
    for backend, want in table.items():
        cfg = RenderConfig(intersect_backend=backend)
        assert tuple(pt.route(p, cfg) for p in (dense, tri, nine)) == want, backend
    for sweep, want in {"auto": ("fused", "fused", "staged"), "fused": ("fused", "fused", "staged"),
                        "staged": ("staged",) * 3}.items():
        cfg = RenderConfig(grad_sweep=sweep)
        assert tuple(integrator.grad_route(cfg, p) for p in (dense, tri, nine)) == want, sweep
    # the replay route runs: dense-class packets only, the rest staged
    cfg = RenderConfig(width=W, height=H, grad_sweep="replay")
    cam = cam_ops.Camera.create(width=W, height=H)
    assert tuple(integrator.grad_route(cfg, p) for p in (dense, tri, nine)) == (
        "replay", "staged", "staged")
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
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, intersect_backend="xla")
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
        pt.check_dispatch(pkt, "cuda", RenderConfig())  # the sweep kernel: accepted
