"""The CUDA kernels on the card vs their plain PyTorch versions.

Marked ``cuda``: each test skips where torch sees no CUDA device (the check
runs inside a fixture, never at import). On a machine with the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which that machine
need not have.) Tolerance of the render kernel, as in chip_smoke.py: the kernel contracts a*b+c
into FMAs inside the bounce loop, so a grazing ray can take another
primitive: >= 99.9 % of channels within 1e-4, and channels beyond 0.05 (a
flipped path) on at most 1e-5 of the pixels, rounded up.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ptre_tpu.utils.config import RenderConfig
from ptre_tpu.utils.errors import RendererError
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import fused_grad as fg
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import train

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _setup(dev, W, H, max_depth=5):
    cfg = RenderConfig(width=W, height=H, max_depth=max_depth)
    packed = mk.pack_scene(demo.reference_demo_scene(16, 8).build_packet().to(dev))
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H))
    prev = torch.from_numpy(np.random.default_rng(W).random((H, W, 3), np.float32)).to(dev)
    return cfg, packed, rows, prev


def _assert_close(got, want):
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert float((d <= 1e-4).float().mean()) >= 0.999
    flips = int((d > 0.05).any(dim=-1).sum())
    assert flips <= math.ceil(1e-5 * d.shape[0] * d.shape[1]), flips


@pytest.mark.parametrize("W,H", [(256, 128), (100, 37)])
@pytest.mark.parametrize("external", [True, False])
def test_kernel_matches_plain_version(cuda, W, H, external):
    cfg, packed, rows, prev = _setup(cuda, W, H)
    urand = (torch.rand((2 + 2 * cfg.max_depth, H, W), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if external else None)
    before = rk.launches
    got = rk.sample_accum(prev.clone(), packed, rows, 3, cfg, 77, urand)
    want = rk.sample_accum_reference(prev, packed, rows, 3, cfg, 77, urand)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    _assert_close(got, want)


def test_render_step_goes_through_kernel(cuda):
    W, H = 160, 90
    cfg = RenderConfig(width=W, height=H)
    pkt = demo.reference_demo_scene(16, 8).build_packet().to(cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    before = rk.launches
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, cuda), 3, cfg, spp=3)
    torch.cuda.synchronize()
    assert rk.launches == before + 3 and acc.frame == 3
    lin = acc.linear
    # the running average of clamped samples can round an ulp above 1
    assert bool(torch.isfinite(lin).all()) and 0.0 <= float(lin.min()) <= float(lin.max()) <= 1.0 + 1e-6


def test_wrapper_rejects_bad_inputs(cuda):
    cfg, packed, rows, prev = _setup(cuda, 64, 32)
    with pytest.raises(RendererError, match="contiguous float32"):
        rk.sample_accum(prev.double(), packed, rows, 1, cfg)
    with pytest.raises(RendererError, match="shape"):
        rk.sample_accum(prev, packed, rows, 1, cfg,
                        urand=torch.rand((3, 32, 64), device=cuda))
    with pytest.raises(RendererError, match="accum on"):
        rk.sample_accum(prev, packed, rows, 1, cfg, urand=torch.rand((12, 32, 64)))


# ---- the gradient path's kernels -----------------------------------------------
# Tolerances as in chip_smoke.py phases 6-7: FMA contraction can flip a
# grazing ray's path (the forward) or a branch of its gradient (the
# backward); everything else agrees to float rounding.


def _grad_setup(dev, W=256, H=128, B=5):
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.reference_demo_scene(16, 8).build_packet().to(dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    params = sh.differentiable_params(pkt, cam)
    _, cam_dev = sh.apply_params(params, pkt, cam)
    px, py = pt.pixel_grid(H, W, dev)
    jit = torch.rand((H * W, 2), device=dev, generator=torch.Generator(dev).manual_seed(3))
    o, d = (t.contiguous() for t in cam_ops.get_rays(cam_dev, px, py, jit - 0.5))
    return cfg, pkt, cam, params, o, d, mk.pack_scene(pkt), mk.TraceConsts.from_config(cfg)


@pytest.mark.parametrize("external", [True, False])
def test_record_kernel_matches_plain_version(cuda, external):
    cfg, pkt, _, _, o, d, scene, k = _grad_setup(cuda)
    R = o.shape[0]
    urand = torch.rand((12, R), device=cuda) if external else None
    before = mk.record_launches
    color, sel = mk.trace_fused_sel(o, d, scene, k, 5, 9, 1, urand)
    want_c, want_s = mk.trace_record_reference(o, d, scene, k, 5, 9, 1, urand)
    torch.cuda.synchronize()
    assert mk.record_launches == before + 1
    diff = (color - want_c).abs()
    scale = want_c.abs().clamp_min(1.0)
    assert float((diff <= 1e-4 * scale).float().mean()) >= 0.999
    assert int((sel != want_s).any(dim=0).sum()) <= math.ceil(1e-4 * R)
    assert bool(((sel >= 0) & (sel < scene.tri_rows + scene.n_sph)).any())


@pytest.mark.parametrize("external", [True, False])
def test_backward_kernel_matches_plain_version(cuda, external):
    cfg, pkt, _, _, o, d, scene, k = _grad_setup(cuda)
    R = o.shape[0]
    urand = torch.rand((12, R), device=cuda) if external else None
    _, sel = mk.trace_fused_sel(o, d, scene, k, 5, 9, 1, urand)
    table, T, sky6 = path_replay.build_table(pkt)
    dcol = torch.randn((R, 3), device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    before = fg.launches
    got = fg.fused_bwd(table, sky6, o, d, sel, dcol, k, 5, T, 9, 1, urand)
    want = fg.fused_bwd_reference(table, sky6, o, d, sel, dcol, k, 5, T, 9, 1, urand)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    ray_err = ((got[2] - want[2]).abs() + (got[3] - want[3]).abs()).amax(dim=1)
    ray_mag = (want[2].abs() + want[3].abs()).amax(dim=1)
    flip = ray_err > 1e-2 * ray_mag + 1e-3
    assert int(flip.sum()) <= math.ceil(1e-4 * R)
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        assert float(((a - b).abs() <= 1e-4 * b.abs().max()).float().mean()) >= 0.999
    # material and sky gradients, without the flipped rays
    got = fg.fused_bwd(table, sky6, o, d, sel, torch.where(flip[:, None], 0.0, dcol),
                       k, 5, T, 9, 1, urand)
    want = fg.fused_bwd_reference(table, sky6, o, d, sel,
                                  torch.where(flip[:, None], 0.0, dcol), k, 5, T, 9, 1,
                                  urand)
    for a, b in ((got[0][:, 23:27], want[0][:, 23:27]), (got[1], want[1])):
        assert float((a - b).norm() / b.norm()) <= 1e-4


def test_mse_step_goes_through_both_kernels(cuda):
    cfg, pkt, cam, params, _, _, _, _ = _grad_setup(cuda, W=160, H=90)
    target = torch.zeros((160 * 90, 3), device=cuda)
    before = (mk.record_launches, fg.launches)
    loss, grads = train.mse_step(params, pkt, cam, target, cfg, seed=4, spp=3)
    torch.cuda.synchronize()
    assert (mk.record_launches, fg.launches) == (before[0] + 3, before[1] + 3)
    assert math.isfinite(float(loss)) and float(loss) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["mat_albedo"].abs().max()) > 0


def test_gradient_wrappers_reject_bad_inputs(cuda):
    cfg, pkt, _, _, o, d, scene, k = _grad_setup(cuda, W=64, H=32)
    R = o.shape[0]
    with pytest.raises(RendererError, match="contiguous"):
        mk.trace_fused_sel(o.double(), d, scene, k, 5)
    with pytest.raises(RendererError, match="shape"):
        mk.trace_fused_sel(o, d, scene, k, 5, urand=torch.rand((3, R), device=cuda))
    with pytest.raises(RendererError, match="o on cuda"):
        mk.trace_fused_sel(o, d, scene, k, 5, urand=torch.rand((12, R)))
    with pytest.raises(RendererError, match="max_depth"):
        mk.trace_fused_sel(o, d, scene, k, mk.MAX_DEPTH + 1)
    _, sel = mk.trace_fused_sel(o, d, scene, k, 5)
    table, T, sky6 = path_replay.build_table(pkt)
    dcol = torch.ones((R, 3), device=cuda)
    with pytest.raises(RendererError, match="contiguous"):
        fg.fused_bwd(table, sky6, o, d, sel.long(), dcol, k, 5, T)
    with pytest.raises(RendererError, match="shape"):
        fg.fused_bwd(table, sky6, o, d, sel[:3], dcol, k, 5, T)
    with pytest.raises(RendererError, match="o on cuda"):
        fg.fused_bwd(table.cpu(), sky6, o, d, sel, dcol, k, 5, T)
    with pytest.raises(RendererError, match="table rows"):
        fg.fused_bwd(torch.zeros((200, 27), device=cuda), sky6, o, d, sel, dcol, k, 5, T)


# ---- the wavefront kernels (triangle-scale scenes) --------------------------------
# Tolerances as in chip_smoke.py phases 9-10: the slab test has no a*b+c, so
# the verdicts are equal; the bounce kernel contracts FMAs, so a grazing ray
# can take another primitive: >= 99.9 % of the next-state values within
# 1e-4, at most 1e-5 of the rays (rounded up) beyond it, dead rays bit for bit.


def _wave_setup(dev, W=256, H=128, B=5):
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.config4_mixed_scene(64, 32).build_packet().to(dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    scene = wf.prepare_scene(pkt, screen_cam=cam)
    px, py = pt.pixel_grid(H, W, dev)
    jit = torch.rand((H * W, 2), device=dev, generator=torch.Generator(dev).manual_seed(2))
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, jit - 0.5))
    k = mk.TraceConsts.from_config(cfg)
    state, ids, short0 = wf.primary_state(o, d, scene, (H, W))
    assert short0 is not None
    state = wf.wave_bounce(state, ids, *short0, scene, k, 0, 9, 1)
    perm = wf.coherence_order(state, scene)
    return cfg, pkt, cam, scene, k, state[:, perm].contiguous(), ids[perm].contiguous()


def test_wave_mask_kernel_matches_plain_version(cuda):
    _, _, _, scene, k, state, _ = _wave_setup(cuda)
    before = wf.mask_launches
    got = wf.wave_mask(state, scene.boxes, k.t_min)
    want = wf.wave_mask_reference(state, scene.boxes, k.t_min)
    torch.cuda.synchronize()
    assert wf.mask_launches == before + 1
    assert torch.equal(got, want) and bool(got.any()) and not bool(got.all())


@pytest.mark.parametrize("external", [True, False])
def test_wave_bounce_kernel_matches_plain_version(cuda, external):
    cfg, _, _, scene, k, state, ids = _wave_setup(cuda)
    R = state.shape[1]
    urand = torch.rand((2 + 2 * cfg.max_depth, R), device=cuda) if external else None
    short, cnt = wf.shortlists_from_mask(wf.wave_mask(state, scene.boxes, k.t_min))
    before = wf.bounce_launches
    got = wf.wave_bounce(state, ids, short, cnt, scene, k, 1, 9, 1, urand)
    want = wf.wave_bounce_reference(state, ids, short, cnt, scene, k, 1, 9, 1, urand)
    torch.cuda.synchronize()
    assert wf.bounce_launches == before + 1
    err = (got - want).abs()
    assert float((err <= 1e-4).float().mean()) >= 0.999
    assert int((err > 1e-4).any(dim=0).sum()) <= math.ceil(1e-5 * R)
    dead = state[9] < 0.5
    assert bool(dead.any()) and torch.equal(got[:, dead], state[:, dead])


def test_render_step_triangle_scene_goes_through_wavefront_kernels(cuda):
    W, H = 256, 128
    cfg = RenderConfig(width=W, height=H, max_depth=5)
    pkt = demo.config4_mixed_scene(64, 32).build_packet().to(cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    before = (wf.mask_launches, wf.bounce_launches, wf.live_bounces, wf.binned_bounces,
              rk.launches)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, cuda), 3, cfg, spp=2)
    torch.cuda.synchronize()
    masks, bounces, live, binned, renders = (
        a - b for a, b in zip((wf.mask_launches, wf.bounce_launches, wf.live_bounces,
                               wf.binned_bounces, rk.launches), before))
    assert renders == 0 and binned == 2 and 2 < live <= 2 * cfg.max_depth
    assert bounces == live and masks == live - binned
    lin = acc.linear
    assert bool(torch.isfinite(lin).all()) and 0.0 <= float(lin.min()) <= float(lin.max()) <= 1.0 + 1e-6
    # the same step with the plain versions on the CPU, same seed and draws
    ref = pt.render_step(pkt.to("cpu"), cam, pt.AccumState.create(H, W), 3, cfg, spp=2)
    d = (lin.cpu() - ref.linear).abs()
    assert float((d <= 1e-4).float().mean()) >= 0.999
    assert int((d > 0.05).any(dim=-1).sum()) <= math.ceil(1e-5 * W * H * 2)


def test_wavefront_wrappers_reject_bad_inputs(cuda):
    _, _, _, scene, k, state, ids = _wave_setup(cuda, W=64, H=32)
    with pytest.raises(RendererError, match="contiguous"):
        wf.wave_mask(state.double(), scene.boxes, k.t_min)
    with pytest.raises(RendererError, match="lanes"):
        wf.wave_mask(state, scene.boxes, k.t_min, lanes=512)
    short, cnt = wf.all_leaves(state.shape[1] // wf.LANES, scene.n_leaf, cuda)
    with pytest.raises(RendererError, match="contiguous"):
        wf.wave_bounce(state, ids.long(), short, cnt, scene, k, 0)
    with pytest.raises(RendererError, match="shape"):
        wf.wave_bounce(state, ids, short, cnt[:1], scene, k, 0)
    with pytest.raises(RendererError, match="state on cuda"):
        wf.wave_bounce(state, ids.cpu(), short, cnt, scene, k, 0)
