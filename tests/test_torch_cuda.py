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

import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

from ptre_tpu_torch.utils.config import RenderConfig
from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import fused_grad as fg
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import raster_kernel as rast
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
from ptre_tpu_torch.ops.cuda import soft_raster as sr
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import rasterizer as ras
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils.config import RasterConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _setup(dev, W, H, max_depth=5):
    cfg = RenderConfig(width=W, height=H, max_depth=max_depth)
    packed = mk.pack_scene(demo.reference_demo_scene(16, 8).build_packet(device=dev))
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
    pkt = demo.reference_demo_scene(16, 8).build_packet(device=cuda)
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
    pkt = demo.reference_demo_scene(16, 8).build_packet(device=dev)
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
    # each sample's forward runs again in its recompute (remat_bounces)
    assert (mk.record_launches, fg.launches) == (before[0] + 6, before[1] + 3)
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
    with pytest.raises(RendererError, match="sph_offset"):
        fg.fused_bwd(torch.zeros((200, 27), device=cuda), sky6, o, d, sel, dcol, k, 5, 201)


# ---- the replay route's kernels (grad_sweep="replay") ---------------------------
# Tolerances as in chip_smoke.py phase 21: the kernels replay fixed
# selections and are built without FMA contraction, so the forward's colour
# is within 1e-4 of the plain version on every ray (measured bit-equal); the
# backward's adjoint rounds otherwise than autograd: held as the fused
# backward above.


def _replay_setup(dev, external):
    cfg, pkt, cam, params, o, d, scene, k = _grad_setup(dev)
    R = o.shape[0]
    urand = (torch.rand((12, R), device=dev, generator=torch.Generator(dev).manual_seed(6))
             if external else None)
    _, sel = mk.trace_fused_sel(o, d, scene, k, 5, 9, 1, urand)
    table, T, sky6 = path_replay.build_table(pkt)
    return o, d, sel, urand, table, T, sky6, k


def _hold_replay_plain(got, ref, R):
    """The replay backward's d(o), d(d) against the plain version's: at most
    1e-4 of the rays (rounded up) flipped, >= 99.9 % of the entries within
    1e-4 of the largest. Returns the flipped rays."""
    ray_err = ((got[0] - ref[0]).abs() + (got[1] - ref[1]).abs()).amax(dim=1)
    ray_mag = (ref[0].abs() + ref[1].abs()).amax(dim=1)
    flip = ray_err > 1e-2 * ray_mag + 1e-3
    assert int(flip.sum()) <= math.ceil(1e-4 * R)
    for a, b in ((got[0], ref[0]), (got[1], ref[1])):
        assert float(((a - b).abs() <= 1e-4 * b.abs().max()).float().mean()) >= 0.999
    return flip


@pytest.mark.parametrize("external", [True, False])
def test_replay_kernels_match_plain_versions(cuda, external):
    o, d, sel, urand, table, T, sky6, k = _replay_setup(cuda, external)
    R = o.shape[0]
    g = path_replay.gather_rows(table, sel)
    before = (rpk.fwd_launches, rpk.bwd_launches)
    color = rpk.replay_fwd(o, d, g, sel, sky6, T, k, 5, 9, 1, urand)
    want = rpk.replay_fwd_reference(o, d, g, sel, sky6, T, k, 5, 9, 1, urand)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(color).all()) and float((color - want).abs().max()) <= 1e-4
    dcol = torch.randn((R, 3), device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    got = rpk.replay_bwd(o, d, g, sel, sky6, dcol, T, k, 5, 9, 1, urand)
    ref = rpk.replay_bwd_reference(o, d, g, sel, sky6, dcol, T, k, 5, 9, 1, urand)
    torch.cuda.synchronize()
    assert (rpk.fwd_launches, rpk.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert bool((got[2][sel < 0] == 0).all())  # nothing reaches the gather from a miss
    flip = _hold_replay_plain(got, ref, R)
    # material and sky gradients, d(g) summed to d(table), without the flipped rays
    cot = torch.where(flip[:, None], 0.0, dcol)
    got = rpk.replay_bwd(o, d, g, sel, sky6, cot, T, k, 5, 9, 1, urand)
    ref = rpk.replay_bwd_reference(o, d, g, sel, sky6, cot, T, k, 5, 9, 1, urand)
    hit = sel >= 0
    dtab = [torch.zeros_like(table).index_add_(0, sel[hit].long(), x[2][hit])
            for x in (got, ref)]
    for a, b in ((dtab[0][:, 23:27], dtab[1][:, 23:27]), (got[3], ref[3])):
        assert float((a - b).norm() / b.norm()) <= 1e-4


def test_replay_route_goes_through_the_replay_kernels(cuda):
    cfg, pkt, cam, params, _, _, _, _ = _grad_setup(cuda, W=160, H=90)
    cfg = dataclasses.replace(cfg, grad_sweep="replay")
    target = torch.zeros((160 * 90, 3), device=cuda)
    before = (mk.record_launches, rpk.fwd_launches, rpk.bwd_launches, fg.launches)
    loss, grads = train.mse_step(params, pkt, cam, target, cfg, seed=4, spp=3)
    torch.cuda.synchronize()
    after = (mk.record_launches, rpk.fwd_launches, rpk.bwd_launches, fg.launches)
    # each sample's forward, record and replay forward, again in its recompute
    assert tuple(a - b for a, b in zip(after, before)) == (6, 6, 3, 0)
    assert math.isfinite(float(loss)) and float(loss) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["mat_albedo"].abs().max()) > 0


def test_replay_core_on_cuda_launches_or_raises_never_the_plain_chain(cuda, monkeypatch):
    o, d, sel, _, table, T, sky6, k = _replay_setup(cuda, False)
    g = path_replay.gather_rows(table.detach().requires_grad_(True), sel)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain chain ran on CUDA tensors")

    monkeypatch.setattr(rpk, "replay_fwd_reference", no_plain)
    monkeypatch.setattr(rpk, "replay_bwd_reference", no_plain)
    before = (rpk.fwd_launches, rpk.bwd_launches)
    color = rpk.replay_core(o, d, g, sel, sky6, T, k, 5, 9, 1)
    color.sum().backward()
    torch.cuda.synchronize()
    assert (rpk.fwd_launches, rpk.bwd_launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(RendererError, match="contiguous"):
        rpk.replay_fwd(o, d, g.detach(), sel.long(), sky6, T, k, 5)
    with pytest.raises(RendererError, match="shape"):
        rpk.replay_fwd(o, d, g.detach()[:3], sel, sky6, T, k, 5)
    with pytest.raises(RendererError, match="o on cuda"):
        rpk.replay_bwd(o, d, g.detach(), sel, sky6, torch.ones((o.shape[0], 3)), T, k, 5)


@pytest.fixture(scope="module")
def first_replay():
    """The replay pair's first design (csrc/baseline/replay_pair/, built
    against the frozen headers there by chip_smoke.py's
    `start_baseline_build`) through the shipped C interface:
    (replay_fwd-like, replay_bwd-like)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    lib = chip_smoke.finish_unit_build(
        chip_smoke.start_baseline_build("replay_kernel.cu", "replay_pair"))
    return chip_smoke.lib_replay_pair(lib, rpk, mk)


@pytest.mark.parametrize("W,H", [(256, 128), (101, 37), (100, 37)])
@pytest.mark.parametrize("max_depth", [5, 8])
@pytest.mark.parametrize("external", [True, False])
def test_replay_kernels_equal_first_design(cuda, first_replay, W, H, max_depth, external):
    """The redesigned pair (warp slabs, dead tails skipped) equals the first
    design bit for bit in the colour, d(o), d(d) and d(g), d(sky) within
    1e-6 relative L2 (blocks of 4 warps, not 8), at R a multiple of 32, at
    R = 3,737 (neither of 32 nor of 4: scalar slabs only) and at R = 3,700
    (a multiple of 4 with a ragged last warp: float4 and scalar slabs in
    one launch); the same with d(g) written one float off 16-byte alignment
    (scalar slab stores, through the shipped C entry) and with g read one
    float off it; one launch each; within the plain versions' tolerances;
    d(g) zero where nothing was hit."""
    cfg, pkt, _, _, o, d, scene, k = _grad_setup(cuda, W=W, H=H, B=max_depth)
    R = o.shape[0]
    urand = (torch.rand((2 + 2 * max_depth, R), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2)) if external else None)
    _, sel = mk.trace_fused_sel(o, d, scene, k, max_depth, 9, 1, urand)
    table, T, sky6 = path_replay.build_table(pkt)
    g = path_replay.gather_rows(table, sel).detach()
    dcol = torch.randn((R, 3), device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    args = (o, d, g, sel, sky6, T, k, max_depth, 9, 1, urand)
    bargs = (o, d, g, sel, sky6, dcol, T, k, max_depth, 9, 1, urand)
    before = (rpk.fwd_launches, rpk.bwd_launches)
    color, got = rpk.replay_fwd(*args), rpk.replay_bwd(*bargs)
    assert (rpk.fwd_launches, rpk.bwd_launches) == (before[0] + 1, before[1] + 1)
    fcol, first = first_replay[0](*args), first_replay[1](*bargs)
    import chip_smoke
    from ptre_tpu_torch.ops.cuda import build

    def off16():  # a (B, R, 27) tensor 4 bytes off 16-byte alignment, NaN-filled
        return torch.full((g.numel() + 1,), float("nan"), device=cuda)[1:].view(g.shape)

    g_off = off16().copy_(g)
    got_off = rpk.replay_bwd(o, d, g_off, *bargs[3:])
    d_g_off = off16()
    shipped = chip_smoke.lib_replay_pair(build.load_library(), rpk, mk)
    got_dg_off = shipped[1](*bargs, d_g=d_g_off)
    torch.cuda.synchronize()
    assert torch.equal(color, fcol)
    for a, b in zip(got[:3], first[:3]):
        assert torch.equal(a, b)
    for a, b in zip(got_off[:3], got[:3]):
        assert torch.equal(a, b)
    assert got_dg_off[2].data_ptr() % 16 == 4
    for a, b in zip(got_dg_off[:3], got[:3]):
        assert torch.equal(a, b)
    assert float((got[3] - first[3]).norm() / first[3].norm()) <= 1e-6
    assert bool((got[2][sel < 0] == 0).all())
    want = rpk.replay_fwd_reference(*args)
    assert float((color - want).abs().max()) <= 1e-4
    _hold_replay_plain(got, rpk.replay_bwd_reference(*bargs), R)


# ---- the wavefront kernels (triangle-scale scenes) --------------------------------
# Tolerances as in chip_smoke.py phases 9-10: the slab test has no a*b+c, so
# the verdicts are equal; the bounce kernel contracts FMAs, so a grazing ray
# can take another primitive: >= 99.9 % of the next-state values within
# 1e-4, at most 1e-5 of the rays (rounded up) beyond it, dead rays bit for bit.


def _wave_setup(dev, W=256, H=128, B=5):
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.config4_mixed_scene(64, 32).build_packet(device=dev)
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


#: meshes past the staged mask instantiation's 1,024 leaves: BASELINE config
#: 3's uv-sphere at 320x128 (81,280 rows, 1,270 leaves) and 512x256
#: (261,120 rows, 4,080 leaves)
PAST_1024 = {"1270 leaves": (320, 128), "4080 leaves": (512, 256)}


@pytest.mark.parametrize("mesh", list(PAST_1024))
def test_wave_mask_past_1024_leaves_matches_plain_version(cuda, mesh):
    """The global instantiation (boxes and supertile boxes read through
    L1/L2) on the sorted bounce-1 state: verdicts equal to the plain
    version's, with the scene's supertile table and with the wrapper's own,
    and from the counting instantiation, which counts every live ray."""
    segments, rings = PAST_1024[mesh]
    W, H = 256, 128
    k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H))
    pkt = demo.config3_scene(False, segments, rings, diffuse=True).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    scene = wf.prepare_scene(pkt, screen_cam=cam)
    assert scene.n_leaf > 1024 and wf.supports(pkt)
    px, py = pt.pixel_grid(H, W, cuda)
    jit = torch.rand((H * W, 2), device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, jit - 0.5))
    state, ids, short0 = wf.primary_state(o, d, scene, (H, W))
    state = wf.wave_bounce(state, ids, *short0, scene, k, 0, 9, 1)
    state = state[:, wf.coherence_order(state, scene)].contiguous()
    before = wf.mask_launches
    got = wf.wave_mask(state, scene.boxes, k.t_min, supers=scene.mask_supers)
    own = wf.wave_mask(state, scene.boxes, k.t_min)
    stats = torch.zeros(len(wf.MASK_STATS), dtype=torch.int64, device=cuda)
    counted = wf.wave_mask(state, scene.boxes, k.t_min, stats=stats, supers=scene.mask_supers)
    want = wf.wave_mask_reference(state, scene.boxes, k.t_min)
    torch.cuda.synchronize()
    assert wf.mask_launches == before + 3
    assert torch.equal(got, want) and torch.equal(own, want) and torch.equal(counted, want)
    assert bool(got.any()) and not bool(got.all())
    sup_tests, leaf_tests, live = stats.tolist()
    n_live = int((state[9] > 0.5).sum())
    assert live == n_live and 0 < sup_tests <= n_live * scene.mask_supers.shape[0]
    assert 0 < leaf_tests <= n_live * scene.n_leaf


def test_wavefront_trace_at_65024_rows_matches_plain_version(cuda):
    """`wavefront.trace` with the kernels against its plain version, both on
    the card, on the 65,024-row mesh (1,016 leaves, past the reference's
    49,152-row cap): eight rows of a 1920x1080 camera's pixels, five
    bounces, Philox draws; the mask runs at every bounce (no screen
    binning). Tolerance as the bounce kernel's: >= 99.9 % of the colour
    channels within 1e-4, rays beyond it on at most 1e-4 of them (rounded
    up), which is where FMA contraction flipped a grazing ray."""
    W, H, rows = 1920, 1080, slice(536 * 1920, 544 * 1920)
    cfg = RenderConfig(width=W, height=H, max_depth=5)
    k = mk.TraceConsts.from_config(cfg)
    pkt = demo.config3_scene(False, 256, 128, diffuse=True).build_packet(device=cuda)
    assert pkt.tri_valid.shape[0] == 65024 and pt.route(pkt, cfg) == "wavefront"
    cam = cam_ops.Camera.create(width=W, height=H)
    scene = wf.prepare_scene(pkt)
    px, py = pt.pixel_grid(H, W, cuda)
    o, d = (x[rows].contiguous() for x in cam_ops.get_rays(
        cam, px, py, torch.zeros((W * H, 2), device=cuda)))
    before = (wf.mask_launches, wf.bounce_launches)
    got = wf.trace(o, d, scene, k, cfg.max_depth, seed=11, sample=2)
    torch.cuda.synchronize()
    masks, bounces = (a - b for a, b in zip((wf.mask_launches, wf.bounce_launches), before))
    assert masks == bounces >= 2
    want = wf.trace(o, d, scene, k, cfg.max_depth, seed=11, sample=2, plain=True)
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all()) and float(got.max()) > 0.05
    assert float((err <= 1e-4).float().mean()) >= 0.999
    assert int((err > 1e-4).any(dim=1).sum()) <= math.ceil(1e-4 * o.shape[0])


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
    pkt = demo.config4_mixed_scene(64, 32).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    before = (wf.mask_launches, wf.bounce_launches, wf.live_bounces, wf.binned_bounces,
              rk.launches, wf.shortlists_on_card, wf.shortlists_sorted)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, cuda), 3, cfg, spp=2)
    torch.cuda.synchronize()
    masks, bounces, live, binned, renders, on_card, sorted_ = (
        a - b for a, b in zip((wf.mask_launches, wf.bounce_launches, wf.live_bounces,
                               wf.binned_bounces, rk.launches, wf.shortlists_on_card,
                               wf.shortlists_sorted), before))
    # every bounce is launched, with live rays or not (no host read decides)
    assert renders == 0 and binned == 2 and live == 2 * cfg.max_depth
    assert bounces == live and masks == live - binned
    # every bounce's shortlists written on the card, none sorted
    assert on_card == live and sorted_ == 0
    lin = acc.linear
    assert bool(torch.isfinite(lin).all()) and 0.0 <= float(lin.min()) <= float(lin.max()) <= 1.0 + 1e-6
    # the same step with the plain versions on the CPU, same seed and draws
    ref = pt.render_step(pkt.to("cpu"), cam.to("cpu"), pt.AccumState.create(H, W, device="cpu"),
                         3, cfg, spp=2)
    d = (lin.cpu() - ref.linear).abs()
    assert float((d <= 1e-4).float().mean()) >= 0.999
    assert int((d > 0.05).any(dim=-1).sum()) <= math.ceil(1e-5 * W * H * 2)


def test_wavefront_wrappers_reject_bad_inputs(cuda):
    _, _, _, scene, k, state, ids = _wave_setup(cuda, W=64, H=32)
    with pytest.raises(RendererError, match="contiguous"):
        wf.wave_mask(state.double(), scene.boxes, k.t_min)
    with pytest.raises(RendererError, match="lanes"):
        wf.wave_mask(state, scene.boxes, k.t_min, lanes=512)
    with pytest.raises(RendererError, match="contiguous"):
        wf.wave_mask_lists(state.double(), scene.boxes, k.t_min)
    with pytest.raises(RendererError, match="lanes"):
        wf.wave_mask_lists(state, scene.boxes, k.t_min, lanes=512)
    with pytest.raises(RendererError, match="bool mask"):
        wf.shortlists_from_mask(torch.ones((2, scene.n_leaf), dtype=torch.uint8, device=cuda))
    short, cnt = wf.all_leaves(state.shape[1] // wf.LANES, scene.n_leaf, device=cuda)
    with pytest.raises(RendererError, match="contiguous"):
        wf.wave_bounce(state, ids.long(), short, cnt, scene, k, 0)
    with pytest.raises(RendererError, match="shape"):
        wf.wave_bounce(state, ids, short, cnt[:1], scene, k, 0)
    with pytest.raises(RendererError, match="state on cuda"):
        wf.wave_bounce(state, ids.cpu(), short, cnt, scene, k, 0)


# ---- triangle-scale training: culled megakernel, record mode, global-table backward --
# Tolerances as in chip_smoke.py phases 15-17. The culled megakernel and the
# wavefront run the same device functions, and culling is conservative, so
# they agree except where float rounding puts a hit on the edge of a leaf's
# box; against the plain version FMA contraction can flip a grazing ray as
# in the bounce kernel. The recording bounce kernel's state is the
# non-recording one's bit for bit. The global-table backward is held as the
# dense one is. A whole multi-bounce trace is held per ray (colour within 1e-4
# relative and every bounce's selection equal); at 32,768 rays chip_smoke.py's
# 1e-5 of the rays rounds to one ray, so these tests allow 1e-4 of them.


def _tri_rays(dev, W=256, H=128, B=4):
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.config4_mixed_scene(64, 32).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    scene = wf.prepare_scene(pkt, screen_cam=cam)
    px, py = pt.pixel_grid(H, W, dev)
    jit = torch.rand((H * W, 2), device=dev, generator=torch.Generator(dev).manual_seed(2))
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, jit - 0.5))
    return cfg, pkt, cam, scene, mk.TraceConsts.from_config(cfg), o, d


def _flipped(color, want, sel=None, want_sel=None):
    flip = ((color - want).abs() > 1e-4 * want.abs().clamp_min(1.0)).any(dim=1)
    if sel is not None:
        flip |= (sel != want_sel).any(dim=0)
    return flip


#: The external uniforms' seed: a torch.Generator on the card, so the test
#: reads one draw. Over seeds 0-199 (`chip_ablations.py culled_flips`, NVIDIA
#: H100 80GB HBM3, 700 W) the kernel flipped 0-4 of these 32,768 rays
#: against its plain version with external uniforms (mean 0.805; 0-4, mean
#: 0.94, with its Philox in place of the seed 9), culling on or off alike,
#: and 0 against the wavefront; 94 % were colour-only (the same selection at
#: every bounce, a colour beyond 1e-4 relative: float32 rounding amplified
#: along the path, ROADMAP C2), the rest a triangle for another after a
#: sphere. Three launches were bit-equal in every draw, and every output
#: was bit-equal again after the card suite had run in the same process.
#: 200 unseeded draws there read 0-5 (mean 0.925): an unseeded draw exceeds
#: the allowance about once in 200. Seed 5 reads 2 flips, so the allowance,
#: ceil(1e-4 R) = 4, is twice this draw's count.
CULLED_SEED = 5


@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("cull", [True, False])
def test_culled_megakernel_matches_plain_version(cuda, external, cull):
    cfg, pkt, _, scene, k, o, d = _tri_rays(cuda)
    R, B = o.shape[0], cfg.max_depth
    urand = (torch.rand((2 + 2 * B, R), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(CULLED_SEED))
             if external else None)
    before = mk.culled_launches
    color, sel = mk.trace_culled(o, d, scene, k, B, 9, 1, urand, cull=cull, record=True)
    again, sel_again = mk.trace_culled(o, d, scene, k, B, 9, 1, urand, cull=cull, record=True)
    plain = mk.trace_culled(o, d, scene, k, B, 9, 1, urand, cull=cull)
    want, want_sel = mk.trace_culled_reference(o, d, scene, k, B, 9, 1, urand, cull=cull,
                                               record=True)
    torch.cuda.synchronize()
    assert mk.culled_launches == before + 3
    assert torch.equal(plain, color)  # recording changes no colour
    assert torch.equal(again, color) and torch.equal(sel_again, sel)  # nor does a repeat
    assert bool(torch.isfinite(color).all())
    assert bool(((sel >= -1) & (sel < scene.tri_rows + scene.n_sph)).all())
    assert int((sel >= 0).sum()) > R // 4
    assert int(_flipped(color, want, sel, want_sel).sum()) <= math.ceil(1e-4 * R)
    # the same rays through the wavefront kernels
    wcol, wsel, _ = wf.trace(o, d, scene, k, B, 9, 1, urand,
                             tile_hint=(cfg.height, cfg.width), record=True)
    assert int(_flipped(color, wcol, sel, wsel).sum()) <= math.ceil(1e-4 * R)


def test_wave_record_mode_matches_plain_and_leaves_state_alone(cuda):
    cfg, _, _, scene, k, state, ids = _wave_setup(cuda)
    R = state.shape[1]
    short, cnt = wf.shortlists_from_mask(wf.wave_mask(state, scene.boxes, k.t_min))
    sel = torch.full((cfg.max_depth, R), -1, dtype=torch.int32, device=cuda)
    want_sel = sel.clone()
    got = wf.wave_bounce(state, ids, short, cnt, scene, k, 1, 9, 1, sel=sel)
    same = wf.wave_bounce(state, ids, short, cnt, scene, k, 1, 9, 1)
    wf.wave_bounce_reference(state, ids, short, cnt, scene, k, 1, 9, 1, sel=want_sel)
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    assert bool((sel[[0, 2, 3, 4]] == -1).all()) and int((sel[1] >= 0).sum()) > 0
    assert int((sel != want_sel).any(dim=0).sum()) <= math.ceil(1e-5 * R)
    dead = ids[state[9] < 0.5].long()
    assert bool((sel[1, dead] == -1).all())


def test_global_table_backward_matches_plain_version(cuda):
    cfg, pkt, _, scene, k, o, d = _tri_rays(cuda)
    R, B = o.shape[0], cfg.max_depth
    color, sel, perm = wf.trace(o, d, scene, k, B, 9, 1, tile_hint=(cfg.height, cfg.width),
                                record=True)
    table, T, sky6 = path_replay.build_table(pkt)
    table = torch.cat([table[:T][perm], table[T:]]).contiguous()
    assert table.shape[0] > fg.MAX_ROWS
    dcol = torch.randn((R, 3), device=cuda, generator=torch.Generator(cuda).manual_seed(8))
    before = fg.launches
    got = fg.fused_bwd(table, sky6, o, d, sel, dcol, k, B, T, 9, 1)
    want = fg.fused_bwd_reference(table, sky6, o, d, sel, dcol, k, B, T, 9, 1)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    for g in got:
        assert bool(torch.isfinite(g).all())
    mag = (want[2].abs() + want[3].abs()).amax(dim=1)
    err = ((got[2] - want[2]).abs() + (got[3] - want[3]).abs()).amax(dim=1)
    flip = err > 1e-2 * mag + 1e-3
    assert int(flip.sum()) <= math.ceil(1e-4 * R)
    top = float(want[2].abs().max())
    assert float(((got[2] - want[2]).abs() <= 1e-4 * top).float().mean()) >= 0.999
    # summed gradients without the flipped rays: materials and sky tight
    # (the geometry columns carry float32 noise, chip_smoke.py holds them to
    # the float64 evaluation)
    cot = torch.where(flip[:, None], 0.0, dcol)
    got = fg.fused_bwd(table, sky6, o, d, sel, cot, k, B, T, 9, 1)
    want = fg.fused_bwd_reference(table, sky6, o, d, sel, cot, k, B, T, 9, 1)
    for a, b in ((got[0][:, 23:27], want[0][:, 23:27]), (got[1], want[1])):
        assert float((a - b).norm() / b.norm()) <= 1e-4
    assert float(got[0][:T, :9].abs().max()) > 0 and float(got[0][T:, 18:22].abs().max()) > 0


@pytest.fixture(scope="module")
def first_designs():
    """The first designs of the fused backward and the mask kernel
    (csrc/baseline/), built by chip_smoke.py's yardstick builder and called
    through their own C interfaces: (fused_bwd-like, wave_mask-like)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    libs = {u: chip_smoke.finish_unit_build(chip_smoke.start_baseline_build(u))
            for u in ("fused_grad_kernel.cu", "mask_kernel.cu")}
    return (chip_smoke.baseline_fused_bwd(libs["fused_grad_kernel.cu"], fg, mk),
            chip_smoke.baseline_wave_mask(libs["mask_kernel.cu"], wf, mk))


@pytest.mark.parametrize("max_depth", [5, 8])
@pytest.mark.parametrize("table_kind", ["dense", "global"])
@pytest.mark.parametrize("external", [True, False])
def test_backward_kernel_equals_first_design_bit_for_bit(cuda, first_designs, table_kind,
                                                         external, max_depth):
    """d(o), d(d) of both instantiations equal the first design's bit for
    bit (the same chain and adjoint, no operation reordered), at max_depth 5
    and at the deepest the wrapper takes; d(table) and d(sky), summed by
    atomics in another order, within 1e-5 relative L2."""
    if table_kind == "dense":
        cfg, pkt, _, _, o, d, scene, k = _grad_setup(cuda)
        urand = (torch.rand((2 + 2 * max_depth, o.shape[0]), device=cuda)
                 if external else None)
        _, sel = mk.trace_fused_sel(o, d, scene, k, max_depth, 9, 1, urand)
        table, T, sky6 = path_replay.build_table(pkt)
    else:
        cfg, pkt, _, scene, k, o, d = _tri_rays(cuda)
        urand = (torch.rand((2 + 2 * max_depth, o.shape[0]), device=cuda)
                 if external else None)
        _, sel, perm = wf.trace(o, d, scene, k, max_depth, 9, 1, urand,
                                tile_hint=(cfg.height, cfg.width), record=True)
        table, T, sky6 = path_replay.build_table(pkt)
        table = torch.cat([table[:T][perm], table[T:]]).contiguous()
    assert (table.shape[0] > fg.MAX_ROWS) == (table_kind == "global")
    dcol = torch.randn((o.shape[0], 3), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(4))
    args = (table, sky6, o, d, sel, dcol, k, max_depth, T, 9, 1, urand)
    got, first = fg.fused_bwd(*args), first_designs[0](*args)
    torch.cuda.synchronize()
    assert torch.equal(got[2], first[2]) and torch.equal(got[3], first[3])
    for a, b in ((got[0], first[0]), (got[1], first[1])):
        assert got[0].shape == first[0].shape
        assert float((a - b).norm() / b.norm()) <= 1e-5


@pytest.mark.parametrize("scene_name", ["config3", "config4"])
def test_wave_mask_every_bounce_equals_plain_and_first_design(cuda, first_designs, scene_name):
    """Every live bounce after the first of a sample (the sorted states the
    trace hands the mask): verdicts equal to the plain version's and the
    first design's; the counting instantiation gives the same verdicts and
    counts every live ray."""
    import chip_smoke

    config = {"config3": ("config 3", ("config3_scene", dict(segments=64, rings=32)), 128, 128),
              "config4": ("config 4", ("config4_mixed_scene", dict(segments=64, rings=32)),
                          256, 128)}[scene_name]
    _, _, scene, k, _, _, _, states = chip_smoke.mask_states(cuda, config)
    assert len(states) >= 1
    for b, state, _ in states:
        want = wf.wave_mask_reference(state, scene.boxes, k.t_min)
        counts = torch.zeros(len(wf.MASK_STATS), dtype=torch.int64, device=cuda)
        got = wf.wave_mask(state, scene.boxes, k.t_min)
        counted = wf.wave_mask(state, scene.boxes, k.t_min, stats=counts)
        first = first_designs[1](state, scene.boxes, k.t_min)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(first, want) and torch.equal(counted, want)
        n_live = int((state[9] > 0.5).sum())
        n_super = -(-scene.n_leaf // mk.SUPER)
        assert int(counts[2]) == n_live and 0 < int(counts[0]) <= n_live * n_super
        assert int(counts[1]) <= n_live * scene.n_leaf


@pytest.fixture(scope="module")
def lane_bounce():
    """The bounce unit as shipped before the warp sweep (csrc/baseline/
    wave_lane/: each passing ray swept on its own lane from rows staged in
    shared memory), built against the shipped headers by chip_smoke.py's
    `start_wave_lane_build`, as a function of `wave_bounce`'s arguments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    lib = chip_smoke.finish_unit_build(chip_smoke.start_wave_lane_build())
    return chip_smoke.lib_wave_bounce(lib, wf)


#: config 4's scene and the meshes past the reference's row cap: the
#: 65,024-row uv-sphere (1,016 leaves) and the 4,080-leaf one
WAVE_LANE_SCENES = {
    "config4": ("config4_mixed_scene", dict(segments=128, rings=64)),
    "65024 rows": ("config3_scene", dict(flat=False, segments=256, rings=128, diffuse=True)),
    "4080 leaves": ("config3_scene", dict(flat=False, segments=512, rings=256, diffuse=True)),
}


@pytest.mark.parametrize("mesh", list(WAVE_LANE_SCENES))
@pytest.mark.parametrize("external", [True, False])
def test_wave_bounce_equals_parent_unit(cuda, lane_bounce, mesh, external):
    """Next states and selections of both instantiations bit for bit the
    parent unit's, at every bounce of a 480x272 sample of config 4's scene
    (the screen-binned bounce 0, then the masked, sorted states) and at
    bounce 1 of the meshes past the row cap: the per-ray cull is the same,
    and the warp's (t, row) minimum is sweep_leaf's. The counting
    instantiation gives the same state; at bounce 1 its live rays and box
    tests equal the plain version's, its pairs passed within
    chip_smoke.COUNT_REL."""
    import chip_smoke

    W, H, B = 480, 272, 5  # whole 8x32 pixel tiles: bounce 0 is screen-binned
    R = W * H
    _, _, scene, k, o, d, short0, states = chip_smoke.mask_states(
        cuda, (mesh, WAVE_LANE_SCENES[mesh], W, H))
    bounces = [(b, state, ids, *wf.shortlists_from_mask(wf.wave_mask(
        state, scene.boxes, k.t_min, supers=scene.mask_supers))) for b, state, ids in states]
    if mesh == "config4":
        state0, ids0, _ = wf.primary_state(o, d, scene, (H, W))
        bounces = [(0, state0, ids0, *short0)] + bounces
        assert len(bounces) == B
    else:
        bounces = bounces[:1]
    urand = (torch.rand((2 + 2 * B, R), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(6)) if external else None)
    for b, state, ids, short, cnt in bounces:
        sel, lane_sel = (torch.full((B, R), -1, dtype=torch.int32, device=cuda)
                         for _ in range(2))
        got = wf.wave_bounce(state, ids, short, cnt, scene, k, b, 9, 1, urand, sel=sel)
        want = lane_bounce(state, ids, short, cnt, scene, k, b, 9, 1, urand, sel=lane_sel)
        plain = wf.wave_bounce(state, ids, short, cnt, scene, k, b, 9, 1, urand)
        lane_plain = lane_bounce(state, ids, short, cnt, scene, k, b, 9, 1, urand)
        stats = torch.zeros(len(wf.BOUNCE_STATS), dtype=torch.int64, device=cuda)
        counted = wf.wave_bounce(state, ids, short, cnt, scene, k, b, 9, 1, urand, stats=stats)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(sel, lane_sel), b
        assert torch.equal(plain, got) and torch.equal(lane_plain, got), b
        assert torch.equal(counted, got), b
        assert int((sel[b] >= 0).sum()) > 0 and bool((sel[b + 1:] == -1).all())
        if b == 1:
            count = {}
            wf.wave_bounce_reference(state, ids, short, cnt, scene, k, b, 9, 1, urand,
                                     stats=count)
            st = dict(zip(wf.BOUNCE_STATS, stats.tolist()))
            assert st["ray_bounces"] == count["ray_bounces"] > 0
            assert st["listed_tests"] == count["listed_tests"]
            assert abs(st["own_pairs"] - count["own_pairs"]) <= (
                chip_smoke.COUNT_REL * count["own_pairs"])
            assert 0 < st["warp_visits"] <= st["own_pairs"] <= st["lane_slots"]


def test_trace_bounce_stats_on_the_card_match_plain_version(cuda, monkeypatch):
    """`trace(bounce_stats=)` counts on the card with no synchronizing call,
    changes no colour, and its counters are within chip_smoke.COUNT_REL of
    the plain trace's on the same rays and draws (a ray that FMA
    contraction flips may live one bounce more or less)."""
    import chip_smoke

    cfg, _, _, scene, k, o, d = _tri_rays(cuda)
    args = (o, d, scene, k, cfg.max_depth, 9, 1)
    color = wf.trace(*args, tile_hint=(cfg.height, cfg.width))
    stats = torch.zeros(len(wf.BOUNCE_STATS), dtype=torch.int64, device=cuda)
    counted = _without_synchronize(
        monkeypatch, lambda: wf.trace(*args, tile_hint=(cfg.height, cfg.width),
                                      bounce_stats=stats), "trace(bounce_stats=)")
    plain = torch.zeros_like(stats)
    wf.trace(*args, tile_hint=(cfg.height, cfg.width), plain=True, bounce_stats=plain)
    torch.cuda.synchronize()
    assert torch.equal(counted, color)
    st, want = (dict(zip(wf.BOUNCE_STATS, t.tolist())) for t in (stats, plain))
    assert st["ray_bounces"] > o.shape[0]
    for key in ("ray_bounces", "listed_tests", "own_pairs"):
        assert abs(st[key] - want[key]) <= chip_smoke.COUNT_REL * want[key], key


def test_mse_step_triangle_scene_goes_through_the_kernels(cuda):
    W, H = 256, 128
    cfg = RenderConfig(width=W, height=H, max_depth=4)
    pkt = demo.config4_mixed_scene(64, 32).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    params = sh.differentiable_params(pkt, cam)
    target = torch.zeros((W * H, 3), device=cuda)
    before = (wf.bounce_launches, wf.live_bounces, fg.launches, mk.record_launches)
    loss, grads = train.mse_step(params, pkt, cam, target, cfg, seed=4, spp=2)
    torch.cuda.synchronize()
    bounces, live, bwd, rec = (a - b for a, b in zip(
        (wf.bounce_launches, wf.live_bounces, fg.launches, mk.record_launches), before))
    # each sample's bounces again in its recompute (remat_bounces), every
    # bounce launched
    assert bounces == live == 4 * cfg.max_depth and bwd == 2 and rec == 0
    assert math.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["transforms"].abs().max()) > 0
    cpu = {key: v.cpu() for key, v in params.items()}
    loss_c, grads_c = train.mse_step(cpu, pkt.to("cpu"), cam, target.cpu(), cfg, seed=4, spp=2)
    assert abs(float(loss) - float(loss_c)) <= 1e-4 * float(loss_c)
    for key in ("mat_albedo", "sky_top", "cam_position"):
        a, b = grads[key].cpu(), grads_c[key]
        assert float((a - b).norm() / b.norm()) <= 1e-2, key  # a flipped ray in 32,768


# ---- the rasterizer kernels -------------------------------------------------------
# Tolerances as in chip_smoke.py phases 12-14: coverage, z and the hard
# shading are never contracted, so the hard image equals the plain version's
# bit for bit; the soft terms past the barycentrics may contract, and the
# kernel sums a group in another order and takes the other branch of the
# stable sigmoid, so the soft image and residual content within 3e-5 (the
# kernel-vs-XLA bound of tests/test_dual_pipeline.py; measured 1.4e-5 at
# 300x180), and d(table), summed by float atomics in no fixed order, within
# 1e-4 relative L2, and each column group (soft_raster.GRAD_GROUPS) no
# further from the float64 plain version than twice the float32 plain
# version (or 1e-4 of the group's norm).


def _raster_setup(dev, W=200, H=120, ss=2, y0=0.0, stride=1, rows=None):
    cfg = RasterConfig(width=W, height=H, supersample=ss)
    pkt = demo.reference_demo_scene(16, 8).build_packet(spheres_as_triangles=True, device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    rows = H if rows is None else rows
    cols, cbox = sr._soft_cols(pkt, cam, cfg)
    return cfg, pkt, cam, cols.detach().contiguous(), cbox, rows * ss, W * ss, ss


@pytest.mark.parametrize("y0,stride,rows", [(0.0, 1, None), (3.0, 5, 23)])
def test_raster_kernel_matches_plain_version(cuda, y0, stride, rows):
    cfg, pkt, cam, cols, cbox, R, Wss, ss = _raster_setup(cuda, rows=rows)
    scal = rast.raster_scalars(cfg, 0.0, y0, stride)
    before = rast.launches
    got = rast.raster_tiles(cols, cbox, scal, R, Wss, ss)
    want = rast.raster_reference(cols, cbox, scal, R, Wss, ss)
    torch.cuda.synchronize()
    assert rast.launches == before + 1
    assert torch.equal(got, want)
    assert rast.visited_pairs(cbox, R, Wss, ss, y0, stride) > 0
    img = ras.rasterize(pkt, cam, cfg)
    assert img.shape == (cfg.height, cfg.width, 3) and rast.launches == before + 2


@pytest.mark.parametrize("sigma,y0,stride,rows", [(0.5, 0.0, 1, None), (2.0, 5.0, 3, 23)])
def test_soft_kernels_match_plain_versions(cuda, sigma, y0, stride, rows):
    cfg, pkt, cam, cols, cbox, R, Wss, ss = _raster_setup(cuda, W=150, H=90, rows=rows)
    box = sr.dilate(cbox, sigma)
    scal = rast.raster_scalars(cfg, 1.0 / sigma, y0, stride)
    before = (sr.fwd_launches, sr.bwd_launches)
    img, res = sr.soft_forward(cols, box, scal, R, Wss, ss)
    want_img, want_res = sr.soft_forward_reference(cols, box, scal, R, Wss, ss)
    torch.cuda.synchronize()
    assert float((img - want_img).abs().max()) <= 3e-5
    live = want_res[1] > 0
    assert torch.equal(res[1] > 0, live) and bool(live.any())
    for k in (2, 3, 4, 5):
        a = torch.where(live, res[k] / res[1].clamp_min(1e-30), 0.0)
        b = torch.where(live, want_res[k] / want_res[1].clamp_min(1e-30), 0.0)
        assert float((a - b).abs().max()) <= 3e-5
    dimg = torch.randn((3, R, Wss), device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    got = sr.soft_backward(cols, box, scal, want_res, dimg, R, Wss, ss)
    want = sr.soft_backward_reference(cols, box, scal, want_res, dimg, R, Wss, ss)
    torch.cuda.synchronize()
    assert (sr.fwd_launches, sr.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert float((got - want).norm() / want.norm()) <= 1e-4
    exact = sr.soft_backward_reference(cols.double(), box, scal, want_res.double(),
                                       dimg.double(), R, Wss, ss)
    for group, c in sr.GRAD_GROUPS.items():
        e_kernel = float((got.double() - exact)[:, c].norm())
        e_plain = float((want.double() - exact)[:, c].norm())
        assert e_kernel <= max(2.0 * e_plain, 1e-4 * float(exact[:, c].norm())), group


@pytest.mark.parametrize("sigma,y0,stride,rows", [(0.5, 0.0, 1, None), (2.0, 5.0, 3, 23)])
def test_soft_kernel_counters_equal_the_host_twins(cuda, tmp_path, sigma, y0, stride, rows):
    """The counting instantiations of both soft kernels against the g++ build
    of their bodies (csrc/host_raster.cpp) on the same inputs: visits, rows
    passing the row gate, pairs evaluated and pairs above the threshold
    equal; the outputs equal the shipped instantiations'."""
    import ctypes
    import os
    import shutil
    import subprocess

    from ptre_tpu_torch.ops.cuda import build

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no C++ compiler (g++) to build csrc/host_raster.cpp")
    so = str(tmp_path / "libptre_host_raster.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", so,
                    os.path.join(build.CSRC_DIR, "host_raster.cpp")], check=True)
    host = ctypes.CDLL(so)
    host.ptre_soft_fwd_host.restype = ctypes.c_longlong
    host.ptre_soft_fwd_host.argtypes = [ctypes.c_void_p] * 6

    cfg, pkt, cam, cols, cbox, R, Wss, ss = _raster_setup(cuda, W=150, H=90, rows=rows)
    box = sr.dilate(cbox, sigma)
    scal = rast.raster_scalars(cfg, 1.0 / sigma, y0, stride)
    f_stats = torch.zeros(len(sr.STATS), dtype=torch.int64, device=cuda)
    img, res = sr.soft_forward(cols, box, scal, R, Wss, ss, stats=f_stats)
    img0, res0 = sr.soft_forward(cols, box, scal, R, Wss, ss)
    dimg = torch.randn((3, R, Wss), device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    b_stats = torch.zeros(len(sr.STATS), dtype=torch.int64, device=cuda)
    sr.soft_backward(cols, box, scal, res, dimg, R, Wss, ss, stats=b_stats)
    torch.cuda.synchronize()
    assert torch.equal(img, img0) and torch.equal(res, res0)

    t_cpu, b_cpu = cols.cpu(), box.cpu()
    h_img, h_res = torch.empty((3, R, Wss)), torch.empty((6, R, Wss))
    h_stats = np.zeros(len(sr.STATS), np.int64)
    p = rast.raster_params(scal, R, Wss, ss, cbox.shape[0])
    host.ptre_soft_fwd_host(ctypes.addressof(p), t_cpu.data_ptr(), b_cpu.data_ptr(),
                            h_img.data_ptr(), h_res.data_ptr(), h_stats.ctypes.data)
    assert f_stats.tolist() == b_stats.tolist() == h_stats.tolist()
    assert h_stats[3] > 0


def test_raster_mse_step_goes_through_soft_kernels(cuda):
    cfg, pkt, cam, _, _, _, _, _ = _raster_setup(cuda, W=96, H=64)
    params = sh.differentiable_params(pkt, cam)
    target = torch.zeros((64, 96, 3), device=cuda)
    before = (sr.fwd_launches, sr.bwd_launches)
    loss, grads = train.raster_mse_step(params, pkt, cam, target, cfg)
    torch.cuda.synchronize()
    assert (sr.fwd_launches, sr.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert math.isfinite(float(loss)) and float(grads["transforms"].abs().max()) > 0
    cpu = {k: v.cpu() for k, v in params.items()}
    loss_c, grads_c = train.raster_mse_step(cpu, pkt.to("cpu"), cam, target.cpu(), cfg)
    assert abs(float(loss) - float(loss_c)) <= 1e-5 * float(loss_c)
    for key in ("transforms", "cam_position"):
        a, b = grads[key].cpu(), grads_c[key]
        assert float((a - b).norm() / b.norm()) <= 1e-3, key


def test_hard_raster_refuses_autograd_on_cuda(cuda):
    cfg, pkt, cam, cols, cbox, R, Wss, ss = _raster_setup(cuda, W=32, H=16)
    with pytest.raises(RendererError, match="forward-only"):
        rast.raster_tiles(cols.requires_grad_(True), cbox, rast.raster_scalars(cfg), R, Wss, ss)
    with pytest.raises(RendererError, match="shape"):
        rast.raster_tiles(cols[:-1].detach(), cbox, rast.raster_scalars(cfg), R, Wss, ss)


def _nine_material_packet():
    """The demo scene with 7 added materials (9 in all): the render kernel
    and the fused route take it by default; the tests below that feed the
    sweep force the staged route on it."""
    from ptre_tpu_torch.models.scene import Material, MaterialKind

    scn = demo.reference_demo_scene(8, 4)
    for i in range(7):
        scn.add_material(Material(MaterialKind.OREN_NAYAR, (0.1 * i, 0.5, 0.3), 0.5))
    scn.set_model_material("ground", 8)
    return scn.build_packet(device="cpu")


def _bounce1_rays(o, d, pkt, cfg, seed=3):
    """Bounce-1 rays of the staged route (the rays that hit and scatter),
    leaving from surfaces: their t_min self-hits exercise the sweep."""
    from ptre_tpu_torch.ops import intersect, materials, rng

    k = mk.TraceConsts.from_config(cfg)
    wt = pkt.world_triangles()
    hit = intersect.closest_hit(o, d, pkt, wt, k.t_min, k.t_max, k.det_eps)
    u = rng.ray_uniforms(seed, 1, o.shape[0], 2, o.device)
    s = materials.scatter(u[2], u[3], d, hit.position, hit.normal,
                          pkt.mat_kind.long()[hit.mat_id], pkt.mat_albedo[hit.mat_id],
                          pkt.mat_param[hit.mat_id], k.shadow_eps, k.pdf_eps)
    live = hit.hit & ~s.terminated
    return s.next_origin[live].contiguous(), s.next_dir[live].contiguous()


@pytest.mark.parametrize("scene", ["demo", "config4", "nine"])
def test_sweep_kernel_equals_plain_version(cuda, scene):
    # selections are integers: the kernel (built without FMA contraction)
    # and the plain sweep must agree exactly, primary and bounce-1 rays, with
    # and without the counters (two instantiations)
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk

    pkt = {"demo": lambda: demo.reference_demo_scene(16, 8).build_packet(device="cpu"),
           "config4": lambda: demo.config4_mixed_scene(24, 12).build_packet(device="cpu"),
           "nine": _nine_material_packet}[scene]().to(cuda)
    W, H = 160, 90
    cfg = RenderConfig(width=W, height=H)
    cam = cam_ops.Camera.create(width=W, height=H)
    px, py = pt.pixel_grid(H, W, cuda)
    jit = torch.rand((W * H, 2), device=cuda, generator=torch.Generator(cuda).manual_seed(2)) - 0.5
    o, d = cam_ops.get_rays(cam, px, py, jit)
    k = mk.TraceConsts.from_config(cfg)
    tables = sk.prepare(pkt)
    for ro, rd in ((o.contiguous(), d.contiguous()), _bounce1_rays(o, d, pkt, cfg)):
        active = torch.arange(ro.shape[0], device=cuda) % 5 != 0
        for mask in (None, active):
            before = sk.launches
            stats = torch.zeros(len(sk.STATS), dtype=torch.int64, device=cuda)
            got = sk.sweep_packed(ro, rd, tables, k.t_min, k.t_max, k.det_eps, mask, stats)
            want = sk.sweep_packed_reference(ro, rd, tables, k.t_min, k.t_max, k.det_eps,
                                             mask)
            uncounted = sk.sweep_packed(ro, rd, tables, k.t_min, k.t_max, k.det_eps, mask)
            torch.cuda.synchronize()
            assert sk.launches == before + 2
            for g, u, w in zip(got, uncounted, want):
                assert torch.equal(g, w) and torch.equal(u, w)
            assert bool(got[1].any() | got[3].any())
            n_live = ro.shape[0] if mask is None else int(mask.sum())
            _, supers, passed, swept, live = stats.tolist()
            assert live == n_live and 0 < passed <= swept <= n_live * tables.n_leaf
            assert 0 < supers <= n_live * tables.super_boxes.shape[0]


def test_staged_render_and_training_go_through_the_sweep_kernel(cuda):
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk
    from ptre_tpu_torch.utils.errors import ConfigError

    pkt_cpu = _nine_material_packet()
    pkt = pkt_cpu.to(cuda)
    W, H = 64, 32
    # the packet's default route is the render kernel: the staged one is forced
    cfg = RenderConfig(width=W, height=H, max_depth=4, intersect_backend="pallas",
                       grad_sweep="staged")
    cam = cam_ops.Camera.create(width=W, height=H)
    assert pt.route(pkt, cfg) == "staged"
    before = sk.launches
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, cuda), 5, cfg, spp=2)
    torch.cuda.synchronize()
    assert sk.launches == before + 2 * cfg.max_depth
    ref = pt.render_step(pkt_cpu, cam.to("cpu"), pt.AccumState.create(H, W, device="cpu"), 5,
                         cfg, spp=2)
    d = (acc.linear.cpu() - ref.linear).abs()
    assert bool(torch.isfinite(acc.linear).all()) and float(d.max()) < 1e-4, float(d.max())
    params = sh.differentiable_params(pkt, cam)
    before = sk.launches
    loss, grads = train.mse_step(params, pkt, cam, torch.zeros((W * H, 3), device=cuda), cfg,
                                 seed=1, spp=1)
    torch.cuda.synchronize()
    assert sk.launches == before + cfg.max_depth
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                               for g in grads.values())
    with pytest.raises(ConfigError, match="xla"):
        pt.render_step(pkt, cam, acc, 5, RenderConfig(width=W, height=H,
                                                      intersect_backend="xla"))


# ---- the render and recording kernels against their first designs --------------


@pytest.fixture(scope="module")
def first_dense():
    """The first designs of the render and recording kernels (csrc/baseline/),
    built by chip_smoke.py's `start_baseline_build` and called through their own
    C interfaces: (sample_accum-like, trace_fused_sel-like)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    libs = {u: chip_smoke.finish_unit_build(chip_smoke.start_baseline_build(u))
            for u in ("render_kernel.cu", "record_kernel.cu")}
    return (chip_smoke.baseline_render(libs["render_kernel.cu"], rk),
            chip_smoke.baseline_record(libs["record_kernel.cu"], mk))


@pytest.mark.parametrize("W,H", [(256, 128), (100, 37)])
@pytest.mark.parametrize("max_depth", [1, 5, 8])
@pytest.mark.parametrize("external", [True, False])
def test_render_kernel_equals_first_design(cuda, first_dense, W, H, max_depth, external):
    """The lane-refilling kernel's image equals the first design's pixel for
    pixel, but where FMA contraction, placed otherwise by nvcc, flips a path
    (at most 1e-5 of the pixels, rounded up); its counting instantiation
    starts every pixel's path once, writes path lengths that sum to its live
    ray-bounces, and issues no more warp-bounces than the first design did
    for the same paths."""
    import chip_smoke

    cfg, packed, rows, prev = _setup(cuda, W, H, max_depth)
    urand = (torch.rand((2 + 2 * max_depth, H, W), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2)) if external else None)
    got = rk.sample_accum(prev.clone(), packed, rows, 3, cfg, 21, urand)
    first = first_dense[0](prev.clone(), packed, rows, 3, cfg, 21, urand)
    stats = torch.zeros(len(mk.DENSE_STATS), dtype=torch.int64, device=cuda)
    lens = torch.zeros((H, W), dtype=torch.int32, device=cuda)
    counted = rk.sample_accum(prev.clone(), packed, rows, 3, cfg, 21, urand, stats=stats,
                              lens=lens)
    torch.cuda.synchronize()
    allowed = math.ceil(1e-5 * W * H)
    assert int((got != first).any(dim=-1).sum()) <= allowed
    assert int((counted != got).any(dim=-1).sum()) <= allowed
    started, live, hits, issued, tested = stats.tolist()
    assert started == W * H and W * H <= live <= W * H * max_depth and hits <= live
    assert tested <= live * packed.n_tri
    assert int(lens.sum()) == live and 1 <= int(lens.min()) <= int(lens.max()) <= max_depth
    assert live <= 32 * issued <= 32 * chip_smoke.first_design_warp_bounces(lens)


@pytest.mark.parametrize("max_depth", [1, 5, 8])
@pytest.mark.parametrize("external", [True, False])
def test_record_kernel_equals_first_design(cuda, first_dense, max_depth, external):
    """Selections row for row and colours equal the first design's, but for
    rays that FMA contraction, placed otherwise by nvcc, flips (at most 1e-5
    of the rays, rounded up); the counting instantiation's paths, hits and
    live ray-bounces are those the selections imply, as are its path
    lengths."""
    cfg, pkt, _, _, o, d, scene, k = _grad_setup(cuda, W=200, H=111)
    R = o.shape[0]
    urand = torch.rand((2 + 2 * max_depth, R), device=cuda) if external else None
    color, sel = mk.trace_fused_sel(o, d, scene, k, max_depth, 9, 1, urand)
    fc, fs = first_dense[1](o, d, scene, k, max_depth, 9, 1, urand)
    stats = torch.zeros(len(mk.DENSE_STATS), dtype=torch.int64, device=cuda)
    lens = torch.zeros(R, dtype=torch.int32, device=cuda)
    mk.trace_fused_sel(o, d, scene, k, max_depth, 9, 1, urand, stats=stats, lens=lens)
    torch.cuda.synchronize()
    allowed = math.ceil(1e-5 * R)
    assert int(((sel != fs).any(dim=0) | (color != fc).any(dim=1)).sum()) <= allowed
    table, T, _ = path_replay.build_table(pkt)
    emissive = (table[:, 22] > 0.5)[sel.clamp(min=0).long()]
    on = (sel >= 0) & ~emissive
    length = 1 + on[:max_depth - 1].sum(dim=0)
    sweeps, hits = int(length.sum()), int((sel >= 0).sum())
    started, live, n_hits, issued, _ = stats.tolist()
    assert started == R and int(lens.sum()) == live
    assert abs(live - sweeps) <= max_depth * allowed and abs(n_hits - hits) <= max_depth * allowed
    assert int((lens != length).sum()) <= allowed
    assert live <= 32 * issued


def test_mse_step_past_max_depth_runs_staged_through_the_sweep_kernel(cuda):
    """max_depth 9, one past the fused kernels' saved state: the staged route
    on the card (max_depth sweep launches, no record or backward launch),
    its loss and gradients within chip_smoke.py's STAGED_REL (2e-3 relative
    L2 by leaf) of the same step on the CPU (the sweep kernel is built
    without FMA contraction; the rest is PyTorch on either device)."""
    from ptre_tpu_torch.ops import integrator
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk

    W, H = 64, 32
    cfg = RenderConfig(width=W, height=H, max_depth=mk.MAX_DEPTH + 1)
    pkt_cpu = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    pkt = pkt_cpu.to(cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    assert integrator.grad_route(cfg, pkt) == integrator.grad_route(cfg, pkt_cpu) == "staged"
    target = torch.from_numpy(np.random.default_rng(6).uniform(0, 0.5, (W * H, 3))
                              .astype(np.float32))
    before = (sk.launches, mk.record_launches, fg.launches)
    loss, grads = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target.to(cuda),
                                 cfg, seed=5, spp=2)
    torch.cuda.synchronize()
    # each sample's sweeps again in its recompute, not in a bounce's
    assert (sk.launches - before[0], mk.record_launches - before[1],
            fg.launches - before[2]) == (2 * 2 * cfg.max_depth, 0, 0)
    want_loss, want = train.mse_step(sh.differentiable_params(pkt_cpu, cam), pkt_cpu, cam,
                                     target, cfg, seed=5, spp=2)
    assert abs(float(loss) - float(want_loss)) <= 2e-3 * abs(float(want_loss))
    for key, g in want.items():
        got = grads[key].cpu()
        assert bool(torch.isfinite(got).all()), key
        if float(g.norm()) > 0:
            assert float((got - g).norm() / g.norm()) <= 2e-3, key
        else:
            assert float(got.abs().max()) <= 1e-6, key


# ---- the hard raster kernel and the culled megakernel against their first designs --


@pytest.fixture(scope="module")
def first_raster_mega():
    """The first designs of the hard raster kernel and the culled megakernel
    (csrc/baseline/raster_mega/, built against the frozen headers there by
    chip_smoke.py's `start_baseline_build`) through their own C interfaces:
    (raster_tiles-like, trace_culled-like)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    libs = {u: chip_smoke.finish_unit_build(chip_smoke.start_baseline_build(u, "raster_mega"))
            for u in ("raster_kernel.cu", "mega_kernel.cu")}
    return (chip_smoke.baseline_raster_hard(libs["raster_kernel.cu"], rast),
            chip_smoke.baseline_trace_culled(libs["mega_kernel.cu"], mk))


def _host_lib(tmp_path, source, name, argtypes, restype=None):
    import ctypes
    import os
    import shutil
    import subprocess

    from ptre_tpu_torch.ops.cuda import build

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail(f"no C++ compiler (g++) to build csrc/{source}")
    so = str(tmp_path / f"lib_{name}.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", so,
                    os.path.join(build.CSRC_DIR, source)], check=True)
    lib = ctypes.CDLL(so)
    getattr(lib, name).restype = restype
    getattr(lib, name).argtypes = argtypes
    return lib


@pytest.mark.parametrize("W,H,ss,y0,stride,rows", [(200, 120, 2, 0.0, 1, None),
                                                   (333, 200, 3, 0.0, 1, None),
                                                   (999, 537, 2, 5.0, 3, 150)])
def test_hard_raster_kernel_equals_first_design(cuda, first_raster_mega, tmp_path, W, H, ss,
                                                y0, stride, rows):
    """The row-gated kernel's image equals the first design's bit for bit
    (and the plain version's); its counting instantiation gives the same
    image and the g++ build's counters (csrc/host_raster.cpp)."""
    import ctypes

    cfg, pkt, cam, _, _, R, Wss, ss = _raster_setup(cuda, W=W, H=H, ss=ss, rows=rows)
    with torch.no_grad():
        tris, cbox = rast.pack_raster_tris(pkt, cam, cfg)
    scal = rast.raster_scalars(cfg, 0.0, y0, stride)
    got = rast.raster_tiles(tris, cbox, scal, R, Wss, ss)
    first = first_raster_mega[0](tris, cbox, scal, R, Wss, ss)
    stats = torch.zeros(len(rast.STATS), dtype=torch.int64, device=cuda)
    counted = rast.raster_tiles(tris, cbox, scal, R, Wss, ss, stats=stats)
    want = rast.raster_reference(tris, cbox, scal, R, Wss, ss)
    torch.cuda.synchronize()
    assert torch.equal(got, first) and torch.equal(counted, got) and torch.equal(got, want)
    host = _host_lib(tmp_path, "host_raster.cpp", "ptre_raster_hard_host",
                     [ctypes.c_void_p] * 5, ctypes.c_longlong)
    h_img = torch.empty((3, R, Wss))
    h_stats = np.zeros(len(rast.STATS), np.int64)
    p = rast.raster_params(scal, R, Wss, ss, cbox.shape[0])
    t_cpu, b_cpu = tris.cpu(), cbox.cpu()
    host.ptre_raster_hard_host(ctypes.addressof(p), t_cpu.data_ptr(), b_cpu.data_ptr(),
                               h_img.data_ptr(), h_stats.ctypes.data)
    assert stats.tolist() == h_stats.tolist()
    assert stats[0] == rast.visited_pairs(cbox, R, Wss, ss, y0, stride) and int(stats[3]) > 0


@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("max_depth", [1, 4, 8])
def test_culled_megakernel_equals_first_design(cuda, first_raster_mega, tmp_path, external,
                                               max_depth):
    """The per-warp walk's colours and selections equal the first design's
    (block votes) bit for bit, recording and not, with culling on and off;
    its counting instantiation gives the same colour and the g++ build's
    counters (csrc/host_wave.cpp), with the warps' slots at least the pairs
    the rays pass."""
    import ctypes

    cfg, _, _, scene, k, o, d = _tri_rays(cuda, W=200, H=111, B=max_depth)
    R = o.shape[0]
    urand = torch.rand((2 + 2 * max_depth, R), device=cuda) if external else None
    for cull in (True, False):
        color, sel = mk.trace_culled(o, d, scene, k, max_depth, 9, 1, urand, cull=cull,
                                     record=True)
        fc, fs = first_raster_mega[1](o, d, scene, k, max_depth, 9, 1, urand, cull=cull,
                                      record=True)
        plain = mk.trace_culled(o, d, scene, k, max_depth, 9, 1, urand, cull=cull)
        f_plain = first_raster_mega[1](o, d, scene, k, max_depth, 9, 1, urand, cull=cull)
        torch.cuda.synchronize()
        assert torch.equal(color, fc) and torch.equal(sel, fs), cull
        assert torch.equal(plain, f_plain) and torch.equal(plain, color), cull
    stats = torch.zeros(len(mk.CULLED_STATS), dtype=torch.int64, device=cuda)
    counted = mk.trace_culled(o, d, scene, k, max_depth, 9, 1, urand, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(counted, plain)
    host = _host_lib(tmp_path, "host_wave.cpp", "ptre_trace_culled_host",
                     [ctypes.c_void_p] * 14)
    p = mk.MegaParams(
        w=mk.wave_params(k, 9, 1, scene, n_rays=R, n_sel=R, external_rng=int(external)),
        max_depth=max_depth, n_super=scene.super_boxes.shape[0], cull=1)
    cpu = {f: getattr(scene, f).cpu().contiguous() for f in
           ("tris", "rows", "cull_boxes", "super_boxes", "sphs", "mats", "sky")}
    o_c, d_c = o.cpu(), d.cpu()
    u_c = None if urand is None else urand.cpu()
    h_col = torch.empty((R, 3))
    h_stats = np.zeros(len(mk.CULLED_STATS), np.int64)
    host.ptre_trace_culled_host(
        ctypes.addressof(p), o_c.data_ptr(), d_c.data_ptr(),
        None if u_c is None else u_c.data_ptr(), *(cpu[f].data_ptr() for f in (
            "tris", "rows", "cull_boxes", "super_boxes", "sphs", "mats", "sky")),
        h_col.data_ptr(), None, h_stats.ctypes.data)
    st = dict(zip(mk.CULLED_STATS, stats.tolist()))
    # the unit contracts a*b+c in the row tests (as the first design did), so
    # a closest hit may sit an ulp from the g++ build's and a box test
    # bounded by it go the other way: each counter within 1e-3
    for got_n, want_n in zip(stats.tolist(), h_stats.tolist()):
        assert abs(got_n - want_n) <= 1e-3 * want_n
    assert 0 < st["own_pairs"] <= st["warp_slots"] <= st["leaf_tests"]
    assert st["super_tests"] == st["ray_bounces"] * scene.super_boxes.shape[0]


# ---- the engine facade on the card --------------------------------------------

def _engine(cuda, W=96, H=54, config=None, **kw):
    from ptre_tpu_torch.render.engine import Renderer

    return Renderer(demo.reference_demo_scene(16, 8), cam_ops.Camera.create(width=W, height=H),
                    config or RenderConfig(width=W, height=H), RasterConfig(width=W, height=H),
                    device=cuda, **kw)


def test_engine_launches_one_kernel_a_frame(cuda):
    """A path-traced frame (spp 1) launches the render kernel once and no
    raster kernel; a raster frame the hard raster kernel once and no render
    kernel."""
    from ptre_tpu_torch.render.engine import EngineKind

    r = _engine(cuda)
    for i in range(8):
        if i in (3, 6):
            r.toggle_engine()
        before = (rk.launches, rast.launches)
        img = r.draw_frame()
        pt_frame = r.engine == EngineKind.PATHTRACER
        assert (rk.launches - before[0], rast.launches - before[1]) == \
            ((1, 0) if pt_frame else (0, 1)), i
        assert img.shape == (54, 96, 3) and img.dtype == np.uint8
    assert r.accum.frame == 5


def _without_synchronize(monkeypatch, fn, what):
    """``fn()`` with torch's CUDA sync debug mode set to error (a
    synchronizing call raises) and ``torch.cuda.synchronize`` refused."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"{what} synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        monkeypatch.undo()


def test_dispatch_ahead_frame_performs_no_synchronize(cuda, monkeypatch):
    """With present_async a path-traced frame makes no device or stream
    synchronize and nothing that syncs implicitly (torch's sync debug mode
    set to error): it waits on the previous frame's copy event only. The
    camera, left at its default, lies on the card."""
    r = _engine(cuda)
    assert r.camera.position.device.type == "cuda"
    r.draw_frame()  # builds the packets (host-to-device copies) and buffers
    r.draw_frame()
    img = _without_synchronize(monkeypatch, r.draw_frame, "a path-traced frame")
    assert img.shape == (54, 96, 3) and int(img.max()) > 0


def _one_device_steps(dev):
    """{name: step} of the one-device paths that make no synchronizing
    call: the rasterizer hard and soft, `raster_mse_step` and the dense
    `mse_step`, on the demo with cameras at their default (the card)."""
    W, H = 96, 54
    scn = demo.reference_demo_scene(16, 8)
    pkt = scn.build_packet(device=dev)
    rpkt = scn.build_packet(spheres_as_triangles=True, device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    assert cam.position.device.type == "cuda"
    cfg = RenderConfig(width=W, height=H)
    rcfg = RasterConfig(width=W, height=H, supersample=2)
    params = sh.differentiable_params(rpkt, cam)

    def frame(soft):
        with torch.no_grad():
            return ras.rasterize(rpkt, cam, rcfg, soft=soft)

    return {
        "rasterize": lambda: frame(False),
        "rasterize soft": lambda: frame(True),
        "raster_mse_step": lambda: train.raster_mse_step(
            params, rpkt, cam, torch.zeros((H, W, 3), device=dev), rcfg)[1],
        "mse_step": lambda: train.mse_step(
            sh.differentiable_params(pkt, cam), pkt, cam, torch.zeros((W * H, 3), device=dev),
            cfg, seed=3)[1],
        # spp 2: each sample a remat region, recomputed in the backward
        "mse_step spp 2": lambda: train.mse_step(
            sh.differentiable_params(pkt, cam), pkt, cam, torch.zeros((W * H, 3), device=dev),
            cfg, seed=3, spp=2)[1],
    }


@pytest.mark.parametrize("name", ["rasterize", "rasterize soft", "raster_mse_step", "mse_step",
                                  "mse_step spp 2"])
def test_one_device_steps_make_no_synchronizing_call(cuda, monkeypatch, name):
    """The rasterizer's frames and steps and the dense `mse_step` (spp 1,
    and spp 2 with its samples rematerialised) with the camera at its
    default: no synchronizing call (the shading constants are made once per
    config and device, the camera's matrices on the card)."""
    step = _one_device_steps(cuda)[name]
    step()
    out = _without_synchronize(monkeypatch, step, name)
    outs = out.values() if isinstance(out, dict) else [out]
    assert all(bool(torch.isfinite(t).all()) for t in outs), name


def test_dense_render_step_makes_no_synchronizing_call(cuda, monkeypatch):
    """A dense `render_step` with the camera of ``Camera.create()`` left at
    its default (the card): the camera rows are made there once a step and
    the kernel reads them there, so no launch reads the card from the host."""
    from ptre_tpu_torch.ops import rng

    W, H = 96, 54
    pkt = demo.reference_demo_scene(16, 8).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    assert cam.position.device.type == "cuda"
    cfg = RenderConfig(width=W, height=H)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W), rng.key_for(1), cfg)
    before = rk.launches
    acc = _without_synchronize(monkeypatch, lambda: pt.render_step(
        pkt, cam, acc, rng.fold(rng.key_for(1), 1), cfg, spp=2), "render_step")
    assert rk.launches == before + 2 and acc.frame == 3
    assert bool(torch.isfinite(acc.linear).all())


@pytest.mark.parametrize("name", ["render_step", "mse_step"])
def test_wavefront_steps_make_no_synchronizing_call(cuda, monkeypatch, name):
    """A wavefront-class `render_step` and `mse_step` (spp 2: the recording
    forward and each sample's remat recompute) after a warm-up: the live
    count stays on the card, the sort decision is taken there, and no call
    synchronizes."""
    W, H = 96, 54
    pkt = demo.config4_mixed_scene(64, 32).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    assert pt.route(pkt, cfg) == "wavefront"
    if name == "render_step":
        acc = pt.AccumState.create(H, W)

        def step():
            return pt.render_step(pkt, cam, acc, 3, cfg, spp=2).linear
    else:
        target = torch.zeros((W * H, 3), device=cuda)

        def step():
            return train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg,
                                  seed=3, spp=2)[1]
    step()
    before = wf.bounce_launches
    out = _without_synchronize(monkeypatch, step, name)
    samples = 2 if name == "render_step" else 4
    assert wf.bounce_launches - before == samples * cfg.max_depth
    outs = out.values() if isinstance(out, dict) else [out]
    assert all(bool(torch.isfinite(t).all()) for t in outs), name


def test_returned_frame_stays_intact_across_two_later_frames(cuda):
    """Frame i returns frame i-1's display (a copy the caller keeps), equal
    to a synchronous renderer's; two later frames, which reuse both pinned
    buffers, leave it as it was."""
    r, sync = _engine(cuda), _engine(cuda, present_async=False)
    assert (r.draw_frame() == 0).all()
    want = sync.draw_frame()
    kept = r.draw_frame()
    np.testing.assert_array_equal(kept, want)
    copy = kept.copy()
    later = [r.draw_frame(), r.draw_frame()]
    np.testing.assert_array_equal(kept, copy)
    assert not np.array_equal(later[1], kept)
    for _ in range(2):
        want = sync.draw_frame()
    np.testing.assert_array_equal(later[1], want)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_engine_resume_is_bit_equal_on_the_card(cuda, tmp_path, backend):
    from ptre_tpu_torch.utils import checkpoint as ckpt

    cfg = RenderConfig(width=96, height=54, intersect_backend=backend)

    def engine():
        return _engine(cuda, config=cfg, present_async=False)

    whole = engine()
    for _ in range(6):
        whole.draw_frame()
    first = engine()
    for _ in range(3):
        first.draw_frame()
    path = str(tmp_path / "ck.npz")
    ckpt.save_render_state(path, first.accum, cfg.seed, first._frame_index)
    resumed = engine()
    resumed.accum, _, resumed._frame_index, _ = ckpt.load_render_state(path)
    assert resumed.accum.linear.device.type == "cuda"
    for _ in range(3):
        resumed.draw_frame()
    assert resumed.accum.frame == 6
    assert torch.equal(resumed.accum.linear, whole.accum.linear)


# ---- the sharded steps (`parallel/sharding.py`) ---------------------------------------------

SHARD_W, SHARD_H = 128, 64


def _shard_replay_train(pkt, cam, cfg, key, sp, spp, target):
    """(loss, grads) of `shard_train_step` on a (1, sp) mesh in one process:
    the sp ranks' samples in one autograd graph."""
    from ptre_tpu_torch.ops import rng

    leaves = {k: v.detach().requires_grad_(True)
              for k, v in sh.differentiable_params(pkt, cam).items()}
    pk, cm = sh.apply_params(leaves, pkt, cam)
    fwd = sh._forward(pk, cfg)
    imgs = []
    for sp_i in range(sp):
        lkey = rng.fold(key, sp_i)
        imgs.append(sum(sh._sample_rows(rng.fold(lkey, s), pk, cm, cfg, 0.0, cam.height, 1, fwd)
                        .reshape(cam.height, cam.width, 3) for s in range(spp // sp))
                    / (spp // sp))
    loss = torch.mean((sum(imgs) / sp - target) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_shard_render_step_nccl_world_of_one_equals_replay(cuda):
    """A (1, 1) mesh over NCCL in this process: every sample one record
    launch, the image bit-equal to `_sample_rows` replayed by hand."""
    import torch.distributed as dist

    from ptre_tpu_torch.ops import rng

    assert not dist.is_initialized()
    try:
        mesh = sh.make_mesh((1, 1))
        assert dist.get_backend() == "nccl" and sh.mesh_device(mesh).type == "cuda"
        pkt = sh.replicate(mesh, demo.reference_demo_scene(16, 8).build_packet(device=cuda))
        cam = cam_ops.Camera.create(width=SHARD_W, height=SHARD_H)
        cfg = RenderConfig(width=SHARD_W, height=SHARD_H)
        key = rng.key_for(5)
        before = mk.record_launches
        out = sh.shard_render_step(mesh, pkt, cam, pt.AccumState.create(SHARD_H, SHARD_W), key,
                                   cfg, spp=3)
        torch.cuda.synchronize()
        assert mk.record_launches == before + 3 and out.frame == 3
        lin = torch.zeros((SHARD_H, SHARD_W, 3), device=cuda)
        fwd = sh._forward(pkt, cfg)
        for s in range(3):
            img = sh._sample_rows(rng.fold(rng.fold(rng.fold(key, 0), s), s + 1), pkt, cam, cfg,
                                  0.0, SHARD_H, 1, fwd).reshape(SHARD_H, SHARD_W, 3)
            n = torch.tensor(float(s + 1), device=cuda)
            lin = img / n + lin * ((n - 1.0) / n)
        assert torch.equal(out.linear, lin)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_shard_render_step_makes_no_synchronizing_call(cuda, monkeypatch):
    """`shard_render_step` on the dense route, a world of one over NCCL,
    the camera at its default (the card): the rows, the row mask and the
    running average's weights are made on the card or as host floats, so a
    step makes no synchronizing call."""
    import torch.distributed as dist

    from ptre_tpu_torch.ops import rng

    assert not dist.is_initialized()
    try:
        mesh = sh.make_mesh((1, 1))
        pkt = sh.replicate(mesh, demo.reference_demo_scene(16, 8).build_packet(device=cuda))
        cam = cam_ops.Camera.create(width=SHARD_W, height=SHARD_H)
        assert cam.position.device.type == "cuda"
        cfg = RenderConfig(width=SHARD_W, height=SHARD_H)
        acc = sh.shard_render_step(mesh, pkt, cam, pt.AccumState.create(SHARD_H, SHARD_W),
                                   rng.key_for(5), cfg, spp=1)
        before = mk.record_launches
        out = _without_synchronize(monkeypatch, lambda: sh.shard_render_step(
            mesh, pkt, cam, acc, rng.key_for(6), cfg, spp=4), "shard_render_step")
        assert mk.record_launches == before + 4 and out.frame == 5
        assert bool(torch.isfinite(out.linear).all())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sharded_train_steps_make_no_synchronizing_call(cuda, monkeypatch):
    """`shard_train_step` and `dual_train_step` (spp 1, and spp 2 with
    their samples rematerialised) on a world of one over NCCL, the camera at
    its default (the card): no synchronizing call in a step, forward or
    backward."""
    import torch.distributed as dist

    from ptre_tpu_torch.ops import rng

    assert not dist.is_initialized()
    try:
        mesh = sh.make_mesh((1, 1))
        scn = demo.reference_demo_scene(16, 8)
        pkt = sh.replicate(mesh, scn.build_packet(device=cuda))
        rpkt = sh.replicate(mesh, scn.build_packet(spheres_as_triangles=True, device=cuda))
        cam = cam_ops.Camera.create(width=SHARD_W, height=SHARD_H)
        cfg = RenderConfig(width=SHARD_W, height=SHARD_H)
        rcfg = RasterConfig(width=SHARD_W, height=SHARD_H, supersample=2)
        params = sh.differentiable_params(pkt, cam)
        target = torch.zeros((SHARD_H, SHARD_W, 3), device=cuda)
        steps = {
            "shard_train_step": lambda k, spp: sh.shard_train_step(
                mesh, params, pkt, cam, target, rng.key_for(k), cfg, spp=spp)[1],
            "dual_train_step": lambda k, spp: sh.dual_train_step(
                mesh, params, pkt, rpkt, cam, target, rng.key_for(k), cfg, rcfg, spp=spp)[1]}
        for spp in (1, 2):
            for name, step in steps.items():
                step(1, spp)
                grads = _without_synchronize(monkeypatch, lambda: step(2, spp), name)
                assert all(bool(torch.isfinite(g).all()) for g in grads.values()), (name, spp)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_gloo_ranks_sharing_the_card_train_matches_replay(cuda, tmp_path):
    """Two gloo ranks on the one card, mesh (1, 2): the sp mean's gradient
    factor. `shard_train_step` (spp 2) against the replay within rtol 1e-5
    and 1e-5 of each leaf's largest entry (d(table) and d(sky) are summed
    by atomics)."""
    import _torch_world

    _torch_world.run(__file__, 2, tmp_path / "store", tmp_path, timeout=600)
    got = np.load(tmp_path / "shared_r0.npz")
    assert str(got["device"]).startswith("cuda") and str(got["backend"]) == "gloo"
    assert int(got["record"]) == 1 and int(got["fused_bwd"]) == 1  # one sample a rank
    from ptre_tpu_torch.ops import rng

    pkt = demo.reference_demo_scene(16, 8).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=SHARD_W, height=SHARD_H)
    target = torch.from_numpy(got["target"]).to(cuda)
    loss, grads = _shard_replay_train(pkt, cam, RenderConfig(width=SHARD_W, height=SHARD_H),
                                      rng.key_for(6), 2, 2, target)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    for k, w in grads.items():
        w = w.cpu().numpy()
        np.testing.assert_allclose(got[f"grad_{k}"], w, rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-30), err_msg=k)
    np.testing.assert_array_equal(np.load(tmp_path / "shared_r1.npz")["loss"], got["loss"])


def _shared_card_rank(argv):
    """One rank of `test_two_gloo_ranks_sharing_the_card_train_matches_replay`."""
    import _torch_world
    import torch.distributed as dist

    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import distributed

    rank, world, init, (out_dir,) = _torch_world.worker_args(argv)
    distributed.initialize(init, world, rank, backend="gloo", timeout=300)
    mesh = sh.make_mesh((1, world))
    dev = sh.mesh_device(mesh)
    pkt = demo.reference_demo_scene(16, 8).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=SHARD_W, height=SHARD_H)
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 0.5, (SHARD_H, SHARD_W, 3)).astype(np.float32))
    before = mk.record_launches, fg.launches
    loss, grads, _ = sh.shard_train_step(mesh, sh.differentiable_params(pkt, cam), pkt, cam,
                                         target.to(dev), rng.key_for(6),
                                         RenderConfig(width=SHARD_W, height=SHARD_H), spp=2)
    torch.cuda.synchronize()
    np.savez(f"{out_dir}/shared_r{rank}.npz", loss=loss.cpu().numpy(), device=str(dev),
             backend=dist.get_backend(), target=target.numpy(),
             record=mk.record_launches - before[0], fused_bwd=fg.launches - before[1],
             **{f"grad_{k}": v.cpu().numpy() for k, v in grads.items()})
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _shared_card_rank(sys.argv)


# ---- material tables past the reference's 8 rows (trace.cuh material_row) --------
# Scene A: the demo or config 4's mesh with 8 materials; scene B: the same
# geometry with 16 decoy rows (emissive, bright, odd albedo) before A's 8
# and every model on its id + 16. Up to 8 rows the wave kernel stages the
# table in shared memory, past 8 it reads it in place, as the render, record
# and culled kernels read every table: B's kernels must give
# A's colours and selections bit for bit (the same arithmetic on the same
# rows), and hold to their plain versions as on A.

DECOY_ROWS = 16


def _decoy_pair(kind, dev):
    from ptre_tpu_torch.models.scene import Material, MaterialKind

    scn = (demo.reference_demo_scene(16, 8) if kind == "demo"
           else demo.config4_mixed_scene(64, 32))
    for em, albedo, param in ((False, (0.8, 0.35, 0.2), 0.6), (True, (1.0, 0.85, 0.6), 3.0),
                              (False, (0.2, 0.6, 0.9), 0.2), (False, (0.9, 0.9, 0.3), 1.0),
                              (True, (0.5, 0.7, 1.0), 6.0), (False, (0.4, 0.45, 0.5), 0.0)):
        scn.add_material(Material(MaterialKind.EMISSIVE if em else MaterialKind.OREN_NAYAR,
                                  albedo, param))
    ids = ({"ground": 2, "sph": 4, "wall": 3} if kind == "demo"
           else {"b": 5, "c": 6, "s": 4, "g": 7})
    for model, mid in ids.items():
        scn.set_model_material(model, mid)
    a = scn.build_packet(device=dev)
    i = torch.arange(DECOY_ROWS, dtype=torch.float32, device=dev)
    b = dataclasses.replace(
        a, mat_kind=torch.cat([(i.long() % 2 == 0).to(a.mat_kind.dtype), a.mat_kind]),
        mat_albedo=torch.cat([torch.stack([3.0 + i, torch.full_like(i, 0.01), 7.0 - 0.25 * i],
                                          dim=1), a.mat_albedo]),
        mat_param=torch.cat([25.0 + i, a.mat_param]),
        tri_mat=a.tri_mat + DECOY_ROWS, sph_mat=a.sph_mat + DECOY_ROWS,
        num_materials=a.num_materials + DECOY_ROWS)
    assert a.num_materials == mk.STAGED_MATS and pt.route(b) == pt.route(a)
    return a, b


@pytest.mark.parametrize("external", [True, False])
def test_dense_kernels_on_a_decoy_table_equal_scene_a(cuda, external):
    W, H, B = 256, 128, 5
    a, b = _decoy_pair("demo", cuda)
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    cam = cam_ops.Camera.create(width=W, height=H)
    rows = rk.camera_rows(cam)
    prev = torch.from_numpy(np.random.default_rng(3).random((H, W, 3), np.float32)).to(cuda)
    urand = (torch.rand((2 + 2 * B, H, W), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1)) if external else None)
    sa, sb = mk.pack_scene(a), mk.pack_scene(b)
    assert sb.mats.shape == (24, 8)
    before = rk.launches
    img_a = rk.sample_accum(prev.clone(), sa, rows, 3, cfg, 77, urand)
    img_b = rk.sample_accum(prev.clone(), sb, rows, 3, cfg, 77, urand)
    want = rk.sample_accum_reference(prev, sb, rows, 3, cfg, 77, urand)
    torch.cuda.synchronize()
    assert rk.launches == before + 2 and torch.equal(img_a, img_b)
    _assert_close(img_b, want)
    _, _, _, _, o, d, _, k = _grad_setup(cuda, W, H, B)
    ur = urand.reshape(2 + 2 * B, -1) if external else None
    before = mk.record_launches
    col_a, sel_a = mk.trace_fused_sel(o, d, sa, k, B, 9, 1, ur)
    col_b, sel_b = mk.trace_fused_sel(o, d, sb, k, B, 9, 1, ur)
    want_c, want_s = mk.trace_record_reference(o, d, sb, k, B, 9, 1, ur)
    torch.cuda.synchronize()
    assert mk.record_launches == before + 2
    assert torch.equal(col_a, col_b) and torch.equal(sel_a, sel_b)
    R = o.shape[0]
    diff = (col_b - want_c).abs()
    assert float((diff <= 1e-4 * want_c.abs().clamp_min(1.0)).float().mean()) >= 0.999
    assert int((sel_b != want_s).any(dim=0).sum()) <= math.ceil(1e-4 * R)
    assert float(col_b.max()) > 1.0  # an emitter of A (3 or 6) lit some rays


@pytest.mark.parametrize("external", [True, False])
def test_wave_and_culled_kernels_on_a_decoy_table_equal_scene_a(cuda, external):
    a, b = _decoy_pair("config4", cuda)
    cfg, _, cam, _, k, o, d = _tri_rays(cuda)
    R, B = o.shape[0], cfg.max_depth
    urand = (torch.rand((2 + 2 * B, R), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(CULLED_SEED))
             if external else None)
    sa, sb = (wf.prepare_scene(p, screen_cam=cam) for p in (a, b))
    assert sb.mats.shape == (24, 8)
    before = wf.bounce_launches, mk.culled_launches
    out = {}
    for name, scene in (("a", sa), ("b", sb)):
        out[name] = (wf.trace(o, d, scene, k, B, 9, 1, urand, tile_hint=(cfg.height, cfg.width),
                              record=True)[:2]
                     + mk.trace_culled(o, d, scene, k, B, 9, 1, urand, record=True))
    torch.cuda.synchronize()
    assert wf.bounce_launches > before[0] and mk.culled_launches == before[1] + 2
    for x, y in zip(out["a"], out["b"]):
        assert torch.equal(x, y)
    wcol, wsel, color, sel = out["b"]
    want, want_sel = mk.trace_culled_reference(o, d, sb, k, B, 9, 1, urand, record=True)
    assert int(_flipped(color, want, sel, want_sel).sum()) <= math.ceil(1e-4 * R)
    assert int(_flipped(color, wcol, sel, wsel).sum()) <= math.ceil(1e-4 * R)
    # one bounce of the wave kernel against its plain version on B
    state, ids, short0 = wf.primary_state(o, d, sb, (cfg.height, cfg.width))
    got = wf.wave_bounce(state, ids, *short0, sb, k, 0, 9, 1, urand)
    plain = wf.wave_bounce_reference(state, ids, *short0, sb, k, 0, 9, 1, urand)
    err = (got - plain).abs()
    assert float((err <= 1e-4).float().mean()) >= 0.999
    assert int((err > 1e-4).any(dim=0).sum()) <= math.ceil(1e-5 * state.shape[1])


def test_many_materials_take_the_fused_kernels_never_the_sweep(cuda):
    """A demo packet and config 4's mesh with 300 distinct materials run
    `render_step` and `mse_step` through the render / wave kernels and the
    recording / backward kernels, with no sweep launch, and match the plain
    versions of the same steps."""
    from ptre_tpu_torch.models.scene import Material, MaterialKind
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk

    W, H = 128, 64
    cfg = RenderConfig(width=W, height=H, max_depth=4)
    cam = cam_ops.Camera.create(width=W, height=H)
    rs = np.random.default_rng(300)
    for kind in ("demo", "config4"):
        scn = demo.reference_demo_scene(16, 8) if kind == "demo" else demo.config4_mixed_scene(
            32, 16)
        for i in range(298):
            scn.add_material(Material(MaterialKind.EMISSIVE if i % 7 == 0 else
                                      MaterialKind.OREN_NAYAR,
                                      tuple(float(x) for x in rs.uniform(0.1, 0.9, 3)),
                                      float(rs.uniform(0.0, 1.5))))
        for j, model in enumerate(scn.sorted_models()):
            scn.set_model_material(model[0], 40 + 83 * j)
        pkt = scn.build_packet(device=cuda)
        assert pkt.num_materials == 300
        before = (rk.launches, wf.bounce_launches, mk.record_launches, fg.launches, sk.launches)
        acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, cuda), 3, cfg, spp=2)
        loss, grads = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam,
                                     torch.zeros((W * H, 3), device=cuda), cfg, seed=4, spp=1)
        torch.cuda.synchronize()
        n = [x - y for x, y in zip((rk.launches, wf.bounce_launches, mk.record_launches,
                                     fg.launches, sk.launches), before)]
        if kind == "demo":
            assert n == [2, 0, 1, 1, 0], n
        else:
            assert n[0] == 0 and n[1] > 2 and n[2] == 0 and n[3] == 1 and n[4] == 0, n
        ref = pt.render_step(pkt.to("cpu"), cam.to("cpu"),
                             pt.AccumState.create(H, W, device="cpu"), 3, cfg, spp=2)
        d = (acc.linear.cpu() - ref.linear).abs()
        assert float((d <= 1e-4).float().mean()) >= 0.999
        assert int((d > 0.05).any(dim=-1).sum()) <= math.ceil(1e-5 * W * H * 2)
        assert math.isfinite(float(loss))
        assert float(grads["mat_albedo"][40:].abs().max()) > 0
        assert float(grads["mat_albedo"][:40].abs().max()) == 0.0


# ---- rematerialisation (`ops/gradsafe.remat`) ----------------------------------------------

#: d(table)- and d(sky)-fed leaves of the fused backward, summed by atomics in
#: no fixed order: remat on and off within REMAT_GRAD_REL of the leaf's
#: largest entry (about six times the largest run-to-run reading, ROADMAP C2);
#: the camera's leaves, fed by d(o) and d(d), bit for bit
REMAT_GRAD_REL = 1e-5
CAMERA_LEAVES = ("cam_position", "cam_forward", "cam_fov")


def _hold_remat_grads(on, off, what):
    (l_on, g_on), (l_off, g_off) = on, off
    assert float(l_on) == float(l_off), what
    for k, a in g_on.items():
        b = g_off[k]
        assert bool(torch.isfinite(a).all()), (what, k)
        if k in CAMERA_LEAVES:
            assert torch.equal(a, b), (what, k)
        else:
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= REMAT_GRAD_REL * scale, (what, k)


@pytest.mark.parametrize("sweep", ["auto", "staged"])
def test_mse_step_remat_matches_no_remat_on_the_card(cuda, sweep):
    """The demo's `mse_step` at spp 3 with its regions on (the default)
    and with ``remat_bounces=False``: the same loss, the camera's gradients
    bit for bit, the table's and the sky's within REMAT_GRAD_REL. Per
    sample the fused route launches the record kernel twice (forward and
    recompute) and the backward once; the staged route sweeps max_depth
    times forward and again in the sample's recompute, never in a
    bounce's."""
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk

    W, H, spp = 256, 128, 3
    pkt = demo.reference_demo_scene(16, 8).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    target = torch.zeros((W * H, 3), device=cuda)
    out, launches = {}, {}
    for remat in (True, False):
        cfg = RenderConfig(width=W, height=H, grad_sweep=sweep, remat_bounces=remat)
        before = (mk.record_launches, fg.launches, sk.launches)
        out[remat] = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg,
                                    seed=7, spp=spp)
        torch.cuda.synchronize()
        launches[remat] = tuple(a - b for a, b in zip(
            (mk.record_launches, fg.launches, sk.launches), before))
    _hold_remat_grads(out[True], out[False], sweep)
    B = 5
    if sweep == "auto":
        assert launches == {True: (2 * spp, spp, 0), False: (spp, spp, 0)}, launches
    else:
        assert launches == {True: (0, 0, 2 * spp * B), False: (0, 0, spp * B)}, launches


def test_mse_step_peak_memory_does_not_grow_with_spp(cuda):
    """The demo's fused `mse_step` at 512x256: the peak at spp 8 within
    1.25x of spp 1's with remat on, and under the peak without it, where
    every sample's residuals are kept until the backward."""
    W, H = 512, 256
    pkt = demo.reference_demo_scene(16, 8).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    params = sh.differentiable_params(pkt, cam)
    target = torch.zeros((W * H, 3), device=cuda)
    peak = {}
    for remat in (True, False):
        cfg = RenderConfig(width=W, height=H, remat_bounces=remat)
        for spp in (1, 8):
            train.mse_step(params, pkt, cam, target, cfg, seed=1, spp=spp)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            train.mse_step(params, pkt, cam, target, cfg, seed=2, spp=spp)
            torch.cuda.synchronize()
            peak[remat, spp] = torch.cuda.max_memory_allocated()
    assert peak[True, 8] <= 1.25 * peak[True, 1], peak
    assert peak[True, 8] < peak[False, 8], peak
