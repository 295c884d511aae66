"""`wavefront.trace` takes the per-bounce sort decision on the device and
launches every bounce: against a loop that decides on the host (it reads the
live count, sorts at or above ``sort_min_live`` of the columns live, and
stops at the first bounce with no live ray), the order and state entering
every bounce, the colour and the recorded selections are bit-equal, and
``stats`` counts the bounces sorted, left in order and entered with no live
ray. The glue that makes the device-side choice cheap is held to plain
versions too: the table-driven sort key against its fields computed one at a
time, and `render_step`'s one-pass jitter against a sample at a time. Plain
versions on the CPU, no JAX; the ``cuda``-marked test repeats the order
check at 1920x1080 through the kernels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models import mesh as mg
from ptre_tpu_torch.models.scene import Model, Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils.config import RenderConfig
from ptre_tpu_torch.utils.errors import RendererError

W, H = 32, 16
LANES = 64
MAX_DEPTH = 5
SEED, SAMPLE = 77, 3


def _emitter_only():
    """A triangle uv-sphere with the emissive default material and nothing
    else: every path ends at bounce 0 (sky or emitter)."""
    scn = Scene()
    scn.add_mesh("ball", mg.uv_sphere(False, 12, 6, mesh_type=mg.MeshType.TRIANGLES))
    scn.add_model("b", Model("ball"))
    scn.get_model("b").set_transforms(1.0, 0.0, (0.0, 0.5, 0.0))
    return scn


SCENES = {"config4": lambda: demo.config4_mixed_scene(12, 6), "emitter_only": _emitter_only}
SORTS = {"always": 0.0, "default": wf.SORT_MIN_LIVE, "full": 1.0, "never": None}


def _rays(pkt, width=W, height=H):
    dev = pkt.device
    cam = cam_ops.Camera.create(width=width, height=height, device=dev)
    scene = wf.prepare_scene(pkt, screen_cam=cam)
    px, py = pt.pixel_grid(height, width, device=dev)
    jit = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (height * width, 2)).astype(np.float32)).to(dev)
    o, d = cam_ops.get_rays(cam, px, py, jit)
    return o.contiguous(), d.contiguous(), scene


def _host_decided(o, d, scene, k, sort_min_live, hw=(H, W), lanes=LANES):
    """The loop that reads the live count on the host: (colour, sel, the
    (state, ids) entering each bounce it ran, the last state and ids, the
    bounces past 0 it sorted)."""
    R = o.shape[0]
    state, ids, short0 = wf.primary_state(o, d, scene, hw, True, lanes)
    sel = torch.full((MAX_DEPTH, R), -1, dtype=torch.int32, device=o.device)
    entered, n_sorted = [], 0
    for b in range(MAX_DEPTH):
        if b > 0:
            n_live = int((state[9] > 0.5).sum())
            if n_live == 0:
                break
            if sort_min_live is not None and n_live >= max(
                    int(sort_min_live * state.shape[1]), 1):
                perm = wf.coherence_order(state, scene)
                state, ids = state[:, perm], ids[perm]
                n_sorted += 1
        entered.append((state, ids))
        if b == 0:
            short, cnt = short0
        else:
            short, cnt = wf.shortlists_from_mask(wf.wave_mask(
                state, scene.boxes, k.t_min, lanes, supers=scene.mask_supers))
        state = wf.wave_bounce(state, ids, short, cnt, scene, k, b, SEED, SAMPLE, None,
                               lanes, sel)
    color = torch.empty((state.shape[1], 3), dtype=torch.float32, device=o.device)
    color[ids.long()] = state[6:9].T
    return color[:R], sel, entered, (state, ids), n_sorted


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    torch.set_num_threads(1)
    pkt = SCENES[request.param]().build_packet(device="cpu")
    k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=MAX_DEPTH))
    return request.param, _rays(pkt), k


@pytest.mark.parametrize("sort", list(SORTS))
def test_device_choice_equals_host_decided_order(case, sort, monkeypatch):
    name, (o, d, scene), k = case
    sort_min_live = SORTS[sort]
    want_color, want_sel, entered, last, n_sorted = _host_decided(o, d, scene, k,
                                                                  sort_min_live)
    seen = []
    bounce = wf.wave_bounce

    def recording(state, ids, *args):
        seen.append((state.clone(), ids.clone()))
        return bounce(state, ids, *args)

    monkeypatch.setattr(wf, "wave_bounce", recording)
    stats = torch.zeros(len(wf.TRACE_STATS), dtype=torch.int64)
    launched = wf.live_bounces
    color, sel, _ = wf.trace(o, d, scene, k, MAX_DEPTH, SEED, SAMPLE, tile_hint=(H, W),
                             sort_min_live=sort_min_live, lanes=LANES, record=True,
                             stats=stats)
    assert wf.live_bounces - launched == len(seen) == MAX_DEPTH
    for b, (state, ids) in enumerate(seen):
        # past the host loop's stop the rays are all dead, left in order and
        # passed through: each bounce enters with the last state
        want_state, want_ids = entered[b] if b < len(entered) else last
        assert torch.equal(ids, want_ids), b
        assert torch.equal(state, want_state), b
    assert torch.equal(color, want_color) and torch.equal(sel, want_sel)
    assert float(color.max()) > 0.05 and int((sel >= 0).sum()) > 0
    in_order = len(entered) - 1 - n_sorted
    assert stats.tolist() == [n_sorted, in_order, MAX_DEPTH - len(entered)]
    assert int(stats.sum()) == MAX_DEPTH - 1
    if name == "emitter_only":
        assert stats.tolist() == [0, 0, MAX_DEPTH - 1]
    elif sort == "default":
        # a bounce below SORT_MIN_LIVE live, left in order on the device
        assert n_sorted >= 1 and in_order >= 1, stats.tolist()


def test_trace_without_stats_matches_with_stats(case):
    _, (o, d, scene), k = case
    args = (o, d, scene, k, MAX_DEPTH, SEED, SAMPLE)
    stats = torch.zeros(len(wf.TRACE_STATS), dtype=torch.int64)
    a = wf.trace(*args, tile_hint=(H, W), lanes=LANES, stats=stats)
    b = wf.trace(*args, tile_hint=(H, W), lanes=LANES)
    assert torch.equal(a, b) and int(stats.sum()) == MAX_DEPTH - 1


def test_trace_refuses_stats_of_another_shape_or_type():
    o = d = torch.zeros((4, 3))
    for bad in (torch.zeros(2, dtype=torch.int64), torch.zeros(3, dtype=torch.int32)):
        with pytest.raises(RendererError, match="stats"):
            wf.trace(o, d, None, None, MAX_DEPTH, stats=bad)


def _plain_key(state, lo, hi):
    """`coherence_key` field by field, one operation at a time (the
    reference's formulation)."""
    o, d = state[0:3], state[3:6]
    span = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((o - lo[:, None]) / span[:, None] * 31.0, 0.0, 31.0).to(torch.int32)

    def spread(x):
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    mo = spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2)
    oct_ = ((d[0] >= 0).to(torch.int32) * 4 + (d[1] >= 0).to(torch.int32) * 2
            + (d[2] >= 0).to(torch.int32))
    db = torch.clamp(((d[0:2] + 1.0) * 3.99).to(torch.int32), 0, 7)
    key = (oct_ << 21) | ((db[0] * 8 + db[1]) << 15) | mo
    return torch.where(state[9] > 0.5, key, 0x40000000).to(torch.int32)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_coherence_key_equals_plain_fields(scale):
    """The table-driven key against the fields computed one operation at a
    time: origins inside and far outside the scene box, directions of every
    sign, zeros of both signs, infinities, dead rays."""
    g = torch.Generator().manual_seed(int(scale * 1000))
    R = 20_000
    state = torch.randn((10, R), generator=g) * scale
    state[3:6] = torch.randn((3, R), generator=g) * 2.0
    state[3:6, :100], state[3:6, 100:200] = 0.0, -0.0
    state[0:3, 200:300], state[0:3, 300:400] = float("inf"), -float("inf")
    state[3:6, 400:500], state[3:6, 500:600] = float("inf"), -float("inf")
    state[9] = (torch.rand(R, generator=g) > 0.3).float()
    lo, hi = torch.tensor([-2.0, -1.5, -3.0]), torch.tensor([2.5, 1.0, 3.0])
    got = wf.coherence_key(state, lo, hi)
    assert got.dtype == torch.int32 and torch.equal(got, _plain_key(state, lo, hi))


@pytest.mark.parametrize("per_pass", [None, 2])
def test_render_step_equals_a_sample_at_a_time(case, per_pass, monkeypatch):
    """`render_step` on the wavefront route draws the samples' jitter in
    passes of `JITTER_RAYS` rays (all three samples here, or two and then
    one): the image equals the running average of `sample_image`, one
    sample at a time with the same seeds, bit for bit."""
    name, (o, d, scene), _ = case
    if per_pass is not None:
        monkeypatch.setattr(pt, "JITTER_RAYS", per_pass * W * H)
    pkt = SCENES[name]().build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    cfg = RenderConfig(width=W, height=H, max_depth=MAX_DEPTH)
    assert pt.route(pkt, cfg) == "wavefront"
    spp, gen = 3, torch.Generator().manual_seed(9)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, "cpu"), gen, cfg, spp=spp)
    gen = torch.Generator().manual_seed(9)
    want = torch.zeros((H, W, 3))
    for n in range(1, spp + 1):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
        img = pt.sample_image(wf.prepare_scene(pkt, screen_cam=cam), cam, cfg, seed, n)
        inv_n, w_old = rk._average_weights(n)
        want.mul_(w_old).add_(img.reshape(H, W, 3) * inv_n)
    assert acc.frame == spp and torch.equal(acc.linear, want)


@pytest.mark.cuda
def test_device_choice_equals_host_decided_order_on_the_card(monkeypatch):
    """One config-4 sample at 1920x1080 through the kernels: the order and
    state entering every bounce, the colour and the selections equal the
    host-decided loop's bit for bit, and the trace makes no synchronizing
    call (torch's sync debug mode set to error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    width, height = 1920, 1080
    pkt = demo.config4_mixed_scene(128, 64).build_packet(device="cuda")
    o, d, scene = _rays(pkt, width, height)
    k = mk.TraceConsts.from_config(RenderConfig(width=width, height=height,
                                                max_depth=MAX_DEPTH))
    want_color, want_sel, entered, last, n_sorted = _host_decided(
        o, d, scene, k, wf.SORT_MIN_LIVE, (height, width), wf.LANES)
    stats = torch.zeros(len(wf.TRACE_STATS), dtype=torch.int64, device="cuda")
    args = (o, d, scene, k, MAX_DEPTH, SEED, SAMPLE)
    wf.trace(*args, tile_hint=(height, width), record=True, stats=stats)  # warm-up
    stats.zero_()
    seen = []
    bounce = wf.wave_bounce

    def recording(state, ids, *rest):
        seen.append((state.clone(), ids.clone()))
        return bounce(state, ids, *rest)

    monkeypatch.setattr(wf, "wave_bounce", recording)
    torch.cuda.set_sync_debug_mode("error")
    try:
        color, sel, _ = wf.trace(*args, tile_hint=(height, width), record=True, stats=stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(seen) == MAX_DEPTH
    for b, (state, ids) in enumerate(seen):
        want_state, want_ids = entered[b] if b < len(entered) else last
        assert torch.equal(ids, want_ids) and torch.equal(state, want_state), b
    differ = int((color != want_color).any(dim=1).sum())
    assert differ == 0 and torch.equal(sel, want_sel), differ
    counts = stats.tolist()
    print(f"config 4, 1920x1080, one sample: {dict(zip(wf.TRACE_STATS, counts))}; "
          f"{differ} of {width * height} pixels differ")
    assert counts == [n_sorted, len(entered) - 1 - n_sorted, MAX_DEPTH - len(entered)]
