"""The port's spans (`utils/metrics.span`) on the CPU, at 24x16 on the
mixed-mesh scene (BASELINE config 4, the wavefront route): the names and the
nesting that `render_step` and `mse_step` record under ``torch.profiler``,
one live-count span for each bounce past 0 that the wavefront reached, the
rematerialised samples' spans inside the backward, no ``RecordFunction``
built while no profiler records, and images and gradients that a profiler
does not change. The ``cuda``-marked test checks on the card that no span
has a device-side copy and that the spans add no device event.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils import metrics
from ptre_tpu_torch.utils.config import RenderConfig

W, H = 24, 16
SPP = 2
SEED = 11
STAGES = tuple(wf.STAGE_SPANS.values()) + ("ptre.wave.live_count",)


def _setup(device="cpu", width=W, height=H):
    pkt = demo.config4_mixed_scene(12, 6).build_packet(device=device)
    cam = cam_ops.Camera.create(width=width, height=height, device=device)
    cfg = RenderConfig(width=width, height=height, remat_bounces=True)
    return pkt, cam, cfg


def _render(pkt, cam, cfg):
    accum = pt.AccumState.create(cam.height, cam.width, pkt.device)
    return pt.render_step(pkt, cam, accum, SEED, cfg, spp=SPP).linear.clone()


def _train(pkt, cam, cfg):
    target = torch.full((cam.height * cam.width, 3), 0.25, device=pkt.device)
    return train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg,
                          seed=SEED, spp=SPP)


def _profiled(fn, *args, cuda=False):
    """(fn's result, every profiler event as (name, start, end, on the
    device), by start)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
    events = sorted(((e.name, e.time_range.start, e.time_range.end,
                      e.device_type == torch.autograd.DeviceType.CUDA)
                     for e in prof.events()), key=lambda e: e[1])
    return out, events


def _spans(events, name):
    return [(a, b) for n, a, b, _ in events if n == name]


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def _starts_in(child, parent):
    return parent[0] <= child[0] <= parent[1]


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    return _setup()


@pytest.fixture(scope="module")
def rendered(scene):
    bounces = wf.live_bounces
    image, events = _profiled(_render, *scene)
    return image, events, wf.live_bounces - bounces


@pytest.fixture(scope="module")
def trained(scene):
    return _profiled(_train, *scene)


def test_render_step_spans_nest(scene, rendered):
    assert pt.route(scene[0], scene[2]) == "wavefront"
    _, events, _ = rendered
    (step,) = _spans(events, "ptre.render.step")
    (pack,) = _spans(events, "ptre.render.pack")
    samples = _spans(events, "ptre.render.sample")
    assert len(samples) == SPP
    assert _inside(pack, step) and pack[1] <= samples[0][0]
    assert all(_inside(s, step) for s in samples)
    assert samples[0][1] <= samples[1][0]
    names = {n for n, *_ in events if n.startswith("ptre.")}
    assert {"ptre.wave.gather", "ptre.wave.mask", "ptre.wave.compact", "ptre.wave.bounce",
            "ptre.wave.live_count"} <= names <= {"ptre.render.step", "ptre.render.pack",
                                                 "ptre.render.sample", *STAGES}
    for name in STAGES:
        for sp in _spans(events, name):
            assert sum(_inside(sp, s) for s in samples) == 1, name


def test_one_live_count_span_per_bounce_past_zero(scene, rendered):
    _, events, bounces = rendered
    max_depth = scene[2].max_depth
    samples = _spans(events, "ptre.render.sample")
    traced = 0
    for s in samples:
        n_bounce = sum(_inside(b, s) for b in _spans(events, "ptre.wave.bounce"))
        n_wait = sum(_inside(w, s) for w in _spans(events, "ptre.wave.live_count"))
        # a bounce past 0 reads the live count first; a trace that found no
        # live ray stopped after that read, one bounce short
        assert n_wait == (n_bounce - 1 if n_bounce == max_depth else n_bounce), s
        traced += n_bounce
    assert traced == bounces > SPP


def test_mse_step_remat_samples_open_spans_in_the_backward(trained):
    _, events = trained
    (step,) = _spans(events, "ptre.train.step")
    (pack,) = _spans(events, "ptre.train.pack")
    (forward,) = _spans(events, "ptre.train.forward")
    (backward,) = _spans(events, "ptre.train.backward")
    for sp in (pack, forward, backward):
        assert _inside(sp, step)
    assert pack[1] <= forward[0] and forward[1] <= backward[0]
    samples = _spans(events, "ptre.train.sample")
    assert sum(_starts_in(s, forward) for s in samples) == SPP
    assert sum(_starts_in(s, backward) for s in samples) == SPP
    assert len(samples) == 2 * SPP
    waits = _spans(events, "ptre.wave.live_count")
    assert waits and all(sum(_inside(w, s) for s in samples) == 1 for w in waits)
    assert sum(_starts_in(w, backward) for w in waits) == len(waits) // 2


def test_span_builds_no_record_function_without_a_profiler(scene, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a RecordFunction was built for {name}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert metrics.span("ptre.a") is metrics.span("ptre.b")
    _render(*scene)
    loss, grads = _train(*scene)
    assert float(loss) > 0 and float(grads["mat_albedo"].abs().max()) > 0


def test_spans_are_off_where_the_fast_event_is_missing(scene, monkeypatch):
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    _, events = _profiled(_render, *scene)
    assert events and not [n for n, *_ in events if n.startswith("ptre.")]


def test_profiler_changes_no_image_and_no_gradient(scene, rendered, trained):
    assert torch.equal(rendered[0], _render(*scene))
    (loss, grads), (loss0, grads0) = trained[0], _train(*scene)
    assert float(loss) == float(loss0) and set(grads) == set(grads0)
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k


@pytest.mark.cuda
def test_spans_have_no_device_copy_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the profiler's device trace)")
    pkt, cam, cfg = _setup("cuda", 64, 32)
    _render(pkt, cam, cfg)
    _train(pkt, cam, cfg)  # builds and warms the kernels
    counts = {}
    for fn in (_render, _train):
        _, events = _profiled(fn, pkt, cam, cfg, cuda=True)
        spans = [e for e in events if e[0].startswith("ptre.")]
        assert spans and not [e for e in spans if e[3]], fn.__name__
        counts[fn] = sum(e[3] for e in events)
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    for fn in (_render, _train):
        _, events = _profiled(fn, pkt, cam, cfg, cuda=True)
        assert not [e for e in events if e[0].startswith("ptre.")]
        assert sum(e[3] for e in events) == counts[fn], fn.__name__
