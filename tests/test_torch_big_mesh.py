"""BASELINE config 3 on its 4,080-leaf mesh (`benchmark/configs/big_mesh.json`:
the uv-sphere at 512x256, 261,120 triangles, over an analytic ground) through
the port's render and training steps, against the benchmark's plain PyTorch
reference (`benchmark/reference`), on the CPU at 24x16, spp 2, the mesh at
its published tessellation: past the mask kernel's 1,024-leaf shared
design, the size the benchmark's `big_mesh` cells run at 1080p.

Tolerances are `benchmark/tests/test_bench_reference.py`'s: the image to
1e-5, the loss to a relative 1e-5, each gradient leaf to 1e-4 of its norm
(or of 1e-3 where the norm is smaller): the port's plain versions against
the reference's formulas, float32 in another order.

Marked ``cuda`` (skipped without a card): the counter of the mask kernel's
global instantiation, `wavefront.mask_launches_global`, against the
launches of wave_mask_global_kernel, and the benchmark's readers of that
kernel (`benchmark/metrics/mask_global.*_ms.py`) on traced runs; the
shortlists the mask kernel writes itself (`wavefront.wave_mask_lists`)
against the dense mask compacted by `torch.sort`, list for list and, through
1080p render steps and recording traces, pixel for pixel.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark import devtrace, harness, program
from benchmark.reference import api as ref
from benchmark.reference import rng
from benchmark.reference.scene import Scene as RefScene
from benchmark.rooflines import mask_global
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models.scene import PACKET_COUNTS, PACKET_LEAVES
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.render import pathtracer as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 24, 16
SPP = 2
RENDER_SEED = 2**40 + 7
TRAIN_SEED = 2**33 + 99
#: leaves the mask kernel's staged instantiation takes (`csrc/mask_kernel.cu`
#: kMaxMaskLeaves); the card's tests read it from the library
STAGED_LEAVES = 1024
LEAVES = ("transforms", "sph_center", "sph_radius", "mat_albedo", "mat_param", "sky_bottom",
          "sky_top", "cam_position", "cam_forward", "cam_fov")


def _config(width: int = W, height: int = H, name: str = "big_mesh") -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        config = json.load(f)
    config.update(width=width, height=height)
    return config


@pytest.fixture(scope="module")
def port():
    c = _config()
    packet = program.build_scene(c).build_packet(device="cpu")
    return dict(config=c, packet=packet, cam=program.camera(c, "cpu"),
                cfg=program.render_config(c), ref_scene=RefScene.from_config(c, "cpu"))


def test_configuration_builds_the_config3_packet(port):
    """The configuration file's scene is `demo.config3_scene(False, 512,
    256, diffuse=True)`, row for row: the scene the kernels were timed on."""
    got = port["packet"]
    want = demo.config3_scene(False, 512, 256, diffuse=True).build_packet(device="cpu")
    for k in PACKET_LEAVES:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in PACKET_COUNTS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.num_triangles == 261_120 and got.num_spheres == 1


def test_takes_the_wavefront_route_past_the_staged_mask(port):
    packet, cfg = port["packet"], port["cfg"]
    scene = wf.prepare_scene(packet)
    assert scene.n_leaf == 4080 > STAGED_LEAVES
    assert pt.route(packet, cfg) == "wavefront" and wf.supports(packet)
    assert integrator.grad_route(cfg, packet) == "fused"


@pytest.fixture(scope="module")
def rendered(port):
    p = port
    before = (wf.mask_launches, wf.mask_launches_global, wf.bounce_launches)
    accum = program.render_step(p["packet"], p["cam"],
                                program.AccumState.create(H, W, device="cpu"), RENDER_SEED,
                                p["cfg"], spp=SPP)
    assert (wf.mask_launches, wf.mask_launches_global, wf.bounce_launches) == before
    return accum.linear.reshape(-1, 3)


def test_render_step_matches_the_reference(port, rendered):
    samples = [(s, k + 1) for k, s in enumerate(rng.sample_seeds(RENDER_SEED, SPP))]
    want = ref.render_pixels(port["config"], port["ref_scene"], torch.arange(W * H), samples)
    assert float(want.max()) > 0.05
    assert float((rendered - want).abs().max()) < 1e-5


@pytest.fixture(scope="module")
def trained(port):
    p = port
    params = program.differentiable_params(p["packet"], p["cam"])
    target = torch.rand((W * H, 3), generator=torch.Generator().manual_seed(3))
    loss, grads = program.mse_step(params, p["packet"], p["cam"], target, p["cfg"],
                                   seed=TRAIN_SEED, spp=SPP)
    r_loss, r_grads = ref.mse_step(p["config"], p["ref_scene"], target, TRAIN_SEED, SPP,
                                   block_rows=8)
    return float(loss), grads, r_loss, r_grads


def test_mse_step_loss_matches_the_reference(trained):
    loss, grads, r_loss, r_grads = trained
    assert set(grads) == set(r_grads) == set(LEAVES)
    assert abs(loss - r_loss) <= 1e-5 * abs(r_loss)


@pytest.mark.parametrize("leaf", LEAVES)
def test_mse_step_gradient_matches_the_reference(trained, leaf):
    _, grads, _, r_grads = trained
    scale = max(float(r_grads[leaf].norm()), 1e-3)
    assert float((grads[leaf] - r_grads[leaf]).norm()) <= 1e-4 * scale, leaf


def _trace(names, calls: int = 2) -> devtrace.Trace:
    """A traced stretch of ``calls`` calls whose device events are ``names``,
    1 ms each."""
    dev = [(n, 1e-3 * i, 1e-3 * (i + 1)) for i, n in enumerate(names)]
    return devtrace.Trace(calls=calls, wall_s=1.0, busy_s=1e-3 * len(names), device=dev,
                          host=[], ranges=[(0.0, 1.0)])


#: kernel names as the profiler gives them
STAGED_MASK = "void ptre::wave_mask_kernel<false>(ptre::MaskParams, float const*, float const*)"
GLOBAL_MASK = ("void ptre::wave_mask_global_kernel<false>(ptre::MaskParams, float const*, "
               "float const*, float const*)")


@pytest.mark.parametrize("metric", ["mask_global.render_ms", "mask_global.train_ms"])
def test_mask_global_readers_read_the_global_launches_only(metric):
    run = harness.Run(ROOT, {}, {}, _config(1920, 1080), {}, 1, 1.0, True,
                      torch.device("cpu"))
    assert harness.read_metric(run, metric) is None  # untraced
    run.profile = _trace([STAGED_MASK, "void ptre::wave_bounce_kernel<false, false>"] * 4)
    assert harness.read_metric(run, metric) is None
    run.profile = _trace([STAGED_MASK, GLOBAL_MASK, GLOBAL_MASK])
    assert harness.read_metric(run, metric) == pytest.approx(1.0)  # 2 ms over 2 calls


def test_mask_global_roofline_counts_the_configuration():
    """Least bytes of a 1080p launch: 4,080 leaf boxes and 510 supertile
    boxes of 32 B read, 8,100 blocks x 4,080 verdict bits written."""
    run = harness.Run(ROOT, {}, {}, _config(1920, 1080), {}, 1, 1.0, True,
                      torch.device("cpu"))
    assert mask_global.leaves(run.config) == 4080
    assert mask_global.least_bytes(run, 3) == 3 * (32 * 4080 + 32 * 510 + 8100 * 4080 / 8)
    run.profile = _trace([GLOBAL_MASK] * 3)
    share = harness.read_metric(run, "mask_global_roofline")
    assert share == pytest.approx(100.0 * mask_global.least_bytes(run, 3)
                                  / harness.PEAK_BYTES_PER_S / 3e-3)
    assert 0.0 < share < 100.0
    assert not mask_global.matches(STAGED_MASK) and mask_global.matches(GLOBAL_MASK)


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("segments, rings, leaves", [(256, 128, 1016), (320, 128, 1270),
                                                     (512, 256, 4080)])
def test_mask_launches_global_counts_the_global_instantiation(cuda, segments, rings, leaves):
    """One more a launch past the library's staged cap, none at or below it;
    ``mask_launches`` counts every launch either way."""
    cap = build.load_library().ptre_wave_mask_max_staged_leaves()
    assert cap == STAGED_LEAVES
    packet = demo.config3_scene(False, segments, rings, diffuse=True).build_packet(device=cuda)
    scene = wf.prepare_scene(packet)
    assert scene.n_leaf == leaves
    state = torch.zeros((wf.STATE_ROWS, 512), device=cuda)
    state[4], state[9] = 1.0, 1.0
    before = (wf.mask_launches, wf.mask_launches_global)
    for n in range(1, 4):
        wf.wave_mask(state, scene.boxes, 1e-6, supers=scene.mask_supers)
        assert wf.mask_launches == before[0] + n
        assert wf.mask_launches_global == before[1] + (n if leaves > cap else 0)


def _traced(workload: str, device, overrides: dict):
    run, _, _ = harness.measure(ROOT, workload, 2**31 + 17, 0.5, True, device, time.time(),
                                overrides)
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["big_mesh.render", "big_mesh.train"])
def test_mask_global_ms_reads_the_traced_launches(cuda, workload, monkeypatch):
    """A traced run of the cell at 256x128: the trace's launches of the
    global instantiation equal the counter's growth over the same calls,
    and the cell's reader reads above 0."""
    counted = []
    call = devtrace.trace_calls

    def trace_calls(fn, count):
        before = wf.mask_launches_global
        out = call(fn, count)
        counted.append(wf.mask_launches_global - before)
        return out

    monkeypatch.setattr(devtrace, "trace_calls", trace_calls)
    run = _traced(workload, cuda, {"width": 256, "height": 128})
    launches, _ = run.profile.kernel(mask_global.matches)
    assert launches > 0 and counted == [launches]
    metric = "mask_global." + workload.split(".")[1] + "_ms"
    assert harness.read_metric(run, metric) > 0.0
    if workload == "big_mesh.render":
        assert 0.0 < harness.read_metric(run, "mask_global_roofline") < 100.0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mixed_mesh.render", "mixed_mesh.train"])
def test_mask_global_ms_reads_none_on_mixed_mesh(cuda, workload):
    """254 leaves: the staged instantiation alone, so the readers read None."""
    run = _traced(workload, cuda, {"width": 256, "height": 128})
    assert run.profile.kernel(lambda n: "wave_mask_kernel" in n)[0] > 0
    for metric in ("mask_global.render_ms", "mask_global.train_ms"):
        assert harness.read_metric(run, metric) is None


def _sorted_lists(mask):
    """The compaction as `torch.sort` made it before the mask kernel wrote
    the shortlists: each row's leaves ascending, then n_leaf."""
    n_leaf = mask.shape[1]
    cnt = mask.sum(dim=1, dtype=torch.int32)
    dropped, order = torch.sort(torch.logical_not(mask).view(torch.uint8), dim=1, stable=True)
    return order.to(torch.int32).masked_fill_(dropped.view(torch.bool), n_leaf), cnt


def _dense_then_sorted(state, boxes, t_min, lanes=wf.LANES, stats=None, supers=None):
    """`wave_mask_lists` as the dense mask and the sort."""
    return _sorted_lists(wf.wave_mask(state, boxes, t_min, lanes, stats, supers))


def _assert_lists_equal(got, want):
    (short, cnt), (w_short, w_cnt) = got, want
    assert torch.equal(cnt, w_cnt)
    on = torch.arange(short.shape[1], device=short.device)[None, :] < cnt[:, None].long()
    assert torch.equal(short[on], w_short[on])


#: the 1080p scenes of the two mask instantiations: config 4 (254 leaves,
#: staged) and the 4,080-leaf mesh (global)
LIST_SCENES = {
    "config4": ("config4_mixed_scene", dict(segments=128, rings=64)),
    "4080_leaves": ("config3_scene", dict(flat=False, segments=512, rings=256, diffuse=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", list(LIST_SCENES))
def test_mask_lists_equal_the_sorted_dense_mask(cuda, mesh):
    """At every bounce past 0 of a 1080p sample: `wave_mask_lists`' counts
    and each row's [0, count) equal those of the dense mask compacted by
    the standalone kernel (`shortlists_from_mask`) and by `torch.sort`, and
    the counting instantiation gives the same lists and the dense form's
    live rays (the tests a walk makes depend on the order its warps list
    leaves in, so they differ from launch to launch); each call is one more
    ``shortlists_on_card``."""
    import chip_smoke

    _, _, scene, k, _, _, short0, states = chip_smoke.mask_states(
        cuda, (mesh, LIST_SCENES[mesh], 1920, 1080))
    assert len(states) == 4 and (scene.n_leaf > STAGED_LEAVES) == (mesh == "4080_leaves")
    for b, state, _ in states:
        before = (wf.shortlists_on_card, wf.shortlists_sorted)
        got = wf.wave_mask_lists(state, scene.boxes, k.t_min, supers=scene.mask_supers)
        mask = wf.wave_mask(state, scene.boxes, k.t_min, supers=scene.mask_supers)
        standalone = wf.shortlists_from_mask(mask)
        assert (wf.shortlists_on_card, wf.shortlists_sorted) == (before[0] + 2, before[1])
        counts = [torch.zeros(len(wf.MASK_STATS), dtype=torch.int64, device=cuda)
                  for _ in range(2)]
        counted = wf.wave_mask_lists(state, scene.boxes, k.t_min, stats=counts[0],
                                     supers=scene.mask_supers)
        wf.wave_mask(state, scene.boxes, k.t_min, stats=counts[1], supers=scene.mask_supers)
        want = _sorted_lists(mask)
        for lists in (got, standalone, counted):
            _assert_lists_equal(lists, want)
        live = wf.MASK_STATS.index("live_rays")
        assert int(counts[0][live]) == int(counts[1][live]) == int((state[9] > 0.5).sum()), b
        assert bool((counts[0] > 0).all()), b
        assert 0 < int(got[1].sum()) < mask.numel(), b
    _assert_lists_equal(short0, _sorted_lists(wf.screen_block_mask(
        scene.leaf_screen, 1080, 1920, wf.TILE_ROWS, wf.LANES // wf.TILE_ROWS)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["big_mesh", "mixed_mesh"])
def test_render_step_equals_the_sorted_compaction(cuda, name, monkeypatch):
    """A 1080p `render_step` at spp 4 of the benchmark's configuration
    compacts 20 times on the card (bounce 0's screen-binned mask and 4 mask
    bounces a sample) and sorts nothing, and its image is bit for bit that
    of the same step with every compaction the dense mask and `torch.sort`;
    so are a recording trace's colours and selections."""
    c = _config(1920, 1080, name)
    packet = program.build_scene(c).build_packet(device=cuda)
    cam, cfg = program.camera(c, cuda), program.render_config(c)
    assert cfg.max_depth == 5 and pt.route(packet, cfg) == "wavefront"
    scene = wf.prepare_scene(packet, screen_cam=cam)
    k = mk.TraceConsts.from_config(cfg)
    px, py = pt.pixel_grid(1080, 1920, cuda)
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, torch.zeros(
        (1920 * 1080, 2), device=cuda)))

    def run():
        accum = program.render_step(packet, cam, program.AccumState.create(1080, 1920),
                                    RENDER_SEED, cfg, spp=4)
        rec = wf.trace(o, d, scene, k, cfg.max_depth, 11, 1, tile_hint=(1080, 1920),
                       record=True)
        return accum.linear, rec[0], rec[1]

    before = (wf.shortlists_on_card, wf.shortlists_sorted)
    got = run()
    torch.cuda.synchronize()
    assert wf.shortlists_on_card - before[0] == 20 + 5  # the step, then the trace
    assert wf.shortlists_sorted == before[1]
    monkeypatch.setattr(wf, "wave_mask_lists", _dense_then_sorted)
    monkeypatch.setattr(wf, "shortlists_from_mask", _sorted_lists)
    want = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(got[0].max()) > 0.05 and int((got[2] >= 0).sum()) > 0
