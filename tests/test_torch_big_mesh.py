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
kernel (`benchmark/metrics/mask_global.*_ms.py`) on traced runs.
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
from ptre_tpu_torch.ops import integrator
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


def _config(width: int = W, height: int = H) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "big_mesh.json")) as f:
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
