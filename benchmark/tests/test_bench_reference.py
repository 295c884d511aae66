"""The benchmark's plain reference against the program's own plain path, at a
tiny size on the CPU (and on the card, where there is one): a rendered
image, a displayed frame and a training step, on the dense route (the demo)
and the wavefront route (the mixed scene with a small triangle sphere)."""

import json
import os

import pytest
import torch

from benchmark import harness, program
from benchmark.loops import frames as frames_loop
from benchmark.reference import api as ref
from benchmark.reference import rng
from benchmark.reference.scene import Scene as RefScene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
W, H = 24, 16


def tiny(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        config = json.load(f)
    config.update(width=W, height=H)
    if name == "mixed_mesh":  # 264 triangle rows: still the wavefront route
        config["meshes"] = {**config["meshes"],
                            "ball": {**config["meshes"]["ball"], "segments": 12, "rings": 6}}
    return config


def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def _render(config, device):
    packet = program.build_scene(config).build_packet(device=device)
    cam = program.camera(config, device)
    cfg = program.render_config(config)
    accum = program.AccumState.create(H, W, device=device)
    samples = []
    for j, seed in enumerate((2**40 + 7, 12345)):
        accum = program.render_step(packet, cam, accum, seed, cfg, spp=2)
        samples += [(s, 2 * j + k + 1) for k, s in enumerate(rng.sample_seeds(seed, 2))]
    pix = torch.arange(W * H, device=device)
    want = ref.render_pixels(config, RefScene.from_config(config, device), pix, samples)
    return accum.linear.reshape(-1, 3), want


def _train(config, device):
    packet = program.build_scene(config).build_packet(device=device)
    cam = program.camera(config, device)
    params = program.differentiable_params(packet, cam)
    target = torch.rand((W * H, 3), generator=torch.Generator().manual_seed(3)).to(device)
    seed = 2**33 + 99
    loss, grads = program.mse_step(params, packet, cam, target, program.render_config(config),
                                   seed=seed, spp=2)
    r_loss, r_grads = ref.mse_step(config, RefScene.from_config(config, device), target, seed, 2,
                                   block_rows=5)
    return float(loss), grads, r_loss, r_grads


@pytest.mark.parametrize("name", ["ioniq_demo", "mixed_mesh"])
def test_render_matches_program(name):
    got, want = _render(tiny(name), "cpu")
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("name", ["ioniq_demo", "mixed_mesh"])
def test_mse_step_matches_program(name):
    loss, grads, r_loss, r_grads = _train(tiny(name), "cpu")
    assert abs(loss - r_loss) <= 1e-5 * abs(r_loss)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        scale = max(float(r_grads[k].norm()), 1e-3)
        assert float((g - r_grads[k]).norm()) <= 1e-4 * scale, k


def test_displayed_frame_matches_program():
    config = tiny("ioniq_demo")
    cfg = program.render_config(config, seed=2**32 + 5)
    r = program.Renderer(program.build_scene(config), program.camera(config, "cpu"), cfg,
                         spp_per_frame=1, device="cpu")
    shown = []
    for f in range(6):
        if f == 4:
            r.reset()
        shown.append(torch.as_tensor(r.draw_frame()).reshape(-1, 3))
    scene = RefScene.from_config(config, "cpu")
    pix = torch.arange(W * H)
    for frame in (2, 4):  # frame 2 holds 3 samples; frame 4 one, after the reset
        samples = frames_loop.samples_of(
            harness.Run(ROOT, {}, {}, config, {}, 2**32 + 5, 1.0, False, torch.device("cpu")),
            frame, 1, 4)
        want = ref.to_display(ref.render_pixels(config, scene, pix, samples))
        diff = (shown[frame + 1].int() - want.int()).abs()
        assert int(diff.max()) <= 1, frame


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ioniq_demo", "mixed_mesh"])
def test_reference_matches_kernels_on_card(name):
    dev = card()
    got, want = _render(tiny(name), dev)
    assert float((got - want).abs().mean()) < 1e-3
    loss, grads, r_loss, r_grads = _train(tiny(name), dev)
    assert abs(loss - r_loss) <= 1e-3 * abs(r_loss)
    for k, g in grads.items():
        scale = max(float(r_grads[k].norm()), 1e-3)
        assert float((g - r_grads[k]).norm()) <= 1e-2 * scale, k
