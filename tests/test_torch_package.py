"""Package rules of the PyTorch port: no jax, no hidden fallback.

The port may import only the jax-free reference modules; its CUDA wrappers
run the plain versions only for CPU tensors; a missing nvcc raises; and
render_step refuses, before any CUDA call, a packet neither CUDA route (the
dense render kernel, the wavefront kernels) can take instead of running
plain PyTorch on the card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptre_tpu.utils.config import RenderConfig
from ptre_tpu.utils.errors import RendererError
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models.scene import PACKET_LEAVES, Material, MaterialKind
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops import integrator
from ptre_tpu_torch.ops.cuda import fused_grad
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "ptre_tpu_torch",
    "ptre_tpu_torch.utils.device",
    "ptre_tpu_torch.utils.interop",
    "ptre_tpu_torch.ops.vecmat",
    "ptre_tpu_torch.ops.camera",
    "ptre_tpu_torch.ops.rng",
    "ptre_tpu_torch.ops.integrator",
    "ptre_tpu_torch.ops.cuda.build",
    "ptre_tpu_torch.ops.cuda.megakernel",
    "ptre_tpu_torch.ops.cuda.render_kernel",
    "ptre_tpu_torch.ops.cuda.wavefront",
    "ptre_tpu_torch.models.scene",
    "ptre_tpu_torch.models.demo",
    "ptre_tpu_torch.render.pathtracer",
    "ptre_tpu_torch.ops.gradsafe",
    "ptre_tpu_torch.ops.path_replay",
    "ptre_tpu_torch.ops.cuda.replay_kernel",
    "ptre_tpu_torch.ops.cuda.fused_grad",
    "ptre_tpu_torch.parallel.sharding",
    "ptre_tpu_torch.render.train",
]
#: the reference modules the port may import: all jax-free
ALLOWED_REFERENCE = {"ptre_tpu", "ptre_tpu.models", "ptre_tpu.models.mesh",
                     "ptre_tpu.utils", "ptre_tpu.utils.config",
                     "ptre_tpu.utils.errors", "ptre_tpu.utils.image"}


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        f"for m in {SLICE_MODULES!r}: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax'))\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'ptre_tpu')\n"
        "print(repr((bad, ref)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bad, ref = eval(out.stdout.strip().splitlines()[-1])
    assert bad == [], bad
    assert set(ref) <= ALLOWED_REFERENCE, set(ref) - ALLOWED_REFERENCE


def _small_inputs(H=8, W=16):
    torch.set_num_threads(1)
    cfg = RenderConfig(width=W, height=H, max_depth=2)
    scene = mk.pack_scene(demo.reference_demo_scene(8, 4).build_packet())
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H))
    prev = torch.from_numpy(np.random.default_rng(5).random((H, W, 3), np.float32))
    return cfg, scene, rows, prev


def test_cuda_wrapper_on_cpu_runs_plain_version_without_launch():
    cfg, scene, rows, prev = _small_inputs()
    before = rk.launches
    out = prev.clone()
    ret = rk.sample_accum(out, scene, rows, 2, cfg, seed=9)
    assert ret is out  # in place
    ref = rk.sample_accum_reference(prev, scene, rows, 2, cfg, seed=9)
    assert torch.equal(out, ref)
    assert rk.launches == before


def test_wrapper_rejects_devices_other_than_cuda_and_cpu():
    cfg, scene, rows, _ = _small_inputs()
    with pytest.raises(RendererError, match="cuda or cpu"):
        rk.sample_accum(torch.empty((8, 16, 3), device="meta"), scene, rows, 1, cfg)


def test_build_raises_clearly_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    build.load_library.cache_clear()
    try:
        with pytest.raises(RendererError, match="nvcc not found"):
            build.load_library()
    finally:
        build.load_library.cache_clear()
    assert not (tmp_path / "build").exists()


def test_render_step_refuses_non_dense_packet_on_cuda():
    """A packet past the dense class has the wavefront's CUDA path when the
    wavefront takes it; any other packet is refused on CUDA."""
    tri = demo.config3_scene(segments=24, rings=12).build_packet()
    assert tri.num_triangles > mk.DENSE_MAX_TRI
    assert pt.route(tri) == "wavefront"
    pt.check_dispatch(tri, torch.device("cuda"))

    too_big = dataclasses.replace(
        tri, tri_valid=torch.zeros(wf.MAX_WAVE_TRIS + 128, dtype=torch.bool))
    assert pt.route(too_big) == "none"
    with pytest.raises(NotImplementedError, match="triangle rows"):
        pt.check_dispatch(too_big, torch.device("cuda"))

    many_mats = demo.reference_demo_scene(8, 4)
    for i in range(mk.MAX_MATS):
        many_mats.add_material(Material(MaterialKind.OREN_NAYAR, (0.1 * i,) * 3, 0.5))
    with pytest.raises(NotImplementedError):
        pt.check_dispatch(many_mats.build_packet(), "cuda")

    # the dense demo packet has its CUDA path; any packet has the CPU one
    assert pt.route(demo.reference_demo_scene(8, 4).build_packet()) == "dense"
    pt.check_dispatch(demo.reference_demo_scene(8, 4).build_packet(), "cuda")
    pt.check_dispatch(too_big, "cpu")
    with pytest.raises(NotImplementedError):
        pt.check_dispatch(tri, "meta")


def test_wavefront_wrappers_on_cpu_run_plain_versions_without_launch():
    torch.set_num_threads(1)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    pkt = demo.config4_mixed_scene(12, 6).build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    before = (wf.mask_launches, wf.bounce_launches, rk.launches)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W), 3, cfg, spp=2)
    assert (wf.mask_launches, wf.bounce_launches, rk.launches) == before
    assert acc.frame == 2 and bool(torch.isfinite(acc.linear).all())
    scene = wf.prepare_scene(pkt)
    k = mk.TraceConsts.from_config(cfg)
    state = torch.zeros((wf.STATE_ROWS, 64))
    state[9] = 1.0
    assert torch.equal(wf.wave_mask(state, scene.boxes, k.t_min, 32),
                       wf.wave_mask_reference(state, scene.boxes, k.t_min, 32))
    meta = torch.empty((wf.STATE_ROWS, 64), device="meta")
    with pytest.raises(RendererError, match="cuda or cpu"):
        wf.wave_mask(meta, scene.boxes, k.t_min, 32)
    short, cnt = wf.all_leaves(2, scene.n_leaf)
    ids = torch.arange(64, dtype=torch.int32)
    with pytest.raises(RendererError, match="cuda or cpu"):
        wf.wave_bounce(meta, ids, short, cnt, scene, k, 0)
    assert (wf.mask_launches, wf.bounce_launches) == before[:2]



def test_training_refuses_non_dense_packet_on_cuda_before_any_cuda_call(monkeypatch):
    """mse_step, two_pass_mse_step and trace_grad raise NotImplementedError
    for a packet the dense kernels refuse, before building or launching
    anything. The CUDA tensors are fake ones (no card here): nothing may
    touch them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA call was made")

    monkeypatch.setattr(build, "load_library", no_cuda)
    big = demo.config3_scene(segments=24, rings=12).build_packet()
    assert not mk.dense_supported(big)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H)
    cam = cam_ops.Camera.create(width=W, height=H)
    with FakeTensorMode(allow_non_fake_inputs=True):
        pkt = dataclasses.replace(big, **{
            k: torch.empty_like(getattr(big, k), device="cuda") for k in PACKET_LEAVES})
        target = torch.zeros((W * H, 3), device="cuda")
        o = torch.zeros((W * H, 3), device="cuda")
        assert target.device.type == "cuda" and pkt.device.type == "cuda"
        params = {k: torch.empty_like(v, device="cuda")
                  for k, v in sh.differentiable_params(big, cam).items()}
        for step in (train.mse_step, train.two_pass_mse_step):
            with pytest.raises(NotImplementedError, match="A5, A14, B11"):
                step(params, pkt, cam, target, cfg, seed=1, spp=2)
        with pytest.raises(NotImplementedError, match="A5, A14, B11"):
            fused_grad.trace_grad(o, o, pkt, cfg)
        with pytest.raises(NotImplementedError, match="A5, A14, B11"):
            integrator.trace(o, o, pkt, cfg)
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        integrator.check_grad_dispatch(demo.reference_demo_scene(8, 4).build_packet(),
                                       "meta")


def test_gradient_wrappers_on_cpu_run_plain_versions_without_launch():
    torch.set_num_threads(1)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    pkt = demo.reference_demo_scene(8, 4).build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    before = (mk.record_launches, fused_grad.launches)
    loss, grads = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam,
                                 torch.zeros((W * H, 3)), cfg, seed=2)
    assert (mk.record_launches, fused_grad.launches) == before
    assert set(grads) == set(sh.PARAM_KEYS) and float(loss) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    with pytest.raises(RendererError, match="cuda or cpu"):
        mk.trace_fused_sel(torch.empty((4, 3), device="meta"),
                           torch.empty((4, 3), device="meta"),
                           mk.pack_scene(pkt), mk.TraceConsts.from_config(cfg), 3)
