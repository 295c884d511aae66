"""Package rules of the PyTorch port: no jax, no hidden fallback.

The port imports neither jax nor any module of the JAX package ``ptre_tpu``
(it has its own copies of the mesh generators, the configs and the errors),
and chip_smoke.py names none of them either; the port's CUDA wrappers
run the plain versions only for CPU tensors; a missing nvcc raises; and
render_step and the training steps route, before any CUDA call, a packet
neither fused route (the dense kernels, the wavefront kernels) takes to the
staged route and its sweep kernel, and refuse the plain sweep on the card
instead of running plain PyTorch there.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptre_tpu_torch.utils.config import RenderConfig
from ptre_tpu_torch.utils.errors import ConfigError, RendererError
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

PORT_DIR = os.path.join(REPO, "ptre_tpu_torch")


def _port_modules():
    """Every module of the port, found on disk (new modules included)."""
    mods = []
    for root, dirs, files in os.walk(PORT_DIR):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        rel = os.path.relpath(root, REPO).replace(os.sep, ".")
        for f in sorted(files):
            if f == "__init__.py":
                mods.append(rel)
            elif f.endswith(".py"):
                mods.append(f"{rel}.{f[:-3]}")
    return mods


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor any module
    of the JAX package ``ptre_tpu``: the allowed set is empty."""
    mods = _port_modules()
    assert "ptre_tpu_torch.render.rasterizer" in mods and len(mods) > 25, mods
    code = (
        "import sys\n"
        f"for m in {mods!r}: __import__(m)\n"
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
    assert ref == [], ref


def _imported_modules(path):
    """Every module an ``import`` or ``from ... import`` in the file names,
    at any depth (top level or inside functions)."""
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


@pytest.mark.parametrize("path", ["chip_smoke.py", "chip_ablations.py", "ptre_tpu_torch"])
def test_sources_name_no_jax_and_no_reference_module(path):
    """No import statement of chip_smoke.py, chip_ablations.py or of any port
    source names jax or a ``ptre_tpu`` module (read with ast: importing chip_smoke runs nothing,
    so its imports inside functions must be read, not executed)."""
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(r, f) for r, _, fs in os.walk(full) for f in fs if f.endswith(".py")]
    found = {}
    for f in files:
        for name in _imported_modules(f):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "ptre_tpu"):
                found.setdefault(os.path.relpath(f, REPO), []).append(name)
    assert found == {}, found
    if path == "chip_smoke.py":
        names = _imported_modules(full)
        assert "ptre_tpu_torch.utils.config" in names
        assert "ptre_tpu_torch.render.rasterizer" in names


def _small_inputs(H=8, W=16):
    torch.set_num_threads(1)
    cfg = RenderConfig(width=W, height=H, max_depth=2)
    scene = mk.pack_scene(demo.reference_demo_scene(8, 4).build_packet(device="cpu"))
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
    wavefront takes it; any other packet takes the staged route (the sweep
    kernel), decided from its counts. On CUDA only the plain sweep
    (``intersect_backend="xla"``) is refused."""
    tri = demo.config3_scene(segments=24, rings=12).build_packet(device="cpu")
    assert tri.num_triangles > mk.DENSE_MAX_TRI
    assert pt.route(tri) == "wavefront"
    pt.check_dispatch(tri, torch.device("cuda"))

    too_big = dataclasses.replace(
        tri, tri_valid=torch.zeros(wf.MAX_WAVE_TRIS + 128, dtype=torch.bool))
    many_mats = demo.reference_demo_scene(8, 4)
    for i in range(mk.MAX_MATS):
        many_mats.add_material(Material(MaterialKind.OREN_NAYAR, (0.1 * i,) * 3, 0.5))
    xla = RenderConfig(intersect_backend="xla")
    for pkt in (too_big, many_mats.build_packet(device="cpu")):
        assert pt.route(pkt) == "staged"
        pt.check_dispatch(pkt, torch.device("cuda"), RenderConfig())
        with pytest.raises(ConfigError, match="xla"):
            pt.check_dispatch(pkt, torch.device("cuda"), xla)
        pt.check_dispatch(pkt, "cpu", xla)

    # the dense demo packet has its CUDA path; any packet has the CPU one
    assert pt.route(demo.reference_demo_scene(8, 4).build_packet(device="cpu")) == "dense"
    pt.check_dispatch(demo.reference_demo_scene(8, 4).build_packet(device="cpu"), "cuda")
    pt.check_dispatch(too_big, "cpu")
    with pytest.raises(NotImplementedError):
        pt.check_dispatch(tri, "meta")


def test_wavefront_wrappers_on_cpu_run_plain_versions_without_launch():
    torch.set_num_threads(1)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    pkt = demo.config4_mixed_scene(12, 6).build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H)
    before = (wf.mask_launches, wf.bounce_launches, rk.launches)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 3, cfg, spp=2)
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
    """A triangle-scale packet the wavefront supports takes the fused route,
    a packet past the wavefront's caps the staged route: both decided from
    the packet's counts, before the kernel library is loaded. Forcing a
    fused forward on the over-cap packet still raises, naming the staged
    trace; integrator.trace routes it there, and the training steps pack no
    fused forward for it. The CUDA tensors are fake ones (no card here):
    nothing may touch them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA call was made")

    monkeypatch.setattr(build, "load_library", no_cuda)
    big = demo.config3_scene(segments=24, rings=12).build_packet(device="cpu")
    assert not mk.dense_supported(big) and wf.supports(big)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H)
    cam = cam_ops.Camera.create(width=W, height=H)
    with FakeTensorMode(allow_non_fake_inputs=True):
        pkt = dataclasses.replace(big, **{
            k: torch.empty_like(getattr(big, k), device="cuda") for k in PACKET_LEAVES})
        target = torch.zeros((W * H, 3), device="cuda")
        o = torch.zeros((W * H, 3), device="cuda")
        assert target.device.type == "cuda" and pkt.device.type == "cuda"
        integrator.check_grad_dispatch(pkt, target.device, cfg)
        assert integrator.grad_route(cfg, pkt) == "fused"
        for force in (None,) + fused_grad.FORWARDS[1:]:
            fused_grad.check_supported(pkt, force)
        with pytest.raises(RendererError, match="dense-class"):
            fused_grad.check_supported(pkt, "dense")
        too_big = dataclasses.replace(pkt, tri_valid=torch.zeros(
            wf.MAX_WAVE_TRIS + 128, dtype=torch.bool, device="cuda"))
        assert integrator.grad_route(cfg, too_big) == "staged"
        assert integrator.grad_route(dataclasses.replace(cfg, grad_sweep="fused"),
                                     too_big) == "staged"
        integrator.check_grad_dispatch(too_big, target.device, cfg)
        params = {k: torch.empty_like(v, device="cuda")
                  for k, v in sh.differentiable_params(big, cam).items()}
        # the steps pack no fused forward for it (prepare_forward would raise)
        assert train._forward_of(params, too_big, cam, cfg) is None
        for force in (None, "wavefront", "culled", "uncull"):
            with pytest.raises(NotImplementedError, match="staged trace"):
                fused_grad.trace_grad(o, o, too_big, cfg, force=force)
        monkeypatch.setattr(integrator, "trace_staged", lambda *a, **k: "staged")
        assert integrator.trace(o, o, too_big, cfg) == "staged"
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        integrator.check_grad_dispatch(demo.reference_demo_scene(8, 4).build_packet(device="cpu"),
                                       "meta")


def test_triangle_gradient_wrappers_on_cpu_run_plain_versions_without_launch():
    """Triangle-scale training on CPU tensors runs the plain versions: no
    kernel is launched, and the wrappers refuse other devices."""
    torch.set_num_threads(1)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    pkt = demo.config4_mixed_scene(12, 6).build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H)
    before = (wf.mask_launches, wf.bounce_launches, mk.culled_launches, mk.record_launches,
              fused_grad.launches)
    loss, grads = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam,
                                 torch.zeros((W * H, 3)), cfg, seed=2)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, -0.3, 1.0]] * 4)
    d = d / d.norm(dim=1, keepdim=True)
    fused_grad.trace_grad(o, d, pkt, cfg, force="culled")
    assert (wf.mask_launches, wf.bounce_launches, mk.culled_launches, mk.record_launches,
            fused_grad.launches) == before
    assert set(grads) == set(sh.PARAM_KEYS) and float(loss) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["transforms"].abs().max()) > 0
    table = torch.zeros((300, 27), device="meta")
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(RendererError, match="cuda or cpu"):
        fused_grad.fused_bwd(table, table, meta, meta, meta, meta,
                             mk.TraceConsts.from_config(cfg), 3, 256)


def test_gradient_wrappers_on_cpu_run_plain_versions_without_launch():
    torch.set_num_threads(1)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
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


def test_raster_wrappers_on_cpu_run_plain_versions_and_refuse_other_devices(monkeypatch):
    """The three raster wrappers run their plain versions for CPU tensors
    without a launch, raise for other devices, and the hard kernel refuses a
    table that needs a gradient on CUDA before any CUDA call (fake CUDA
    tensors: nothing may touch them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ptre_tpu_torch.ops.cuda import raster_kernel as rast
    from ptre_tpu_torch.ops.cuda import soft_raster as sr
    from ptre_tpu_torch.render import rasterizer as ras
    from ptre_tpu_torch.utils.config import RasterConfig

    torch.set_num_threads(1)
    cfg = RasterConfig(width=16, height=8, supersample=2)
    pkt = demo.reference_demo_scene(8, 4).build_packet(spheres_as_triangles=True, device="cpu")
    cam = cam_ops.Camera.create(width=16, height=8)
    before = (rast.launches, sr.fwd_launches, sr.bwd_launches)
    params = sh.differentiable_params(pkt, cam)
    loss, grads = train.raster_mse_step(params, pkt, cam, torch.zeros((8, 16, 3)), cfg)
    img = ras.rasterize(pkt, cam, cfg)
    assert (rast.launches, sr.fwd_launches, sr.bwd_launches) == before
    assert float(loss) > 0 and img.shape == (8, 16, 3)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())

    cols, cbox = sr._soft_cols(pkt, cam, cfg)
    scal = rast.raster_scalars(cfg)
    meta = torch.empty(cols.shape, device="meta")
    with pytest.raises(RendererError, match="cuda or cpu"):
        rast.raster_tiles(meta, cbox, scal, 16, 32, 2)
    with pytest.raises(RendererError, match="cuda or cpu"):
        sr.soft_forward(meta, cbox, scal, 16, 32, 2)
    with pytest.raises(RendererError, match="cuda or cpu"):
        sr.soft_backward(meta, cbox, scal, meta, meta, 16, 32, 2)

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA call was made")

    monkeypatch.setattr(build, "load_library", no_cuda)
    with FakeTensorMode(allow_non_fake_inputs=True):
        tris = torch.empty(cols.shape, device="cuda").requires_grad_(True)
        box = torch.empty(cbox.shape, device="cuda")
        with pytest.raises(RendererError, match="forward-only"):
            rast.raster_tiles(tris, box, scal, 16, 32, 2)


def test_packet_and_accumulator_default_to_the_card(monkeypatch):
    """`build_packet()` and `AccumState.create()` without a device name the
    card, as the reference's ``jnp.asarray`` names the accelerator: with no
    card they raise RendererError — nothing falls back to the CPU — and the
    scene stays marked modified."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scn = demo.reference_demo_scene(8, 4)
    for kw in ({}, {"spheres_as_triangles": True}):
        with pytest.raises(RendererError, match="CUDA device is required"):
            scn.build_packet(**kw)
    assert scn.modified()
    with pytest.raises(RendererError, match="CUDA device is required"):
        pt.AccumState.create(4, 8)


def test_packet_and_accumulator_on_the_cpu_when_asked():
    scn = demo.reference_demo_scene(8, 4)
    for dev in ("cpu", torch.device("cpu")):
        pkt = scn.build_packet(device=dev)
        assert {getattr(pkt, k).device.type for k in PACKET_LEAVES} == {"cpu"}
        acc = pt.AccumState.create(4, 8, device=dev)
        assert acc.linear.device.type == "cpu" and acc.linear.shape == (4, 8, 3)
        assert acc.frame == 0 and not bool(acc.linear.any())
    assert not scn.modified()


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """`Renderer(...)`, `Application()` and `cli render` without ``--device
    cpu`` name the card and raise RendererError where there is none:
    nothing carries on on the CPU by itself."""
    from ptre_tpu_torch import cli
    from ptre_tpu_torch.app.application import Application
    from ptre_tpu_torch.app.window import Window
    from ptre_tpu_torch.render.engine import Renderer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RendererError, match="CUDA device is required"):
        Renderer(demo.reference_demo_scene(8, 4), cam_ops.Camera.create(width=8, height=4))
    with pytest.raises(RendererError, match="CUDA device is required"):
        Application(window=Window(8, 4))
    for argv in (["render", "--width", "8", "--height", "4", "--out", str(tmp_path)],
                 ["bench", "--width", "8", "--height", "4"], ["info"]):
        with pytest.raises(RendererError, match="CUDA device is required"):
            cli.main(argv)
    assert os.listdir(tmp_path) == []


def _public_functions(path):
    tree = ast.parse(open(path).read(), filename=path)
    return {n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


@pytest.mark.parametrize("module", ["sharding", "distributed"])
def test_parallel_modules_port_every_public_function(module):
    """`parallel/sharding.py` and `parallel/distributed.py` of the port have
    every public function of the JAX package's modules of the same name (read
    with ast from both sources: the JAX module is not imported), and name
    neither jax nor a ``ptre_tpu`` module."""
    port = os.path.join(PORT_DIR, "parallel", f"{module}.py")
    ref = os.path.join(REPO, "ptre_tpu", "parallel", f"{module}.py")
    missing = _public_functions(ref) - _public_functions(port)
    assert missing == set(), missing
    assert f"ptre_tpu_torch.parallel.{module}" in _port_modules()
    names = _imported_modules(port)
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "ptre_tpu")]
    assert "torch.distributed" in names
