"""The port's engine facade, checkpoint, image IO and CLI, on the CPU.

The 14 contracts of `tests/test_engine_cli.py` on the port
(``device="cpu"``), then the port against the JAX package:

  * `Renderer` frame for frame against JAX's on the same scene, seed and
    size (24x16, max_depth 3). JAX on the CPU takes its staged route, so
    the port's side sets ``intersect_backend="pallas"`` (the staged route,
    keyed by the same threefry frame keys): ``accum.linear`` within 1e-5
    relative and absolute (the same formulas rounded in other orders,
    `tests/test_torch_staged.py`), each path-traced uint8 frame within 1
    display step (a 1e-5 difference can cross a truncation boundary), and
    the raster frame within `tests/test_torch_rasterizer.py`'s golden bound
    (>= 99.5 % of channels within 2 steps, none beyond 8);
  * the fused routes' frame seed equals JAX's ``randint`` of the same key;
  * a checkpoint written by either package loads in the other;
  * resume from a checkpoint is bit-equal to an uninterrupted run, on the
    dense and the staged routes.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import rng as jrng
from ptre_tpu.render import engine as jengine
from ptre_tpu.utils import checkpoint as jckpt
from ptre_tpu.utils.config import RasterConfig as JRasterConfig
from ptre_tpu.utils.config import RenderConfig as JRenderConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render.engine import EngineKind, Renderer
from ptre_tpu_torch.utils import checkpoint as ckpt
from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig
from ptre_tpu_torch.utils.errors import CheckpointError
from ptre_tpu_torch.utils.image import read_ppm, write_image, write_ppm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _renderer(w=24, h=16, config=None, **kw):
    scn = demo.reference_demo_scene(8, 4)
    cam = cam_ops.Camera.create(width=w, height=h, device="cpu")
    return Renderer(
        scn, cam, config or RenderConfig(width=w, height=h),
        RasterConfig(width=w, height=h, supersample=1), device="cpu", **kw,
    )


# -- tests/test_engine_cli.py's contracts ---------------------------------------

def test_default_engine_is_pathtracer():
    r = _renderer()
    assert r.engine == EngineKind.PATHTRACER
    assert r.accum.linear.device.type == "cpu"


def test_engine_toggle_deferred_to_frame_boundary():
    r = _renderer()
    r.toggle_engine()
    assert r.engine == EngineKind.PATHTRACER
    r.draw_frame()
    assert r.engine == EngineKind.RASTERIZER
    r.toggle_engine()
    r.draw_frame()
    assert r.engine == EngineKind.PATHTRACER


def test_progressive_accumulation_across_frames():
    r = _renderer()
    r.draw_frame()
    assert r.accum.frame == 1
    r.draw_frame()
    assert r.accum.frame == 2
    r.reset()
    r.draw_frame()
    assert r.accum.frame == 1  # pending reset applied at frame start


def test_scene_edit_rebuilds_packet_without_reset():
    r = _renderer()
    r.draw_frame()
    before = r._pt_packet
    r.scene.get_model("wall").set_transforms(1.0, 0.0, (0.5, 0.5, 0.0))
    assert r.scene.modified()
    r.draw_frame()
    assert r.accum.frame == 2  # accumulated through the edit (ghosting)
    assert r._pt_packet is not before and not r.scene.modified()
    assert float(r._pt_packet.transforms[0, 3, 0]) == 0.5


def test_reset_on_edit_config():
    r = _renderer(config=RenderConfig(width=24, height=16, reset_on_edit=True))
    r.draw_frame()
    r.scene.get_model("wall").set_transforms(1.0, 0.0, (0.5, 0.5, 0.0))
    r.draw_frame()
    assert r.accum.frame == 1  # auto-reset applied


def test_run_sequence_and_metrics(tmp_path):
    r = _renderer()
    last = r.run(3, out_dir=str(tmp_path), file_pattern="f_{:03d}.ppm")
    assert last.shape == (16, 24, 3) and last.dtype == np.uint8
    assert sorted(os.listdir(tmp_path)) == ["f_000.ppm", "f_001.ppm", "f_002.ppm"]
    assert r.metrics.fps > 0 and r.metrics.mrays_per_s > 0
    assert "fps:" in r.metrics.summary()
    assert [f.samples_accumulated for f in r.metrics.frames] == [1, 2, 3]


def test_toggle_every_in_run(tmp_path):
    r = _renderer()
    r.run(4, out_dir=str(tmp_path), toggle_every=2)
    assert r.engine == EngineKind.RASTERIZER
    assert r.accum.frame == 2  # only the PT frames accumulated
    assert len(r.metrics.frames) == 4


def test_checkpoint_roundtrip(tmp_path):
    r = _renderer()
    r.draw_frame()
    r.draw_frame()
    path = str(tmp_path / "state.npz")
    ckpt.save_render_state(path, r.accum, 1984, 2, extra={"note": np.arange(3)})
    accum, seed, fi, extra = ckpt.load_render_state(path, device="cpu")
    assert seed == 1984 and fi == 2
    assert torch.equal(accum.linear, r.accum.linear)
    assert accum.frame == 2 and isinstance(accum.frame, int)
    assert torch.equal(extra["note"], torch.arange(3))
    assert not os.path.exists(path + ".tmp")

    r2 = _renderer()
    r2.accum = accum
    r2._frame_index = fi
    r2.draw_frame()
    assert r2.accum.frame == 3


def test_checkpoint_missing_or_unknown_version_raises(tmp_path):
    with pytest.raises(CheckpointError):
        ckpt.load_render_state(str(tmp_path / "nope.npz"), device="cpu")
    bad = tmp_path / "v2.npz"
    np.savez(bad, version=np.int64(2), linear=np.zeros((1, 1, 3), np.float32),
             frame=np.int32(0), seed=np.int64(0), frame_index=np.int64(0))
    with pytest.raises(CheckpointError, match="version 2"):
        ckpt.load_render_state(str(bad), device="cpu")


def test_ppm_roundtrip(tmp_path):
    img = (np.arange(2 * 3 * 3) % 256).astype(np.uint8).reshape(2, 3, 3)
    p = str(tmp_path / "x.ppm")
    write_ppm(p, img)
    np.testing.assert_array_equal(read_ppm(p), img)
    write_image(str(tmp_path / "t.npy"), torch.from_numpy(img))  # a CPU tensor
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), img)
    with pytest.raises(ValueError):
        write_image(str(tmp_path / "x.bmp"), img)


def test_cli_render_and_info(tmp_path, capsys):
    from ptre_tpu_torch import cli

    rc = cli.main([
        "render", "--scene", "demo", "--width", "24", "--height", "16",
        "--frames", "2", "--spp", "1", "--out", str(tmp_path / "f"),
        "--format", "ppm", "--checkpoint", str(tmp_path / "ck.npz"), "--device", "cpu",
    ])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "f")) == ["frame_00000.ppm", "frame_00001.ppm"]
    assert os.path.exists(tmp_path / "ck.npz")

    rc = cli.main([
        "render", "--scene", "demo", "--width", "24", "--height", "16",
        "--frames", "1", "--out", str(tmp_path / "g"), "--format", "ppm",
        "--resume", str(tmp_path / "ck.npz"), "--device", "cpu",
    ])
    assert rc == 0
    capsys.readouterr()
    assert cli.main(["info", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert info["scenes"] == ["cornell", "demo", "sphere-light"]


def test_cli_raster_engine(tmp_path):
    from ptre_tpu_torch import cli

    rc = cli.main([
        "render", "--engine", "raster", "--width", "24", "--height", "16",
        "--frames", "1", "--out", str(tmp_path / "r"), "--format", "ppm", "--device", "cpu",
    ])
    assert rc == 0
    assert read_ppm(str(tmp_path / "r" / "frame_00000.ppm")).shape == (16, 24, 3)


def test_present_lags_by_one_frame():
    r = _renderer()
    r_sync = _renderer(present_async=False)
    f0 = r.draw_frame()
    assert (f0 == 0).all()  # cleared framebuffer
    s0 = r_sync.draw_frame()
    f1 = r.draw_frame()
    np.testing.assert_array_equal(f1, s0)
    s1 = r_sync.draw_frame()
    f2 = r.draw_frame()
    np.testing.assert_array_equal(f2, s1)
    s2 = r_sync.draw_frame()
    np.testing.assert_array_equal(r.flush(), s2)
    assert r.flush() is None


def test_engine_switch_drops_inflight_frame():
    r = _renderer()
    r.draw_frame()
    r.toggle_engine()
    img = r.draw_frame()  # raster presents synchronously
    assert img.shape == (16, 24, 3)
    assert r._pending_disp is None


# -- against the JAX package ----------------------------------------------------

@pytest.mark.parametrize("seed,frames", [(1984, (0, 1, 7)), (5, (0, 3)), (2**31 + 9, (2,))])
def test_fused_seed_matches_jax(seed, frames):
    """Frame ``i``'s key ``k_i = fold(key_for(seed), i)`` is JAX's, and the
    int it gives the fused routes (`pathtracer.fused_seed`) is JAX's
    ``randint(fold(k_i, 0x5EED), (), 0, 2**31 - 1)``."""
    for i in frames:
        k = jrng.fold(jrng.key_for(seed), i)
        want = int(jax.random.randint(jrng.fold(k, 0x5EED), (), 0, 2**31 - 1))
        tk = rng.fold(rng.key_for(seed), i)
        assert tk == rng.Key(*(int(w) for w in np.asarray(k)))
        assert pt.fused_seed(tk) == want
        # tensor form
        assert int(rng.uint(rng.fold(tk, 0x5EED), maxval=2**31 - 2, device="cpu")) == want


def _within_display_step(got, want, steps=1):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= steps


def test_renderer_matches_jax_frame_for_frame():
    W, H = 24, 16
    jr = jengine.Renderer(jdemo.reference_demo_scene(8, 4), jcam.Camera.create(width=W, height=H),
                          JRenderConfig(width=W, height=H, max_depth=3),
                          JRasterConfig(width=W, height=H, supersample=1))
    tr = _renderer(config=RenderConfig(width=W, height=H, max_depth=3,
                                       intersect_backend="pallas"))
    assert tr.config.seed == jr.config.seed

    def both(pt_frame=True):
        got, want = tr.draw_frame(), np.asarray(jr.draw_frame())
        assert tr.engine == jr.engine
        assert tr.accum.frame == int(jr.accum.frame)
        np.testing.assert_allclose(tr.accum.linear.numpy(), np.asarray(jr.accum.linear),
                                   rtol=1e-5, atol=1e-5)
        if pt_frame:
            _within_display_step(got, want)
        else:
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            assert (diff <= 2).mean() >= 0.995 and diff.max() <= 8
        return got

    for _ in range(3):
        both()
    for r in (tr, jr):
        r.toggle_engine()
    raster = both(pt_frame=False)
    assert raster.std() > 0
    for r in (tr, jr):
        r.toggle_engine()
        r.reset()
    first = both()
    assert (first == 0).all()  # the switch dropped the in-flight frame
    both()
    assert tr.accum.frame == 2
    _within_display_step(tr.flush(), np.asarray(jr.flush()))


def test_checkpoints_load_across_packages(tmp_path):
    W, H = 8, 6
    lin = np.random.default_rng(7).random((H, W, 3), dtype=np.float32)
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax.npz")
    from ptre_tpu.render import pathtracer as jpt

    jckpt.save_render_state(jpath, jpt.AccumState(linear=jnp.asarray(lin),
                                                  frame=jnp.asarray(5, jnp.int32)),
                            77, 9, extra={"w": np.arange(4, dtype=np.float32)})
    accum, seed, fi, extra = ckpt.load_render_state(jpath, device="cpu")
    assert (seed, fi, accum.frame) == (77, 9, 5)
    assert np.array_equal(accum.linear.numpy(), lin)
    assert torch.equal(extra["w"], torch.arange(4, dtype=torch.float32))
    # the port writes, JAX reads
    tpath = str(tmp_path / "port.npz")
    ckpt.save_render_state(tpath, pt.AccumState(torch.from_numpy(lin), 3), 11, 4,
                           extra={"w": torch.ones(2)})
    with np.load(tpath) as z:
        assert z["frame"].dtype == np.int32 and z["frame"].shape == ()
        assert sorted(z.files) == sorted(np.load(jpath).files)
    jaccum, jseed, jfi, jextra = jckpt.load_render_state(tpath)
    assert (jseed, jfi, int(jaccum.frame)) == (11, 4, 3)
    assert jaccum.frame.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(jaccum.linear), lin)
    np.testing.assert_array_equal(np.asarray(jextra["w"]), np.ones(2, np.float32))


@pytest.mark.parametrize("backend,route", [("auto", "dense"), ("pallas", "staged")])
def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, backend, route):
    cfg = RenderConfig(width=12, height=8, max_depth=3, intersect_backend=backend)
    whole = _renderer(12, 8, config=cfg, present_async=False)
    frames = [whole.draw_frame() for _ in range(6)]
    assert pt.route(whole._pt_packet, cfg) == route

    first = _renderer(12, 8, config=cfg, present_async=False)
    for _ in range(3):
        first.draw_frame()
    path = str(tmp_path / "ck.npz")
    ckpt.save_render_state(path, first.accum, cfg.seed, first._frame_index)
    resumed = _renderer(12, 8, config=cfg, present_async=False)
    resumed.accum, _, resumed._frame_index, _ = ckpt.load_render_state(path, device="cpu")
    tail = [resumed.draw_frame() for _ in range(3)]
    assert resumed.accum.frame == whole.accum.frame == 6
    assert torch.equal(resumed.accum.linear, whole.accum.linear)
    for got, want in zip(tail, frames[3:]):
        np.testing.assert_array_equal(got, want)


def test_cli_bench_prints_bench_keys(capsys):
    from ptre_tpu_torch import cli

    assert cli.main(["bench", "--width", "32", "--height", "16", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra", "device"}
    assert line["metric"] == "pathtrace_16p_mrays_per_s" and line["unit"] == "Mrays/s"
    assert set(line["extra"]) == {"fwdbwd_mrays_per_s", "fwdbwd_64spp_step_mrays_per_s"}
    assert line["value"] > 0 and all(v > 0 for v in line["extra"].values())
    assert line["device"] == {"name": "cpu", "power_limit": None}


def test_metrics_profile_trace_and_timed(tmp_path):
    """`profile_trace` writes a Chrome trace of what ran inside it (a no-op
    for None), `timed` reports its block's seconds, and the logger is the
    port's own."""
    from ptre_tpu_torch.utils import metrics

    r = _renderer()
    with metrics.profile_trace(None):
        r.draw_frame()
    with metrics.profile_trace(str(tmp_path / "trace")):
        r.draw_frame()
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        assert "traceEvents" in json.load(f)
    lines = []
    with metrics.timed("frame", sink=lines.append):
        r.draw_frame()
    assert len(lines) == 1 and lines[0].startswith("frame: ")
    metrics.configure_logging()
    assert metrics.logger.name == "ptre_tpu_torch" and metrics.logger.handlers
