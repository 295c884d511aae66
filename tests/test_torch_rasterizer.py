"""The port's hard rasterizer against the JAX package's.

Same scenes (the tests/test_kernel_smoke.py cube, the demo scene), cameras
and configs on both sides; JAX on the CPU, its Pallas raster kernel in
interpret mode. Tolerances, each with its reason:

  * the vertex stage is three einsums, which XLA's CPU dot and torch's
    matmul round an ulp apart for some elements (ROADMAP §C): screen-space
    values agree to 1e-4 relative, not bit for bit;
  * a Morton code can differ where a box centre sits on a quantisation
    step, so the sort order is compared exactly on identical inputs, and
    the images within the golden bound of tests/test_goldens.py;
  * the one-shot path breaks z ties by mesh order and the kernel by Morton
    order: images may differ on samples where two triangles tie in depth
    (a shared edge), stated per test.
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.models import mesh as jmg
from ptre_tpu.models.scene import Model as JModel, Scene as JScene
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops.pallas import raster_kernel as jrk
from ptre_tpu.render import rasterizer as jras
from ptre_tpu.utils.config import RasterConfig as JRasterConfig
from ptre_tpu.utils.config import RenderConfig as JRenderConfig
from ptre_tpu.utils.image import read_ppm
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models import mesh as mg
from ptre_tpu_torch.models.scene import Model, Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import raster_kernel as rk
from ptre_tpu_torch.render import rasterizer as ras
from ptre_tpu_torch.utils import interop
from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig
from ptre_tpu_torch.utils.errors import ConfigError

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "demo_raster.ppm")


def _cube(scene_cls, model_cls, meshes):
    """tests/test_kernel_smoke.py `_raster_setup`'s scene (tri_pad 16)."""
    scn = scene_cls()
    scn.add_mesh("cube", meshes.cube())
    scn.add_model("c", model_cls("cube"))
    scn.get_model("c").set_transforms(1.0, 0.3, (0.0, 0.5, 0.0))
    return scn.build_packet(tri_pad=16)


SCENES = {
    "cube": (lambda: _cube(JScene, JModel, jmg), lambda: _cube(Scene, Model, mg)),
    "demo": (lambda: jdemo.reference_demo_scene(16, 8).build_packet(spheres_as_triangles=True),
             lambda: demo.reference_demo_scene(16, 8).build_packet(spheres_as_triangles=True)),
}


def _pair(name, W, H, ss=1, **cfg_kw):
    torch.set_num_threads(1)
    jp, tp = SCENES[name][0](), SCENES[name][1]()
    jcfg = JRasterConfig(width=W, height=H, supersample=ss, **cfg_kw)
    return (jp, jcam.Camera.create(width=W, height=H), jcfg, tp,
            cam_ops.Camera.create(width=W, height=H), interop.config_from_reference(jcfg))


def _to_uint8(img):
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def _assert_golden_bound(got, want, what):
    """tests/test_goldens.py's bound: >= 99.5 % within 2 steps, max 8."""
    diff = np.abs(_to_uint8(got).astype(np.int16) - _to_uint8(want).astype(np.int16))
    assert (diff <= 2).mean() >= 0.995, (what, (diff <= 2).mean())
    assert diff.max() <= 8, (what, diff.max())


def test_configs_equal_the_reference():
    for jcls, cls in ((JRenderConfig, RenderConfig), (JRasterConfig, RasterConfig)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        assert [(f.name, f.default) for f in dataclasses.fields(cls)] == jf
    assert interop.config_from_reference(JRasterConfig(width=8, supersample=3)) == \
        RasterConfig(width=8, supersample=3)
    assert interop.config_from_reference(JRenderConfig(max_depth=2)) == RenderConfig(max_depth=2)
    with pytest.raises(ConfigError):
        RasterConfig(supersample=0)
    with pytest.raises(ConfigError):
        RenderConfig(width=-1)
    with pytest.raises(ConfigError):
        RenderConfig(max_depth=0)


def test_meshes_equal_the_reference():
    for name, args in (("tri", ()), ("quad", ()), ("cube", ()), ("reg_polygon", (7,)),
                       ("uv_sphere", (False, 12, 6)), ("uv_sphere", (True, 8, 4))):
        jm, pm = getattr(jmg, name)(*args), getattr(mg, name)(*args)
        for f in ("positions", "normals", "indices"):
            np.testing.assert_array_equal(getattr(pm, f), getattr(jm, f), err_msg=name)
        assert int(pm.mesh_type) == int(jm.mesh_type)


@pytest.mark.parametrize("name", list(SCENES))
def test_vertex_stage_and_shade_match_reference(name):
    jp, jc, jcfg, tp, tc, cfg = _pair(name, 64, 36, 2)
    tri_v = np.stack([np.asarray(jp.tri_v0), np.asarray(jp.tri_v1), np.asarray(jp.tri_v2)], 1)
    tri_n = np.stack([np.asarray(jp.tri_n0), np.asarray(jp.tri_n1), np.asarray(jp.tri_n2)], 1)
    want = jras.transform_vertices(jnp.asarray(tri_v), jnp.asarray(tri_n), jp.tri_dc,
                                   jp.transforms, jc.view_matrix(), jc.projection_matrix())
    got = ras.transform_vertices(torch.from_numpy(tri_v), torch.from_numpy(tri_n), tp.tri_dc,
                                 tp.transforms, tc.view_matrix(), tc.projection_matrix())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    n = np.random.default_rng(3).standard_normal((50, 3)).astype(np.float32)
    n[0] = (1.0, 0.0, 0.0)  # diffuse exactly at the max(., 0) bound
    np.testing.assert_allclose(ras.shade(torch.from_numpy(n), cfg).numpy(),
                               np.asarray(jras.shade(jnp.asarray(n), jcfg)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("soft", [False, True])
def test_one_shot_tile_matches_reference(name, soft):
    """`_raster_tile` via raster_rows(backend="oneshot") against JAX's
    backend="xla" at 64x36 ss 2: the same formulas over the same pairs;
    1e-5 (the vertex stage's rounding moves the soft image by ~1e-6)."""
    jp, jc, jcfg, tp, tc, cfg = _pair(name, 64, 36, 2)
    want = np.asarray(jras.rasterize(jp, jc, jcfg, soft=soft, backend="xla"))
    got = ras.rasterize(tp, tc, cfg, soft=soft, backend="oneshot").numpy()
    if soft:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:  # a z tie or an edge sample may pick the other triangle
        bad = np.any(np.abs(got - want) > 1e-5, axis=-1)
        assert bad.mean() <= 0.002, bad.mean()


@pytest.mark.parametrize("name", list(SCENES))
def test_pack_raster_tris_matches_reference(name):
    """The table and the chunk boxes to the vertex stage's rounding (1e-4
    relative); the Z-curve order exactly on identical inputs."""
    jp, jc, jcfg, tp, tc, cfg = _pair(name, 64, 36, 2)
    jcols, jbox = (np.asarray(x) for x in jrk.pack_raster_tris(jp, jc, jcfg))
    cols, cbox = rk.pack_raster_tris(tp, tc, cfg)
    assert cols.shape == jcols.shape and cbox.shape == jbox.shape
    np.testing.assert_allclose(cols.numpy(), jcols, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cbox.numpy(), jbox, rtol=1e-4, atol=1e-4)
    assert (cols[:, 12] > 0.5).sum() == (jcols[:, 12] > 0.5).sum()

    # the ordering function on identical inputs: random centres with ties
    rs = np.random.default_rng(11)
    cx = rs.uniform(-5.0, 130.0, 300).astype(np.float32)
    cy = rs.choice(rs.uniform(0.0, 72.0, 40), 300).astype(np.float32)
    cx[:30] = cx[30:60]  # exact duplicates: the stable tie order
    cy[:30] = cy[30:60]
    keep = rs.random(300) > 0.2
    want = np.asarray(jrk._morton2_order(jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(keep)))
    got = rk._morton2_order(torch.from_numpy(cx), torch.from_numpy(cy), torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_kernel_matches_reference_kernel_interpret():
    """The plain version of the hard kernel against JAX `rasterize_fused`
    in interpret mode, 128x16 ss 1 (the tier-1 smoke size): the same
    winners up to the vertex stage's rounding — colours within 1e-5 on all
    but 1 % of the pixels (an edge sample or a z tie)."""
    jp, jc, jcfg, tp, tc, cfg = _pair("cube", 128, 16, 1)
    want = np.asarray(jrk.rasterize_fused(jp, jc, jcfg, interpret=True))
    before = rk.launches
    got = ras.rasterize(tp, tc, cfg).numpy()
    assert rk.launches == before  # the CPU runs the plain version
    assert got.shape == want.shape == (16, 128, 3)
    bad = np.any(np.abs(got - want) > 1e-5, axis=-1)
    assert bad.mean() <= 0.01, bad.mean()
    clear = np.asarray(cfg.clear_color, np.float32)
    assert 0.01 < np.mean(np.any(np.abs(got - clear) > 1e-3, axis=-1)) < 0.9


@pytest.mark.parametrize("W,H,ss,y0,rows,stride", [
    (37, 23, 2, 0, 23, 1),    # ragged: no 128-lane width, no 8-row height
    (50, 30, 1, 3, 9, 3),     # a strided window: rows 3, 6, ..., 27
    (64, 36, 3, 1, 5, 7),     # ss 3, stride past the tile height
])
def test_plain_kernel_matches_one_shot_at_shapes_the_tpu_kernel_refuses(W, H, ss, y0, rows,
                                                                        stride):
    """Sizes, windows and strides the TPU kernel refuses (`rasterizer.py:
    214-220`) against JAX's one-shot path: <= 1 % of pixels off by a z tie
    or an edge sample (the kernel ties by Morton order, the one-shot path by
    mesh order), the rest within 1e-5."""
    jp, jc, jcfg, tp, tc, cfg = _pair("demo", W, H, ss)
    want = np.asarray(jras.raster_rows(jp, jc, jcfg, float(y0), rows, stride=stride,
                                       backend="xla"))
    got = ras.raster_rows(tp, tc, cfg, float(y0), rows, stride=stride).numpy()
    assert got.shape == want.shape == (rows, W, 3)
    bad = np.any(np.abs(got - want) > 1e-5, axis=-1)
    assert bad.mean() <= 0.01, bad.mean()
    # the window's rows are the full frame's rows
    full = ras.rasterize(tp, tc, cfg).numpy()
    idx = [y0 + stride * i for i in range(rows) if y0 + stride * i < H]
    np.testing.assert_array_equal(got[:len(idx)], full[idx])


def test_renders_demo_raster_golden():
    """scripts/make_goldens.py `render_raster`: demo scene (16, 8) at 64x36
    ss 2, within tests/test_goldens.py's bound."""
    torch.set_num_threads(1)
    pkt = demo.reference_demo_scene(16, 8).build_packet(spheres_as_triangles=True)
    img = ras.rasterize(pkt, cam_ops.Camera.create(width=64, height=36),
                        RasterConfig(width=64, height=36, supersample=2))
    _assert_golden_bound(img.numpy(), read_ppm(GOLDEN) / 255.0, "demo_raster")
    want = read_ppm(GOLDEN).astype(np.int16)
    assert np.abs(_to_uint8(img.numpy()).astype(np.int16) - want).max() <= 1


def test_rasterize_frames_equals_per_frame_loop():
    torch.set_num_threads(1)
    W, H = 40, 24
    cfg = RasterConfig(width=W, height=H, supersample=2)
    pkt = demo.reference_demo_scene(8, 4).build_packet(spheres_as_triangles=True)
    cam = cam_ops.Camera.create(width=W, height=H)
    rs = np.random.default_rng(4)
    frames = pkt.transforms[None].repeat(3, 1, 1, 1).clone()
    frames[:, :, 3, :3] += torch.from_numpy(rs.uniform(-0.3, 0.3, (3, frames.shape[1], 3))
                                            .astype(np.float32))
    got = ras.rasterize_frames(pkt, cam, frames, cfg)
    assert got.shape == (3, H, W, 3)
    for k in range(3):
        want = ras.rasterize(dataclasses.replace(pkt, transforms=frames[k]), cam, cfg)
        assert torch.equal(got[k], want)
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("cull", [True, False])
def test_backface_culling_matches_reference(cull):
    """Inside-out spheres: with culling off the back faces show (and the
    image changes); both settings against JAX's one-shot path."""
    jp, jc, jcfg, tp, tc, cfg = _pair("demo", 48, 32, 2, cull_backfaces=cull)
    want = np.asarray(jras.rasterize(jp, jc, jcfg, backend="xla"))
    got = ras.rasterize(tp, tc, cfg).numpy()
    bad = np.any(np.abs(got - want) > 1e-5, axis=-1)
    assert bad.mean() <= 0.01, bad.mean()
    other = ras.rasterize(tp, tc, dataclasses.replace(cfg, cull_backfaces=not cull)).numpy()
    assert np.abs(other - got).max() > 0.01


@pytest.mark.parametrize("soft", [False, True])
def test_empty_scene_is_clear_colour(soft):
    torch.set_num_threads(1)
    cfg = RasterConfig(width=20, height=12, supersample=2)
    pkt = Scene().build_packet(spheres_as_triangles=True)
    img = ras.rasterize(pkt, cam_ops.Camera.create(width=20, height=12), cfg, soft=soft)
    clear = torch.tensor(cfg.clear_color, dtype=torch.float32)
    assert torch.equal(img, clear.expand(12, 20, 3))


def test_unknown_backend_and_bad_row_chunk_raise():
    _, _, _, tp, tc, cfg = _pair("cube", 16, 8, 1)
    with pytest.raises(ConfigError, match="backend"):
        ras.rasterize(tp, tc, cfg, backend="pallas")
    with pytest.raises(ConfigError, match="row_chunk"):
        ras.rasterize(tp, tc, cfg, row_chunk=3, backend="oneshot")
    chunked = ras.rasterize(tp, tc, cfg, row_chunk=4, backend="oneshot")
    assert torch.equal(chunked, ras.rasterize(tp, tc, cfg, backend="oneshot"))


def test_visited_pairs_and_windows_cover_every_hit():
    """The plain version's per-chunk windows hold every sample the kernel's
    block gate lets through that a row covers: rasterizing with all of a
    chunk's samples gives the same image; and the block gate count is
    between the live chunks and blocks x live chunks."""
    _, _, _, tp, tc, cfg = _pair("demo", 64, 36, 2)
    tris, cbox = rk.pack_raster_tris(tp, tc, cfg)
    live = int((cbox[:, 4] > 0.5).sum())
    n = rk.visited_pairs(cbox, 72, 128, 2)
    assert live <= n <= live * (72 // 16 + 1) * (128 // 16)
    scal = rk.raster_scalars(cfg)
    got = rk.raster_reference(tris, cbox, scal, 72, 128, 2)
    wide = cbox.clone()
    wide[:, 0:4] = torch.tensor([-1e9, 1e9, -1e9, 1e9])
    wide[:, 4] = 1.0
    assert torch.equal(got, rk.raster_reference(tris, wide, scal, 72, 128, 2))
