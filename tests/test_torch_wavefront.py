"""The port's wavefront path (`ops/cuda/wavefront.py`) vs the JAX package's.

Glue functions get the same numpy-seeded inputs on both sides and must
match EXACTLY: Morton order (a stable sort of the exact codes), tile boxes,
coherence keys, shortlists, tile order, screen boxes and the screen block
mask. One stated exception: XLA's CPU dot rounds a (T, 3) @ (3, 3) product
in another order than torch's matmul (measured: ~4 % of the elements an
ulp apart), so `leaf_screen_boxes` is exact for cameras whose view matrix
is axis-aligned (every dot has one non-zero term) and within float rounding
for a generic camera.

The plain versions of the two kernels are held against JAX's `_mask_call`
and `_wave_call` in interpret mode, with 128-ray blocks and the same state,
shortlists and uniforms: the verdicts must be equal, the next state within
1e-6 but where float32 conditioning on the r = 10 ground sphere says why not
(`_assert_state_close`). The whole plain `trace` is held against JAX's `wavefront.trace`
(interpret mode, once) within 1e-6 — JAX's own contract against its
megakernel — and against the staged `integrator.trace` with the same draws;
and it must be bit-identical across its own modes (cull, screen binning,
sort, block size). Record mode (`trace(record=True)`) must leave the colour
bit-identical, give JAX's recorded winners exactly (through
`interop.selections_from_jax`; a selection is an integer, and ties go to the
lowest Morton row on both sides) and the same selections in every mode.
Interpret-mode calls cost seconds each here, so there are six.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.models import mesh as mg
from ptre_tpu.models.scene import Model as JModel, Scene as JScene
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import integrator as jint
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.ops.pallas import wavefront as jwf
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu.utils.config import RenderConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models import mesh as pmg
from ptre_tpu_torch.models.scene import Model, Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils import interop


def t(x):
    return torch.from_numpy(np.array(x))


def _tris(rs, T, n_invalid=5, n_dup=6):
    """(v0, v1, v2, valid) with duplicated triangles (equal Morton codes)."""
    v = rs.normal(size=(3, T, 3)).astype(np.float32) * 2.0
    v[:, 1:1 + n_dup] = v[:, :1]  # ties
    valid = np.ones(T, bool)
    valid[rs.choice(T, n_invalid, replace=False)] = False
    return v[0], v[1], v[2], valid


@pytest.mark.parametrize("T,seed", [(200, 0), (64, 1), (1000, 2)])
def test_morton_order_matches_jax(T, seed):
    v0, v1, v2, valid = _tris(np.random.default_rng(seed), T)
    want = np.asarray(jmk.morton_order(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                                       jnp.asarray(valid)))
    got = mk.morton_order(t(v0), t(v1), t(v2), t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not valid[got.numpy()[-5:]].any()  # invalid rows last


@pytest.mark.parametrize("T", [130, 64, 1])
def test_pack_tile_boxes_and_empty_boxes_match_jax(T):
    v0, v1, v2, valid = _tris(np.random.default_rng(T), T, n_invalid=min(5, T), n_dup=0)
    want = np.asarray(jmk.pack_tile_boxes(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                                          jnp.asarray(valid), 64))
    got = mk.pack_tile_boxes(t(v0), t(v1), t(v2), t(valid), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mk.empty_boxes(3).numpy(), np.asarray(jmk._empty_boxes(3)))


def _state(rs, R, dead_every=5):
    """A (12, R) JAX-layout state: o d rgb active id pad."""
    o = rs.normal(size=(3, R)).astype(np.float32) * 3.0
    d = rs.normal(size=(3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, :6] = [[1, -1, 0, 0, 0, 0], [0, 0, 1, -1, 0, 0], [0, 0, 0, 0, 1, -1]]
    act = (np.arange(R) % dead_every != 0).astype(np.float32)
    rgb = rs.uniform(0, 1, (3, R)).astype(np.float32)
    return np.concatenate([o, d, rgb, act[None], np.arange(R, dtype=np.float32)[None],
                           np.zeros((1, R), np.float32)])


def test_coherence_key_matches_jax():
    state = _state(np.random.default_rng(3), 500)
    lo = np.array([-2.0, -1.5, -3.0], np.float32)
    hi = np.array([2.5, 1.0, 3.0], np.float32)
    want = np.asarray(jwf._coherence_key(jnp.asarray(state), jnp.asarray(lo),
                                         jnp.asarray(hi)))
    got = wf.coherence_key(t(state[:10]), t(lo), t(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[state[9] < 0.5] == 0x40000000).all()


def test_shortlists_from_mask_match_jax():
    rs = np.random.default_rng(4)
    mask = rs.random((9, 37)) < 0.3
    mask[0] = False  # an empty row
    mask[1] = True  # a full row
    js, jc = jwf._shortlists_from_mask(jnp.asarray(mask), 37)
    short, cnt = wf.shortlists_from_mask(t(mask))
    assert short.dtype == cnt.dtype == torch.int32
    js, jc = np.asarray(js)[:, 0], np.asarray(jc)[:, 0, 0]
    np.testing.assert_array_equal(short.numpy(), js[:, :37])
    np.testing.assert_array_equal(-(-cnt.numpy() // 4) * 4, jc)  # JAX pads to groups of 4
    assert cnt[0] == 0 and cnt[1] == 37


@pytest.mark.parametrize("H,W,rows,cols", [(16, 64, 8, 32), (24, 16, 8, 8), (10, 64, 8, 32),
                                           (16, 48, 8, 32)])
def test_tile_order_matches_jax(H, W, rows, cols):
    want = jwf.tile_order(H, W, rows, cols)
    got = wf.tile_order(H, W, rows, cols)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CAMERAS = {  # name: (camera kwargs, exact)
    "perspective_axis_aligned": (dict(position=(0.0, 0.5, -3.0), forward=(0.0, 0.0, 3.0)), True),
    "orthographic_axis_aligned": (dict(position=(0.0, 0.5, -3.0), forward=(0.0, 0.0, 3.0),
                                       projection=cam_ops.ORTHOGRAPHIC), True),
    "perspective_default": ({}, False),
    "orthographic_default": (dict(projection=cam_ops.ORTHOGRAPHIC), False),
}


@pytest.mark.parametrize("name", list(CAMERAS))
def test_leaf_screen_boxes_and_block_mask_match_jax(name):
    cam_kw, exact = CAMERAS[name]
    W, H = 64, 48
    v0, v1, v2, valid = _tris(np.random.default_rng(6), 300, n_dup=0)
    v0[7] = [0.2, 0.4, -3.5]  # behind the eye: crosses the near plane
    n_leaf = 6
    jc = jcam.Camera.create(width=W, height=H, **cam_kw)
    tc = cam_ops.Camera.create(width=W, height=H, **cam_kw)
    want = np.asarray(jwf._leaf_screen_boxes(jnp.asarray(v0), jnp.asarray(v1),
                                             jnp.asarray(v2), jnp.asarray(valid), jc, 64,
                                             n_leaf))
    got = wf.leaf_screen_boxes(t(v0), t(v1), t(v2), t(valid), tc, 64, n_leaf).numpy()
    assert np.abs(want).max() >= np.float32(3e38)  # the near-plane triangle's leaf
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # the block mask from the same boxes, in the port's tile shape
    for rows, cols in ((8, 32), (8, 8)):
        jm = np.asarray(jwf._screen_block_mask(jnp.asarray(want), H, W, rows, cols))
        np.testing.assert_array_equal(
            wf.screen_block_mask(t(want), H, W, rows, cols).numpy(), jm)


def _ball(scene_cls, model_cls, diffuse=True):
    """The ball scene of tests/test_wavefront.py:29-47 (tri_pad 64), its
    meshes made by the scene's own package."""
    meshes = pmg if scene_cls is Scene else mg
    scn = scene_cls()
    scn.add_mesh("ball", meshes.uv_sphere(False, 12, 6,
                                          mesh_type=meshes.MeshType.TRIANGLES))
    scn.add_mesh("ground", meshes.uv_sphere(False, 8, 4))
    scn.add_model("b", model_cls("ball"))
    scn.get_model("b").set_transforms(1.0, 0.0, (0.0, 0.5, 0.0))
    if diffuse:
        scn.get_model("b").set_material(0)
    scn.add_model("g", model_cls("ground"))
    scn.get_model("g").set_transforms(10.0, 0.0, (0.0, -10.0, 0.0))
    return scn.build_packet(tri_pad=64)


def _rays(W, H, key):
    cam = jcam.Camera.create(width=W, height=H)
    px, py = jpt.pixel_grid(H, W)
    jit = jrng.pixel_jitter(key, (px.shape[0],))
    o, d = jcam.get_rays(cam, px, py, jit)
    return cam, o, d


def test_prepare_scene_matches_jax():
    torch.set_num_threads(1)
    cfg = RenderConfig(width=8, height=8)
    jp, tp = _ball(JScene, JModel), _ball(Scene, Model)
    jprep = jwf._prepare_scene(jp, cfg, 64)
    got = wf.prepare_scene(tp)
    assert got.n_leaf == 2 and jprep.n_leaf == 128  # JAX pads to 128 boxes
    np.testing.assert_array_equal(got.perm_tri.numpy(), np.asarray(jprep.perm_tri))
    np.testing.assert_allclose(got.tris.numpy(), np.asarray(jprep.tris)[:128], atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(jprep.boxT8).T[:2], atol=1e-6)
    np.testing.assert_array_equal(got.sphs.numpy(), np.asarray(jprep.sphs)[:got.n_sph])
    np.testing.assert_allclose(got.scene_lo.numpy(), np.asarray(jprep.scene_lo), atol=1e-6)
    np.testing.assert_allclose(got.scene_hi.numpy(), np.asarray(jprep.scene_hi), atol=1e-6)


def _scene_from_jax(jp, cfg):
    """The port's WaveScene holding exactly the JAX package's packed arrays."""
    prep = jwf._prepare_scene(jp, cfg, 64)
    T = jp.tri_valid.shape[0]
    n_leaf = -(-T // 64)
    boxes = t(np.asarray(prep.boxT8).T[:n_leaf])
    super_boxes = mk.pack_super_boxes(boxes)
    cull_boxes = torch.cat([boxes, mk.empty_boxes(super_boxes.shape[0] * 8 - n_leaf)])
    sky = np.concatenate([np.asarray(jp.sky_bottom), np.asarray(jp.sky_top),
                          np.zeros(2, np.float32)])
    mats = np.asarray(jmk.pack_mats(jp.mat_kind, jp.mat_albedo, jp.mat_param))
    scene = wf.WaveScene(
        tris=t(np.asarray(prep.tris)[:n_leaf * 64]), boxes=boxes, tri_rows=T,
        cull_boxes=cull_boxes, super_boxes=super_boxes,
        sphs=t(np.asarray(prep.sphs)), mats=t(mats), sky=t(sky.astype(np.float32)),
        scene_lo=t(np.asarray(prep.scene_lo)), scene_hi=t(np.asarray(prep.scene_hi)),
        n_leaf=n_leaf, n_sph=np.asarray(prep.sphs).shape[0], num_mats=jp.num_materials)
    return prep, scene, mats, sky


def _double(scene):
    return dataclasses.replace(scene, **{f: getattr(scene, f).double() for f in (
        "tris", "boxes", "sphs", "mats", "sky", "scene_lo", "scene_hi")})


def _assert_state_close(got, want, exact, what):
    """Next states within 1e-6 except where float32 is too coarse: a ray
    that hits the r = 10 ground sphere computes |oc|^2 - r^2 with |oc|^2 ~
    120 (an ulp of 7.6e-6), so its hit point moves by up to ~2e-5 under any
    other rounding (XLA contracts FMAs on the CPU). Measured on config 4,
    16x16: 1.6 % of the values differ by more than 1e-6, at most 4.2e-5, and
    the plain version is then 1.9e-5 from a float64 evaluation of the same
    inputs, JAX's kernel 2.2e-5. Hence: >= 97 % within 1e-6, all within
    1e-4, and no further from float64 than JAX's kernel is (x 1.5)."""
    err = np.abs(got - want)
    assert (err <= 1e-6).mean() >= 0.97, (what, (err <= 1e-6).mean())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=what)
    assert np.abs(got - exact).max() <= 1.5 * np.abs(want - exact).max() + 1e-7, what


def test_plain_kernels_match_jax_interpret_mode():
    """One bounce of the mask and the bounce kernel, twice, on config 4 at
    test scale: on primary rays in a shuffled order with dead rays, then on
    the next state sorted by the coherence key."""
    torch.set_num_threads(1)
    W = H = 16
    lanes, R, B = 128, 256, 5
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    k = mk.TraceConsts.from_config(cfg)
    jp = jdemo.config4_mixed_scene(24, 12).build_packet()  # 9 leaves
    prep, scene, mats, sky = _scene_from_jax(jp, cfg)
    key = jrng.key_for(8)
    _, o, d = _rays(W, H, key)
    ur = np.asarray(jmk._build_urand(key, R, B))
    urand = t(np.concatenate([np.zeros((2, R), np.float32), ur]))
    rs = np.random.default_rng(9)
    state = np.concatenate([np.asarray(o).T, np.asarray(d).T, rs.uniform(0.2, 1, (3, R)),
                            (np.arange(R) % 7 != 0)[None], np.arange(R)[None],
                            np.zeros((1, R))]).astype(np.float32)
    state = state[:, rs.permutation(R)]  # row 10: the original ids
    for b in (0, 1):
        ids = state[10].astype(np.int32)
        stateT = jnp.pad(jnp.asarray(state).T, ((0, 0), (0, 4)))
        verd = jwf._mask_call(prep.scalars, stateT, prep.boxT8, lanes=lanes, interpret=True)
        mask = wf.wave_mask_reference(t(state[:10]), scene.boxes, k.t_min, lanes)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(verd)[:, 0, :scene.n_leaf] > 0.5)
        assert mask.any() and not mask.all()
        jshort, jcnt = jwf._shortlists(verd, prep.n_leaf)
        short, cnt = wf.shortlists_from_mask(mask)
        np.testing.assert_array_equal(-(-cnt.numpy() // 4) * 4, np.asarray(jcnt)[:, 0, 0])
        out = jwf._wave_call(prep.scalars, jnp.asarray(sky), jcnt, jshort, jnp.asarray(state),
                             jnp.asarray(ur[2 * b:2 * b + 2][:, ids]), prep.tris, prep.sphs,
                             jnp.asarray(mats), sph_tile=prep.sph_tile, lanes=lanes,
                             num_mats=jp.num_materials, record_sel=False, interpret=True,
                             leaf=64)
        want = np.asarray(out)[:10]
        got = wf.wave_bounce_reference(t(state[:10]), t(ids), short, cnt, scene, k, b,
                                       urand=urand, lanes=lanes).numpy()
        exact = wf.wave_bounce_reference(t(state[:10]).double(), t(ids), short, cnt,
                                         _double(scene), k, b, urand=urand.double(),
                                         lanes=lanes).numpy()
        _assert_state_close(got, want, exact, f"bounce {b}")
        dead = state[9] < 0.5
        np.testing.assert_array_equal(got[:, dead], state[:10, dead])
        assert (got[9] > 0.5).sum() > 20  # live rays remain for bounce 1
        # the next state, sorted as `trace` sorts it
        state = np.concatenate([want, state[10:]])
        order = np.argsort(np.asarray(jwf._coherence_key(jnp.asarray(state), prep.scene_lo,
                                                         prep.scene_hi)), kind="stable")
        state = state[:, order]


def test_trace_matches_jax_wavefront_and_staged_route():
    torch.set_num_threads(1)
    W = H = 8
    cfg = RenderConfig(width=W, height=H)
    jp, tp = _ball(JScene, JModel), _ball(Scene, Model)
    key = jrng.key_for(3)
    cam, o, d = _rays(W, H, key)
    R = W * H
    ur = np.asarray(jmk._build_urand(key, R, cfg.max_depth))
    urand = t(np.concatenate([np.zeros((2, R), np.float32), ur]))
    scene = wf.prepare_scene(tp, screen_cam=cam_ops.Camera.create(width=W, height=H))
    got = wf.trace(t(o), t(d), scene, mk.TraceConsts.from_config(cfg), cfg.max_depth,
                   urand=urand, tile_hint=(H, W)).numpy()
    want = np.asarray(jwf.trace(key, o, d, jp, cfg, interpret=True, tile_hint=(H, W),
                                screen_cam=cam))
    assert np.isfinite(got).all() and got.max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    staged = np.asarray(jint.trace(key, o, d, jp, cfg))
    np.testing.assert_allclose(got, staged, rtol=0, atol=2e-6)


def test_trace_record_matches_jax_selections():
    """`trace(record=True)`: the colour of `record=False` bit for bit, the
    Morton permutation and every bounce's winner as JAX's wavefront records
    them (interpret mode), and -1 exactly where JAX's hit row is 0."""
    torch.set_num_threads(1)
    W = H = 8
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    jp, tp = _ball(JScene, JModel, diffuse=True), _ball(Scene, Model, diffuse=True)
    key = jrng.key_for(5)
    cam, o, d = _rays(W, H, key)
    R = W * H
    jcol, jsel, jur, jperm = jwf.trace(key, o, d, jp, cfg, record=True, interpret=True,
                                       tile_hint=(H, W), screen_cam=cam)
    urand = t(np.concatenate([np.zeros((2, R), np.float32), np.asarray(jur)]))
    scene = wf.prepare_scene(tp, screen_cam=cam_ops.Camera.create(width=W, height=H))
    k = mk.TraceConsts.from_config(cfg)
    args = (t(o), t(d), scene, k, cfg.max_depth)
    color, sel, perm = wf.trace(*args, urand=urand, tile_hint=(H, W), record=True)
    plain = wf.trace(*args, urand=urand, tile_hint=(H, W))
    assert torch.equal(color, plain)
    np.testing.assert_allclose(color.numpy(), np.asarray(jcol), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert sel.shape == (cfg.max_depth, R) and sel.dtype == torch.int32
    want = interop.selections_from_jax(jsel, scene.tri_rows)
    np.testing.assert_array_equal(sel.numpy(), want.numpy())
    hits = sel >= 0
    assert bool(hits[0].any()) and bool(hits[2].any()) and not bool(hits.all())
    assert bool((sel[hits] < scene.tri_rows + scene.n_sph).all())
    assert bool((sel >= scene.tri_rows).any()) and bool(((sel >= 0) & (sel < scene.tri_rows)).any())


def _mode_image(tp, W, H, cfg, screen=True, tile_hint=True, **kw):
    cam = cam_ops.Camera.create(width=W, height=H)
    scene = wf.prepare_scene(tp, screen_cam=cam if screen else None)
    px, py = pt.pixel_grid(H, W)
    jit = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, (H * W, 2))
                           .astype(np.float32))
    o, d = cam_ops.get_rays(cam, px, py, jit)
    return wf.trace(o, d, scene, mk.TraceConsts.from_config(cfg), cfg.max_depth, seed=77,
                    sample=3, tile_hint=(H, W) if tile_hint else None, **kw)


MODES = {
    "no_cull": dict(cull=False),
    "no_screen_binning": dict(screen=False),
    "no_tile_hint": dict(tile_hint=False),
    "always_sort": dict(sort_min_live=0.0),
    "never_sort": dict(sort_min_live=None),
    "lanes_128": dict(lanes=128),
    "lanes_256": dict(lanes=256),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_trace_bit_identical_across_modes(mode):
    """Culling, binning, the sort (always, never, or skipped below 12.5 %
    live) and the block size only save time: every pixel is bit-identical
    (Philox draws)."""
    torch.set_num_threads(1)
    W, H = 32, 16
    cfg = RenderConfig(width=W, height=H, max_depth=5)
    tp = demo.config4_mixed_scene(12, 6).build_packet()
    assert wf.supports(tp) and not mk.dense_supported(tp)
    ref = _mode_image(tp, W, H, cfg, lanes=64)
    got = _mode_image(tp, W, H, cfg, **{"lanes": 64, **MODES[mode]})
    assert torch.isfinite(ref).all() and float(ref.max()) > 0.05
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("mode", list(MODES))
def test_trace_record_invariant_across_modes(mode):
    """The recorded selections do not depend on the culling, the binning,
    the sort or the block size either, and recording changes no pixel."""
    torch.set_num_threads(1)
    W, H = 32, 16
    cfg = RenderConfig(width=W, height=H, max_depth=4)
    tp = demo.config4_mixed_scene(12, 6).build_packet()
    ref = _mode_image(tp, W, H, cfg, lanes=64)
    color, sel, perm = _mode_image(tp, W, H, cfg, **{"lanes": 64, **MODES[mode]}, record=True)
    base = _mode_image(tp, W, H, cfg, lanes=64, record=True)
    assert torch.equal(color, ref)
    assert torch.equal(sel, base[1]) and torch.equal(perm, base[2])
    assert int((sel[-1] >= 0).sum()) > 0 and int((sel == -1).sum()) > 0


def test_empty_and_sphere_only_scenes():
    """As tests/test_wavefront.py:111-136, against the port's dense plain
    bounce loop on the same draws: the empty scene is pure sky, bit for bit;
    the sphere-only scene differs by the dense loop's renormalised sphere
    normal (~1e-6, see csrc/wave.cuh)."""
    torch.set_num_threads(1)
    W = H = 8
    cfg = RenderConfig(width=W, height=H)
    k = mk.TraceConsts.from_config(cfg)
    cam = cam_ops.Camera.create(width=W, height=H)
    jit = torch.from_numpy(np.random.default_rng(5).uniform(-0.5, 0.5, (W * H, 2))
                           .astype(np.float32))
    px, py = pt.pixel_grid(H, W)
    o, d = cam_ops.get_rays(cam, px, py, jit)
    sphere_only = Scene()
    sphere_only.add_mesh("s", pmg.uv_sphere(False, 8, 4))
    sphere_only.add_model("m", Model("s"))
    sphere_only.get_model("m").set_transforms(1.0, 0.0, (0.0, 0.5, 4.0))
    for name, scn, atol in (("empty", Scene(), 0.0), ("sphere_only", sphere_only, 3e-5)):
        pkt = scn.build_packet()
        got = wf.trace(o, d, wf.prepare_scene(pkt, screen_cam=cam), k, cfg.max_depth,
                       seed=4, sample=2, tile_hint=(H, W))
        want, _ = mk.trace_record_reference(o, d, mk.pack_scene(pkt), k, cfg.max_depth,
                                            seed=4, sample=2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol,
                                   err_msg=name)
        assert float(got.max()) > 0.3


def test_supports_gates():
    tp = _ball(Scene, Model)
    assert wf.supports(tp) and wf.supports(demo.config3_scene(128, 64).build_packet())
    big = dataclasses.replace(tp, tri_valid=torch.zeros(wf.MAX_WAVE_TRIS + 64, dtype=torch.bool))
    assert not wf.supports(big)
    assert not wf.supports(dataclasses.replace(tp, num_materials=mk.MAX_MATS + 1))
    many_sph = dataclasses.replace(tp, sph_center=torch.zeros((wf.MAX_WAVE_SPHS + 8, 3)))
    assert not wf.supports(many_sph)
