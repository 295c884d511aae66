"""Material tables of any size on the port's fused routes, against the JAX
package.

The reference's kernels select a hit's material with an unrolled scan of at
most 8 rows held in SMEM (`ptre_tpu/ops/pallas/megakernel.py:59`, `:203`), so
JAX routes a packet with more materials to its staged route. The port's
kernels read the row by index (`csrc/trace.cuh` material_row, plain twin
`megakernel.material_rows`) from a table of any size, and its render,
recording, wave and culled kernels take such packets. Here, on the CPU (plain
versions):

* distinct materials: 24-material packets (the demo, every model on its own
  id >= 8; config 4's mesh at 12x6) through the port's default routes fed the
  very draws of JAX's staged route (`test_torch_train.jax_urand`,
  `test_torch_pathtracer.jax_urand`), against JAX's staged `mse_step` and
  `render_step`: `test_torch_train.py`'s bound (loss within 1e-5 relative,
  gradients rtol 2e-3 with atol 1e-4 of each leaf's largest entry) and
  `test_torch_pathtracer.py`'s staged-vs-fused image bound (atol = rtol =
  2e-3, >= 95 % of pixels within 1e-4);
* decoy remap: scene A (k = 8 materials, which JAX's fused kernels take) and
  scene B, the same geometry with 24 materials whose rows 0-15 are decoys
  (emissive, bright, odd albedo) and A's rows at 16-23, every model on its
  remapped id. JAX's fused kernels in interpret mode on A against the port's
  plain dense and wavefront routes on B under the same uniforms, at the
  bounds of `test_torch_render_kernel.py` (2e-5, at its 128x8), of
  `test_torch_replay.py` (recording: selections equal, colour 2e-5) and of
  `test_torch_wavefront.py` on config 4 (colour >= 97 % within 1e-6, all
  within 1e-4: the r = 10 ground sphere's conditioning; the permutation and
  selections equal), and the port's wavefront on B bit for bit its own on
  A; the port's training step on B against its own on A (same draws): loss
  equal, gradients within 1e-6 relative, material rows 16-23 of B equal to
  rows 0-7 of A and the decoy rows exactly zero; a select shifted by 8 rows
  lands on a decoy and changes the image;
* the select: on tables of 9, 40 and 300 distinct rows, the plain select and
  shading equal, bit for bit, the reference's scan (kept below as the
  oracle) on ids over the whole table and on adversarial ids (ties at k +
  0.5, -0.4, -0.6, M - 0.5, M, 2**24 - 1, NaN), and on valid ids match JAX's
  `materials.scatter` on the gathered rows with the same draws within
  rtol = atol = 2e-5, `test_torch_render_kernel.py`'s bound for the plain
  dense shading against JAX's kernel.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.models import scene as jscene
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import materials as jmat
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.ops.pallas import render_kernel as jrk
from ptre_tpu.ops.pallas import wavefront as jwf
from ptre_tpu.parallel import sharding as jsh
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu.render import train as jtrain
from ptre_tpu.utils.config import RenderConfig as JConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models import scene as tscene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator, rng
from ptre_tpu_torch.ops.cuda import fused_grad
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils import interop
from ptre_tpu_torch.utils.config import RenderConfig

W, H = 16, 8
R = W * H
#: bounces: the demo as test_torch_train.py, config 4 as its triangle cases
DEPTH = {"demo": 5, "config4": 3}
SCENES = {"demo": ("reference_demo_scene", (8, 4)), "config4": ("config4_mixed_scene", (12, 6))}

# ---- scenes -------------------------------------------------------------------------

#: scene A's materials past the two defaults (ids 2-7): (emissive, albedo, param)
A_EXTRA = ((False, (0.8, 0.35, 0.2), 0.6), (True, (1.0, 0.85, 0.6), 3.0),
           (False, (0.2, 0.6, 0.9), 0.2), (False, (0.9, 0.9, 0.3), 1.0),
           (True, (0.5, 0.7, 1.0), 6.0), (False, (0.4, 0.45, 0.5), 0.0))
#: scene A's model -> material id
A_MODELS = {"demo": {"ground": 2, "sph": 4, "wall": 3},
            "config4": {"b": 5, "c": 6, "s": 4, "g": 7}}
#: scene B: A's row m at DECOY_ROWS + m, rows 0 to DECOY_ROWS - 1 decoys
DECOY_ROWS = 16


def _material(mod, emissive, albedo, param):
    kind = mod.MaterialKind.EMISSIVE if emissive else mod.MaterialKind.OREN_NAYAR
    return mod.Material(kind, albedo, param)


def _decoy(i):
    """Decoy row i: emissive or Oren-Nayar in turn, bright, odd albedo."""
    return i % 2 == 0, (3.0 + i, 0.01, 7.0 - 0.25 * i), 25.0 + i


def _build(mod, dm, kind, device):
    fn, args = SCENES[kind]
    return getattr(dm, fn)(*args), ({"device": device} if mod is tscene else {})


def scene_a(mod, dm, kind, device="cpu"):
    """Packet of scene A (8 materials) in either package."""
    scn, kw = _build(mod, dm, kind, device)
    for m in A_EXTRA:
        scn.add_material(_material(mod, *m))
    for model, mid in A_MODELS[kind].items():
        scn.set_model_material(model, mid)
    return scn.build_packet(**kw)


def scene_b(kind, device="cpu"):
    """Packet of scene B in the port: decoys at rows 2-15 (the scene's two
    defaults, rows 0 and 1, which no model of B uses, replaced by decoys in
    the packet), A's 8 rows at 16-23, every model on its remapped id."""
    scn, kw = _build(tscene, demo, kind, device)
    for i in range(2, DECOY_ROWS):
        scn.add_material(_material(tscene, *_decoy(i)))
    defaults = (tscene.DEFAULT_OREN_NAYAR, tscene.DEFAULT_EMISSIVE)
    for m in defaults + tuple(_material(tscene, *m) for m in A_EXTRA):
        scn.add_material(m)
    for model, mid in A_MODELS[kind].items():
        scn.set_model_material(model, DECOY_ROWS + mid)
    pkt = scn.build_packet(**kw)
    first = [_decoy(i) for i in range(2)]
    kind_ = pkt.mat_kind.clone()
    albedo, param = pkt.mat_albedo.clone(), pkt.mat_param.clone()
    for i, (em, alb, par) in enumerate(first):
        kind_[i], albedo[i], param[i] = int(em), torch.tensor(alb), par
    return dataclasses.replace(pkt, mat_kind=kind_, mat_albedo=albedo, mat_param=param)


def distinct_scene(mod, dm, kind):
    """24 distinct materials (seeded), every model on its own id >= 8."""
    scn, kw = _build(mod, dm, kind, "cpu")
    rs = np.random.default_rng(24)
    for i in range(2, 24):
        scn.add_material(_material(mod, i in (13, 21), tuple(
            float(x) for x in rs.uniform(0.1, 0.95, 3).astype(np.float32)),
            float(np.float32(rs.uniform(0.0, 1.2)))))
    ids = {"demo": {"ground": 9, "sph": 14, "wall": 21},
           "config4": {"b": 8, "c": 13, "s": 17, "g": 23}}[kind]
    for model, mid in ids.items():
        scn.set_model_material(model, mid)
    return scn.build_packet(**kw)


def test_scenes_and_routes():
    """A has 8 materials, B 24 with A's at 16-23; both take the port's fused
    routes, B only where the reference would take its staged route; a
    packet past 2**24 materials keeps the staged route."""
    for kind in SCENES:
        a, b = scene_a(tscene, demo, kind), scene_b(kind)
        assert a.num_materials == mk.STAGED_MATS and b.num_materials == 24
        for k in ("mat_kind", "mat_albedo", "mat_param"):
            assert torch.equal(getattr(b, k)[DECOY_ROWS:], getattr(a, k))
            assert not torch.equal(getattr(b, k)[:mk.STAGED_MATS], getattr(a, k))
        assert torch.equal(b.tri_mat[b.tri_valid], a.tri_mat[a.tri_valid] + DECOY_ROWS)
        assert torch.equal(b.sph_mat[b.sph_valid], a.sph_mat[a.sph_valid] + DECOY_ROWS)
        want = "dense" if kind == "demo" else "wavefront"
        for pkt in (a, b, distinct_scene(tscene, demo, kind)):
            assert pt.route(pkt) == want
            assert integrator.grad_route(RenderConfig(), pkt) == "fused"
            assert pt.route(pkt, RenderConfig(intersect_backend="pallas")) == "staged"
            assert integrator.grad_route(RenderConfig(grad_sweep="staged"), pkt) == "staged"
        if kind == "demo":
            for m in (9, 300):
                assert pt.route(dataclasses.replace(b, num_materials=m)) == "dense"
        past = dataclasses.replace(b, num_materials=mk.MAX_MATERIALS + 1)
        assert pt.route(past) == "staged"
        assert integrator.grad_route(RenderConfig(), past) == "staged"


def test_wrappers_take_any_table_up_to_float32_ids():
    """The kernels' wrappers check a `pack_mats` table of max(M, 8) rows and
    raise RendererError past 2**24 materials, the only limit (float32 ids)."""
    from ptre_tpu_torch.utils.errors import RendererError

    for m in (0, 3, 8, 9, 300, mk.MAX_MATERIALS):
        name, _, shape, dtype = mk.mats_entry(m, None)
        assert name == "mats" and shape == (max(m, mk.STAGED_MATS), 8)
        assert dtype == torch.float32
    with pytest.raises(RendererError, match="materials"):
        mk.mats_entry(mk.MAX_MATERIALS + 1, None)
    table = mk.pack_mats(torch.tensor([1, 0]), torch.ones((2, 3)), torch.tensor([2.0, 0.5]))
    assert table.shape == (mk.STAGED_MATS, 8) and float(table[2:].abs().max()) == 0.0


# ---- distinct materials: the port's fused routes against JAX's staged route ---------


def _jax_train_urand(key, spp, depth):
    """(spp, 2 + 2*depth, H, W): the draws of JAX's staged `mse_step`
    (`test_torch_train.jax_urand`)."""
    out = []
    for s in range(spp):
        skey = jrng.fold(key, s)
        jit = np.asarray(jrng.pixel_jitter(jrng.fold(skey, 0x9E37), (R,)))
        ur = np.asarray(jmk._build_urand(skey, R, depth))
        out.append(np.concatenate([jit.T + np.float32(0.5), ur]).reshape(-1, H, W))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def _jax_render_urand(key, frame, spp, depth):
    """(spp, 2 + 2*depth, H, W): the draws of JAX's staged `render_step`
    (`test_torch_pathtracer.jax_urand`)."""
    out = []
    for s in range(spp):
        skey = jrng.fold(jrng.fold(key, s), frame + s + 1)
        jit = np.asarray(jrng.pixel_jitter(jrng.fold(skey, 0x9E37), (R,)))
        ur = np.asarray(jmk._build_urand(skey, R, depth))
        out.append(np.concatenate([jit.T + np.float32(0.5), ur]).reshape(-1, H, W))
    return torch.from_numpy(np.stack(out).astype(np.float32))


@pytest.mark.parametrize("kind", list(SCENES))
def test_distinct_materials_mse_step_matches_jax_staged(kind):
    torch.set_num_threads(1)
    jp, pkt = distinct_scene(jscene, jdemo, kind), distinct_scene(tscene, demo, kind)
    assert jp.num_materials == pkt.num_materials == 24
    jc = jcam.Camera.create(width=W, height=H)
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    jcfg = JConfig(width=W, height=H, max_depth=DEPTH[kind], remat_bounces=False)
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH[kind])
    assert integrator.grad_route(cfg, pkt) == "fused"
    key = jrng.key_for(17)
    target = np.random.default_rng(5).uniform(0.0, 0.5, (R, 3)).astype(np.float32)
    jl, jg = jtrain.mse_step(jsh.differentiable_params(jp, jc), jp, jc, jnp.asarray(target),
                             key, jcfg, spp=1)
    loss, grads = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam,
                                 torch.from_numpy(target), cfg, seed=0, spp=1,
                                 urand=_jax_train_urand(key, 1, DEPTH[kind]))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        want = np.asarray(jg[k])
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30), err_msg=k)
    for k in ("mat_albedo", "mat_param"):
        assert float(grads[k][mk.STAGED_MATS:].abs().max()) > 0, k
        assert float(grads[k][:mk.STAGED_MATS].abs().max()) == 0.0, k  # no model uses them


@pytest.mark.parametrize("kind", list(SCENES))
def test_distinct_materials_render_step_matches_jax_staged(kind):
    torch.set_num_threads(1)
    jp, pkt = distinct_scene(jscene, jdemo, kind), distinct_scene(tscene, demo, kind)
    jc = jcam.Camera.create(width=W, height=H)
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH[kind])
    jcfg = JConfig(width=W, height=H, max_depth=DEPTH[kind])
    key, spp = jrng.key_for(29), 2
    want = np.asarray(jpt.render_step(jp, jc, jpt.AccumState.create(H, W), key, jcfg,
                                      spp=spp).linear)
    before = rk.launches, wf.mask_launches, wf.bounce_launches
    got = pt.render_step(pkt, cam, pt.AccumState.create(H, W, device="cpu"), 0, cfg, spp=spp,
                         urand=_jax_render_urand(key, 0, spp, DEPTH[kind])).linear.numpy()
    assert (rk.launches, wf.mask_launches, wf.bounce_launches) == before  # plain versions
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    assert np.all(np.abs(got - want) < 1e-4, axis=-1).mean() > 0.95
    assert float(got.max()) > 0.05


# ---- decoy remap: scene B on the port against scene A ---------------------------------


def _jax_rays(key, w=W, h=H):
    jc = jcam.Camera.create(width=w, height=h)
    px, py = jpt.pixel_grid(h, w)
    o, d = jcam.get_rays(jc, px, py, jrng.pixel_jitter(jrng.fold(key, 0x9E37), (w * h,)))
    return jc, o, d


def test_decoy_dense_render_and_record_match_jax_fused_kernels():
    """JAX's render kernel and recording kernel (interpret mode) on A, the
    port's plain versions on B, the same external uniforms, at 128x8 (the
    JAX render kernel's lane width)."""
    torch.set_num_threads(1)
    W, H = 128, 8
    R = W * H
    cfg = JConfig(width=W, height=H, max_depth=DEPTH["demo"])
    jp = scene_a(jscene, jdemo, "demo")
    assert jmk.dense_supported(jp)
    scene = mk.pack_scene(scene_b("demo"))
    assert scene.num_mats == 24 and tuple(scene.mats.shape) == (24, 8)
    rs = np.random.default_rng(8)
    prev = rs.random((H, W, 3), dtype=np.float32)
    urand = rs.random((2 + 2 * cfg.max_depth, H, W), dtype=np.float32)
    jc = jcam.Camera.create(width=W, height=H)
    want = np.asarray(jrk.sample_accum_fused(
        0, jp, jc, jnp.asarray(prev.transpose(2, 0, 1)), 3.0, cfg, urand=jnp.asarray(urand),
        interpret=True)).transpose(1, 2, 0)
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H, device="cpu"))
    got = rk.sample_accum_reference(torch.from_numpy(prev), scene, rows, 3, cfg,
                                    urand=torch.from_numpy(urand)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    key = jrng.key_for(41)
    _, o, d = _jax_rays(key, W, H)
    jcol, sel_p, ur_p = jmk.trace_fused_sel(key, o, d, jp, cfg, interpret=True, planar="color")
    B = cfg.max_depth
    jsel = np.asarray(sel_p).reshape(4 * B, -1)[:, :R].reshape(B, 4, R)
    ur = np.asarray(ur_p).reshape(2 * B, -1)[:, :R]
    color, sel = mk.trace_record_reference(
        torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)), scene,
        mk.TraceConsts.from_config(cfg), B,
        urand=torch.from_numpy(np.concatenate([np.zeros((2, R), np.float32), ur])))
    hit = jsel[:, 3] > 0.5
    np.testing.assert_array_equal(sel.numpy() >= 0, hit)
    want_sel = interop.selections_from_jax(jsel, scene.tri_rows).numpy()
    np.testing.assert_array_equal(sel.numpy()[hit], want_sel[hit])
    np.testing.assert_allclose(color.numpy(), np.asarray(jcol), rtol=2e-5, atol=2e-5)
    assert float(color.max()) > 1.0  # an emitter of A lit some rays


def test_decoy_wavefront_matches_jax_wavefront():
    """JAX's wavefront (mask and bounce kernels, interpret mode, record mode)
    on A's config-4 mesh, the port's plain wavefront on B: colour within
    1e-6, the Morton permutation and every bounce's winner equal."""
    torch.set_num_threads(1)
    cfg = JConfig(width=W, height=H, max_depth=DEPTH["config4"])
    jp = scene_a(jscene, jdemo, "config4")
    key = jrng.key_for(43)
    jc, o, d = _jax_rays(key)
    jcol, jsel, jur, jperm = jwf.trace(key, o, d, jp, cfg, record=True, interpret=True,
                                       tile_hint=(H, W), screen_cam=jc)
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    scene = wf.prepare_scene(scene_b("config4"), screen_cam=cam)
    assert scene.num_mats == 24 and tuple(scene.mats.shape) == (24, 8)
    urand = torch.from_numpy(np.concatenate([np.zeros((2, R), np.float32), np.asarray(jur)]))
    color, sel, perm = wf.trace(torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)), scene,
                                mk.TraceConsts.from_config(cfg), cfg.max_depth, urand=urand,
                                tile_hint=(H, W), record=True)
    err = np.abs(color.numpy() - np.asarray(jcol))
    assert (err <= 1e-6).mean() >= 0.97 and err.max() <= 1e-4, err.max()
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(sel.numpy(),
                                  interop.selections_from_jax(jsel, scene.tri_rows).numpy())
    assert float(color.max()) > 0.05 and int((sel >= 0).sum()) > 0
    own = wf.trace(torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
                   wf.prepare_scene(scene_a(tscene, demo, "config4"), screen_cam=cam),
                   mk.TraceConsts.from_config(cfg), cfg.max_depth, urand=urand,
                   tile_hint=(H, W), record=True)
    assert torch.equal(own[0], color) and torch.equal(own[1], sel)


@pytest.mark.parametrize("kind", list(SCENES))
def test_decoy_training_step_equals_scene_a(kind):
    """The port's `mse_step` on B (the fused route, plain versions) against
    its own on A with the same draws: the same paths, so the same loss and
    gradients; B's material rows 16-23 carry A's rows 0-7 and the decoys
    none."""
    torch.set_num_threads(1)
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH[kind])
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    target = torch.from_numpy(np.random.default_rng(6).uniform(0.0, 0.5, (R, 3))
                              .astype(np.float32))
    urand = _jax_train_urand(jrng.key_for(47), 1, DEPTH[kind])
    out = {}
    for name, pkt in (("a", scene_a(tscene, demo, kind)), ("b", scene_b(kind))):
        assert integrator.grad_route(cfg, pkt) == "fused"
        before = mk.record_launches, fused_grad.launches, wf.bounce_launches
        out[name] = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg,
                                   seed=0, spp=1, urand=urand)
        assert (mk.record_launches, fused_grad.launches, wf.bounce_launches) == before
    (la, ga), (lb, gb) = out["a"], out["b"]
    assert float(la) == float(lb)
    for k in ga:
        a, b = ga[k], gb[k]
        if k in ("mat_albedo", "mat_param"):
            assert float(b[:DECOY_ROWS].abs().max()) == 0.0, k
            b = b[DECOY_ROWS:]
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6 * max(float(a.abs().max()), 1e-30), err_msg=k)
    assert float(ga["mat_albedo"].abs().max()) > 0 and float(ga["mat_param"].abs().max()) > 0


def test_a_select_shifted_by_eight_rows_hits_a_decoy():
    """Scene B with every model's id lowered by 8 (rows 8-15: decoys): the
    plain dense route's image is far from A's, which B's own equals."""
    torch.set_num_threads(1)
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH["demo"])
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H, device="cpu"))
    urand = torch.from_numpy(np.random.default_rng(9).random((2 + 2 * cfg.max_depth, H, W),
                                                             dtype=np.float32))
    b = scene_b("demo")
    shifted = dataclasses.replace(b, tri_mat=b.tri_mat - 8, sph_mat=b.sph_mat - 8)
    zero = torch.zeros((H, W, 3))
    img = {name: rk.sample_accum_reference(zero, mk.pack_scene(p), rows, 1, cfg, urand=urand)
           for name, p in (("a", scene_a(tscene, demo, "demo")), ("b", b), ("shifted", shifted))}
    assert torch.equal(img["b"], img["a"])
    assert float((img["shifted"] - img["a"]).abs().max()) > 0.25


# ---- the select itself ---------------------------------------------------------------

MAT_COUNTS = (9, 40, 300)


def scan_rows(mat_id, mats, num_mats):
    """The reference's select, as the port's plain version wrote it before
    the 8-row cap was dropped (`megakernel.py:625-631`): every row m <
    num_mats with |id - m| < 0.5, last match wins, else zeros. (N, 5)."""
    zero = torch.zeros_like(mat_id)
    cols = [zero] * 5
    for m in range(num_mats):
        is_m = torch.abs(mat_id - float(m)) < 0.5
        row = mats[m].tolist()
        cols = [torch.where(is_m, row[c], cols[c]) for c in range(5)]
    return torch.stack(cols, dim=-1)


def _ids(M, rs, n=512):
    """Every row's id, ids near each row, adversarial ids and random ones."""
    inside = float(np.nextafter(np.float32(0.5), np.float32(0.0)))
    k = np.arange(M, dtype=np.float32)
    adversarial = [0.5, 1.5, M - 1.5, M - 0.5, float(M), M + 0.5, -0.4, -0.0, -0.5, -0.6,
                   -1.0, 1.0 + inside, 2.0 - inside, M - 1.0 + inside, 2.0 ** 24 - 1.0,
                   2.0 ** 24, float("nan"), float("inf"), float("-inf")]
    near = k + rs.uniform(-0.49, 0.49, M).astype(np.float32)
    wide = rs.uniform(-3.0, M + 3.0, n).astype(np.float32)
    return torch.from_numpy(np.concatenate(
        [k, k + np.float32(0.5), k - np.float32(0.5), near, np.asarray(adversarial, np.float32),
         wide]).astype(np.float32))


def _table(M, rs):
    kind = torch.from_numpy((rs.random(M) < 0.25).astype(np.int32))
    albedo = torch.from_numpy(rs.uniform(0.05, 1.0, (M, 3)).astype(np.float32))
    param = torch.from_numpy(rs.choice(np.array([0.0, 0.3, 0.7, 1.0, 1.6, 4.0], np.float32), M))
    return mk.pack_mats(kind, albedo, param)


def _hits(n, rs):
    """Unit normals, unit directions against them, and positions."""
    nrm = rs.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * nrm, axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    return nrm, d, rs.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("M", MAT_COUNTS)
def test_select_and_shade_equal_the_scan_bit_for_bit(M):
    rs = np.random.default_rng(M)
    mats = _table(M, rs)
    ids = _ids(M, rs)
    n = ids.numel()
    assert mats.shape == (max(M, mk.STAGED_MATS), 8)
    got = mk.material_rows(ids, mats, M)
    want = scan_rows(ids, mats, M)
    assert got.shape == (n, 8) and torch.equal(got[:, :5], want)
    assert float(got[:, 5:].abs().max()) == 0.0
    # every row is chosen, and the ids the scan leaves give zeros
    assert set(mk.material_rows(ids[:M], torch.arange(M, dtype=torch.float32)[:, None].expand(
        M, 8), M)[:, 0].tolist()) == set(range(M))
    assert float(got[M:2 * M].abs().max()) == 0.0  # k + 0.5: a tie, no row
    # the shading: the same function fed the scan's rows (a table of one
    # row a ray, at ids 0..n-1) gives the same bits
    nrm, d, _ = _hits(n, rs)
    u = torch.from_numpy(rs.random((2, n), dtype=np.float32))
    nx, ny, nz = torch.from_numpy(nrm).unbind(1)
    dx, dy, dz = torch.from_numpy(d).unbind(1)
    k = mk.TraceConsts.from_config(RenderConfig())
    by_index = mk.scatter_shade(nx, ny, nz, dx, dy, dz, ids, u[0], u[1], mats, M, k.pdf_eps)
    per_ray = torch.cat([want, torch.zeros((n, 3))], dim=1)
    by_scan = mk.scatter_shade(nx, ny, nz, dx, dy, dz, torch.arange(n, dtype=torch.float32),
                               u[0], u[1], per_ray, n, k.pdf_eps)
    for a, b in zip(by_index, by_scan):
        assert torch.equal(a, b)
    assert bool(by_index[6].any()) and not bool(by_index[6].all())


@pytest.mark.parametrize("M", MAT_COUNTS)
def test_select_and_shade_match_jax_scatter_on_valid_ids(M):
    """On ids inside the table, the port's shading of the indexed row
    against JAX's `materials.scatter` of the gathered kind, albedo and param
    with the same draws (`rng.cosine_uniforms` of the twin key, as
    `test_torch_materials.py` draws them): the factor f = attenuation *
    cos_weight / pdf, the direction and the emissive flag."""
    rs = np.random.default_rng(M + 7)
    mats = _table(M, rs)
    n = 3 * M
    ids = np.concatenate([np.arange(M, dtype=np.float32),
                          np.arange(M, dtype=np.float32) + rs.uniform(-0.49, 0.49, M),
                          rs.integers(0, M, M).astype(np.float32)]).astype(np.float32)
    row = np.rint(ids).astype(np.int64)
    nrm, d, p = _hits(n, rs)
    seed = M
    jkey = jrng.fold(jrng.key_for(seed), 3)
    u1, u2 = rng.cosine_uniforms(rng.fold(rng.key_for(seed), 3), (n,), device="cpu")
    table = mats.numpy()
    jr = jmat.scatter(jkey, jnp.asarray(d), jnp.asarray(p), jnp.asarray(nrm),
                      jnp.asarray(table[row, 0].astype(np.int32)), jnp.asarray(table[row, 1:4]),
                      jnp.asarray(table[row, 4]))
    jf = np.asarray(jr.attenuation) * (np.asarray(jr.cos_weight) / np.asarray(jr.pdf))[:, None]
    nx, ny, nz = torch.from_numpy(nrm).unbind(1)
    dx, dy, dz = torch.from_numpy(d).unbind(1)
    k = mk.TraceConsts.from_config(RenderConfig())
    f_r, f_g, f_b, wix, wiy, wiz, em = mk.scatter_shade(
        nx, ny, nz, dx, dy, dz, torch.from_numpy(ids), u1, u2, mats, M, k.pdf_eps)
    np.testing.assert_array_equal(em.numpy(), np.asarray(jr.terminated))
    np.testing.assert_allclose(torch.stack([f_r, f_g, f_b], 1).numpy(), jf, rtol=2e-5, atol=2e-5)
    live = ~em.numpy()  # JAX's direction of an emitter is unused (the path ends)
    np.testing.assert_allclose(torch.stack([wix, wiy, wiz], 1).numpy()[live],
                               np.asarray(jr.next_dir)[live], rtol=2e-5, atol=2e-5)
    assert live.any() and (~live).any()
