"""The port's culled megakernel and triangle-scale gradient path
(`ops/cuda/megakernel.trace_culled`, `ops/cuda/fused_grad.trace_grad`) vs
the JAX package's.

* `pack_super_boxes` equals JAX's exactly (mins and maxes of the same
  float32 values).
* The plain culled trace (`trace_culled_reference`) vs JAX's culled kernel in
  interpret mode (`megakernel.trace_culled_sel`, external threefry uniforms
  handed to the port as ``urand``), through `interop.selections_from_jax`:
  the hit row and, where a bounce hit, the winner EXACTLY (integers; both
  sides sweep ascending Morton rows with strict ``t < best``), the colour
  within 1e-6 — or 2e-5 on config 4, whose r = 10 ground sphere computes
  |oc|^2 - r^2 with an ulp of 7.6e-6 (`test_torch_wavefront.py`
  `_assert_state_close`), where XLA's CPU FMA contraction moves a hit point.
* Culling on, culling off (same row order) and the wavefront are the same
  arithmetic on conservative candidate sets: colour and selections BIT FOR
  BIT in the plain versions.
* `trace_grad` for every ``force`` vs `jax.value_and_grad` of JAX's XLA
  replay driven by the JAX kernel's own recorded selections — the gradient
  JAX's `test_fused_grad.py` holds its fused backward kernel to, which in
  interpret mode costs minutes per execution and is in JAX's slow tier — for
  all ten parameters and the primary rays: rtol 5e-4, atol 2e-5 (d(d): 4e-5),
  `test_fused_grad.py:141`'s bound. The routes among themselves: rtol 1e-5
  (`test_wavefront.py:88-108`); they differ only by the order autograd sums
  the permuted table's rows in.

One interpret-mode forward costs seconds here; there are four.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.models import mesh as mg
from ptre_tpu.models.scene import Material, MaterialKind, Model, Scene
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import path_replay as jpr
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.parallel import sharding as jsh
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu.utils.config import RenderConfig
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import fused_grad as fg
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.utils import interop
from ptre_tpu_torch.utils.errors import RendererError


def t(x):
    return torch.from_numpy(np.array(x))


def _ball_over_ground():
    """`test_fused_grad._tri_setup`'s scene: a diffuse triangle ball (48
    triangles) over an analytic ground sphere."""
    scn = Scene()
    scn.add_mesh("ball", mg.uv_sphere(False, 8, 4, mesh_type=mg.MeshType.TRIANGLES))
    scn.add_mesh("ground", mg.uv_sphere(False, 8, 4))
    scn.add_model("b", Model("ball"))
    scn.get_model("b").set_transforms(1.0, 0.0, (0.0, 0.5, 0.0))
    scn.add_model("g", Model("ground"))
    scn.get_model("g").set_transforms(10.0, 0.0, (0.0, -10.0, 0.0))
    diffuse = scn.add_material(Material(MaterialKind.OREN_NAYAR, (0.6, 0.5, 0.4), 0.7))
    scn.set_model_material("b", diffuse)
    return scn.build_packet()


SCENES = {  # name: (JAX packet, W, H, max_depth, colour atol)
    "ball": (_ball_over_ground, 12, 8, 2, 1e-6),
    "config4": (lambda: jdemo.config4_mixed_scene(12, 6).build_packet(), 16, 8, 3, 2e-5),
}


def _jax_case(name):
    make, W, H, B, atol = SCENES[name]
    jp = make()
    cam = jcam.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    px, py = jpt.pixel_grid(H, W)
    key = jrng.key_for(7)
    jitter = jrng.pixel_jitter(jrng.fold(key, 0x9E37), (px.shape[0],))
    o, d = jcam.get_rays(cam, px, py, jitter)
    return jp, cam, cfg, key, o, d, atol


def _port_case(jp, cfg, o, d, ur_p):
    R = o.shape[0]
    ur = np.asarray(ur_p).reshape(2 * cfg.max_depth, -1)[:, :R]
    urand = t(np.concatenate([np.zeros((2, R), np.float32), ur]).astype(np.float32))
    return interop.packet_from_reference(jp, device="cpu"), t(o), t(d), urand


@pytest.fixture(scope="module", params=list(SCENES))
def culled_case(request):
    """JAX's culled kernel (interpret mode, cull on) on one scene, and the
    port's inputs made from the same arrays."""
    jp, cam, cfg, key, o, d, atol = _jax_case(request.param)
    color, sel_p, ur_p, perm = jmk.trace_culled_sel(key, o, d, jp, cfg, cull=True,
                                                    interpret=True)
    pkt, to, td, urand = _port_case(jp, cfg, o, d, ur_p)
    return dict(name=request.param, cfg=cfg, pkt=pkt, o=to, d=td, urand=urand, atol=atol,
                color=np.asarray(color), sel_p=np.asarray(sel_p), perm=np.asarray(perm))


@pytest.mark.parametrize("n", [1, 8, 13, 254])
def test_pack_super_boxes_equals_jax(n):
    rs = np.random.default_rng(n)
    lo = rs.normal(size=(n, 3)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rs.random((n, 3), np.float32),
                            np.zeros((n, 2), np.float32)], axis=1)
    boxes[rs.integers(0, n)] = np.asarray(jmk._empty_boxes(1))[0]  # an all-padding tile
    want = np.asarray(jmk.pack_super_boxes(jnp.asarray(boxes)))
    got = mk.pack_super_boxes(t(boxes))
    assert got.shape == (-(-n // 8), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_culled_reference_matches_jax_kernel(culled_case):
    torch.set_num_threads(1)
    c = culled_case
    cfg, R = c["cfg"], c["o"].shape[0]
    scene = wf.prepare_scene(c["pkt"])
    np.testing.assert_array_equal(scene.perm_tri.numpy(), c["perm"])
    color, sel = mk.trace_culled_reference(
        c["o"], c["d"], scene, mk.TraceConsts.from_config(cfg), cfg.max_depth,
        urand=c["urand"], record=True, lanes=128)
    want = interop.selections_from_jax(c["sel_p"], scene.tri_rows, n_rays=R).numpy()
    np.testing.assert_array_equal(sel.numpy() >= 0, want >= 0)
    np.testing.assert_array_equal(sel.numpy(), want)
    np.testing.assert_allclose(color.numpy(), c["color"], rtol=0, atol=c["atol"])
    assert (want >= scene.tri_rows).any() and ((want >= 0) & (want < scene.tri_rows)).any()
    assert (want[-1] >= 0).any() and (want == -1).any()
    # the wrapper on CPU tensors is the plain version, without a launch
    before = mk.culled_launches
    again = mk.trace_culled(c["o"], c["d"], scene, mk.TraceConsts.from_config(cfg),
                            cfg.max_depth, urand=c["urand"], lanes=128)
    assert torch.equal(again, color) and mk.culled_launches == before


@pytest.mark.parametrize("lanes", [32, 256])
def test_cull_uncull_and_wavefront_bit_identical(culled_case, lanes):
    """The two-level cull bounded by the best hit, the brute sweep of the same
    rows and the wavefront's shortlists give every ray the same closest hit:
    colour and selections bit for bit, with Philox draws and any block size."""
    torch.set_num_threads(1)
    c = culled_case
    cfg = c["cfg"]
    k = mk.TraceConsts.from_config(cfg)
    scene = wf.prepare_scene(c["pkt"])
    args = (c["o"], c["d"], scene, k, cfg.max_depth, 11, 3)
    culled = mk.trace_culled_reference(*args, cull=True, record=True, lanes=lanes)
    brute = mk.trace_culled_reference(*args, cull=False, record=True, lanes=lanes)
    wave = wf.trace(*args, record=True, lanes=lanes)
    for got in (brute, wave[:2]):
        assert torch.equal(got[0], culled[0]) and torch.equal(got[1], culled[1])
    assert torch.equal(mk.trace_culled_reference(*args, lanes=lanes), culled[0])
    assert torch.equal(mk.trace_culled_sel(*args)[2], scene.perm_tri)
    # the packet's own row order (the unculled megakernel of the reference):
    # the same image, rows of another numbering
    own = wf.prepare_scene(c["pkt"], morton=False)
    assert own.perm_tri is None
    col, sel = mk.trace_culled_reference(c["o"], c["d"], own, k, cfg.max_depth, 11, 3,
                                         cull=False, record=True, lanes=lanes)
    assert torch.equal(col, culled[0])
    tri = (sel >= 0) & (sel < scene.tri_rows)
    assert torch.equal(scene.perm_tri[culled[1][tri].long()], sel[tri].long())
    assert torch.equal(sel[~tri], culled[1][~tri])


def test_scene_boxes_for_the_culled_walk():
    pkt = interop.packet_from_reference(jdemo.config4_mixed_scene(24, 12).build_packet(),
                                        device="cpu")
    scene = wf.prepare_scene(pkt)
    n_super = -(-scene.n_leaf // mk.SUPER)
    assert scene.n_leaf % mk.SUPER != 0  # the last supertile is ragged
    assert scene.super_boxes.shape == (n_super, 8)
    assert scene.cull_boxes.shape == (n_super * mk.SUPER, 8)
    # the leaf boxes grown by CULL_PAD_REL of the scene's largest coordinate
    pad = wf.CULL_PAD_REL * torch.maximum(scene.scene_lo.abs().amax(),
                                          scene.scene_hi.abs().amax())
    assert torch.equal(scene.cull_boxes[:scene.n_leaf, 0:3], scene.boxes[:, 0:3] - pad)
    assert torch.equal(scene.cull_boxes[:scene.n_leaf, 3:6], scene.boxes[:, 3:6] + pad)
    full = scene.boxes[:, 0] <= scene.boxes[:, 3]  # an empty box stays empty
    assert bool(full.any()) and not bool((scene.cull_boxes[:scene.n_leaf][~full, 0] <= 1e29).any())
    assert bool((scene.cull_boxes[:scene.n_leaf][full, 0:3] < scene.boxes[full, 0:3]).all())
    assert torch.equal(scene.cull_boxes[scene.n_leaf:],
                       mk.empty_boxes(n_super * mk.SUPER - scene.n_leaf, device="cpu"))
    assert torch.equal(scene.super_boxes, mk.pack_super_boxes(scene.cull_boxes))
    assert scene.tri_rows == pkt.tri_valid.shape[0] <= scene.tris.shape[0]
    assert not bool((scene.tris[scene.tri_rows:, 18] > 0.5).any())  # dead rows
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(RendererError, match="cuda or cpu"):
        mk.trace_culled(meta, meta, scene, mk.TraceConsts.from_config(
            RenderConfig(width=2, height=2)), 2)


# ---- the gradient path -------------------------------------------------------------

def _weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32).reshape(shape))


@pytest.fixture(scope="module")
def grad_case():
    """JAX's unculled kernel's selections on the ball scene (rows of the
    packet's own order, `test_fused_grad.py:122-133`) and value_and_grad of
    the XLA replay over them."""
    jp, cam, cfg, key, o, d, _ = _jax_case("ball")
    color, sel_p, ur_p, perm = jmk.trace_culled_sel(key, o, d, jp, cfg, cull=False,
                                                    interpret=True)
    assert perm is None
    R, B = o.shape[0], cfg.max_depth
    sel = jnp.asarray(np.asarray(sel_p).reshape(4 * B, -1)[:, :R].reshape(B, 4, R))
    ur = jnp.asarray(np.asarray(ur_p).reshape(2 * B, -1)[:, :R])
    params = jsh.differentiable_params(jp, cam)
    wts = jnp.asarray(_weights((R, 3)))

    def loss(par, oo, dd):
        pk, _ = jsh._apply_params(par, jp, cam)
        c = jpr.replay(oo, dd, sel, ur, pk, cfg, backend="xla")
        return jnp.sum(c * wts), c

    (_, c_x), g = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(params, o, d)
    pkt, to, td, urand = _port_case(jp, cfg, o, d, ur_p)
    return dict(cfg=cfg, pkt=pkt, o=to, d=td, urand=urand, color=np.asarray(color),
                params={k: np.asarray(v) for k, v in params.items()},
                grads=({k: np.asarray(v) for k, v in g[0].items()}, np.asarray(g[1]),
                       np.asarray(g[2])))


def _port_grads(case, force):
    cfg = case["cfg"]
    leaves = {k: v.requires_grad_(True)
              for k, v in interop.params_from_numpy(case["params"], device="cpu").items()}
    o = case["o"].clone().requires_grad_(True)
    d = case["d"].clone().requires_grad_(True)
    cam = cam_ops.Camera.create(width=cfg.width, height=cfg.height, device="cpu")
    pk, _ = sh.apply_params(leaves, case["pkt"], cam)
    color = fg.trace_grad(o, d, pk, cfg, urand=case["urand"], force=force)
    loss = torch.sum(color * t(_weights(tuple(color.shape))))
    grads = torch.autograd.grad(loss, list(leaves.values()) + [o, d], allow_unused=True)
    named = {k: (torch.zeros_like(v) if g is None else g).numpy()
             for (k, v), g in zip(leaves.items(), grads)}
    return color.detach().numpy(), named, grads[-2].numpy(), grads[-1].numpy()


@pytest.mark.parametrize("force", [None, "wavefront", "culled", "uncull"])
def test_trace_grad_matches_jax_for_every_forward(grad_case, force):
    torch.set_num_threads(1)
    color, named, g_o, g_d = _port_grads(grad_case, force)
    np.testing.assert_allclose(color, grad_case["color"], rtol=0, atol=1e-6)
    want, want_o, want_d = grad_case["grads"]
    assert set(named) == set(want)
    for key in want:
        np.testing.assert_allclose(named[key], want[key], rtol=5e-4, atol=2e-5, err_msg=key)
    np.testing.assert_allclose(g_o, want_o, rtol=5e-4, atol=2e-5)
    np.testing.assert_allclose(g_d, want_d, rtol=5e-4, atol=4e-5)
    assert np.abs(named["transforms"]).max() > 1e-4  # geometry gradient observable
    assert np.abs(named["sph_radius"]).max() > 0 and np.abs(g_o).max() > 0


def test_trace_grad_routes_agree(grad_case):
    """Wavefront route == culled route == unculled route: the same
    selections and uniforms give the same backward (`test_wavefront.py:88-108`)."""
    torch.set_num_threads(1)
    ref = _port_grads(grad_case, "culled")
    for force in ("wavefront", "uncull"):
        got = _port_grads(grad_case, force)
        assert np.array_equal(got[0], ref[0])
        for key in ref[1]:
            np.testing.assert_allclose(got[1][key], ref[1][key], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{force} {key}")
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[3], ref[3])


def test_force_values_and_packing_once():
    pkt = interop.packet_from_reference(jdemo.config4_mixed_scene(12, 6).build_packet(),
                                        device="cpu")
    assert not mk.dense_supported(pkt)
    cfg = RenderConfig(width=4, height=2, max_depth=2)
    o = torch.zeros((8, 3))
    d = torch.tensor([[0.0, -0.2, 1.0]]).expand(8, 3) / float(np.sqrt(1.04))
    with pytest.raises(RendererError, match="force"):
        fg.trace_grad(o, d, pkt, cfg, force="staged")
    with pytest.raises(RendererError, match="dense-class"):
        fg.trace_grad(o, d, pkt, cfg, force="dense")
    kinds = {f: fg.prepare_forward(pkt, f).kind for f in (None,) + fg.FORWARDS[1:]}
    assert kinds == {None: "wavefront", "wavefront": "wavefront", "culled": "culled",
                     "uncull": "uncull"}
    # 48 triangles: dense-class
    ball = interop.packet_from_reference(_ball_over_ground(), device="cpu")
    assert fg.prepare_forward(ball).kind == fg.prepare_forward(ball, "dense").kind == "dense"
    assert fg.prepare_forward(ball, "wavefront").kind == "wavefront"
    fwd = fg.prepare_forward(pkt)
    a = fg.trace_grad(o, d, pkt, cfg, seed=3, forward=fwd)
    assert torch.equal(a, fg.trace_grad(o, d, pkt, cfg, seed=3))
    assert not fwd.scene.tris.requires_grad
