"""The port's unified table, recording trace and replay vs the JAX package's.

* `build_table` equals `path_replay._build_table` exactly (the world-space
  triangles of rotated models within one float32 ulp).
* The plain recording trace (`megakernel.trace_record_reference`) vs the JAX
  recording kernel in interpret mode (`megakernel.trace_fused_sel`, external
  threefry uniforms): the hit rows equal, the winners equal where a bounce
  hit, the color within 2e-5 (the same float32 formulas; XLA and PyTorch
  round a few ops differently). Where the JAX kernel's dead rays write tri,
  sph and use_sph rows, the port writes -1 by design.
* The plain replay vs `path_replay.replay(backend="xla")` on the same
  selections and uniforms: color rtol 2e-5 / atol 2e-6; the gradients of
  `test_fused_grad.py`'s weighted-sum loss w.r.t. all ten parameters and
  the primary rays within the bound the fused backward is held to there
  (rtol 5e-4 / atol 1e-5) — including d(mat_param) of the default
  Oren-Nayar material, whose roughness 1.0 sits on clip's upper bound.

The JAX selections are built once per scene (one interpret-mode trace takes
~20 s on a CPU at 16x8, depth 3), and the XLA replay gradient once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import path_replay as jpr
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.parallel import sharding as jsh
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu.utils.config import RenderConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models.scene import PACKET_COUNTS, PACKET_LEAVES
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.utils import interop

W, H, DEPTH = 16, 8, 3
R = W * H


def _diffuse_cube(jp):
    """The demo packet with the cube made Oren-Nayar (roughness 0.4), so
    triangle geometry gets gradient too (the default cube is emissive)."""
    return jp.replace(mat_kind=jnp.zeros_like(jp.mat_kind),
                      mat_param=jnp.asarray([1.0, 0.4], jnp.float32))


def _weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32).reshape(shape))


@pytest.fixture(scope="module", params=["default", "diffuse_cube"])
def case(request):
    jp = jdemo.reference_demo_scene(12, 6).build_packet()
    if request.param == "diffuse_cube":
        jp = _diffuse_cube(jp)
    jc = jcam.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH)
    px, py = jpt.pixel_grid(H, W)
    key = jrng.key_for(1984)
    jitter = jrng.pixel_jitter(jrng.fold(key, 0x9E37), (px.shape[0],))
    o, d = jcam.get_rays(jc, px, py, jitter)
    color, sel_p, ur_p = jmk.trace_fused_sel(key, o, d, jp, cfg, interpret=True,
                                             planar="color")
    sel = np.asarray(sel_p).reshape(4 * DEPTH, -1)[:, :R].reshape(DEPTH, 4, R)
    ur = np.asarray(ur_p).reshape(2 * DEPTH, -1)[:, :R]

    params = jsh.differentiable_params(jp, jc)
    wts = jnp.asarray(_weights((R, 3)))

    def loss(par, oo, dd):
        pk, _ = jsh._apply_params(par, jp, jc)
        c = jpr.replay(oo, dd, jnp.asarray(sel), jnp.asarray(ur), pk, cfg, backend="xla")
        return jnp.sum(c * wts), c

    (_, c_x), g = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(params, o, d)
    pkt = interop.packet_from_numpy({k: np.asarray(getattr(jp, k)) for k in PACKET_LEAVES},
                                    {k: getattr(jp, k) for k in PACKET_COUNTS})
    return dict(
        jp=jp, pkt=pkt, cfg=cfg, o=np.asarray(o), d=np.asarray(d),
        color=np.asarray(color), sel=sel, ur=ur, replay_color=np.asarray(c_x),
        grads=({k: np.asarray(v) for k, v in g[0].items()}, np.asarray(g[1]),
               np.asarray(g[2])),
        params={k: np.asarray(v) for k, v in params.items()})


def _urand(case):
    """The port's (2 + 2B, R) layout: two unused jitter rows first."""
    return torch.from_numpy(np.concatenate(
        [np.zeros((2, R), np.float32), case["ur"]]).astype(np.float32))


TABLE_SCENES = {"reference_demo_scene": (12, 6), "sphere_light_scene": (),
                "cornell_spheres_scene": (), "config3_scene": (False, 16, 8),
                "config4_mixed_scene": (16, 8)}


@pytest.mark.parametrize("scene", list(TABLE_SCENES))
def test_build_table_equals_jax(scene):
    args = TABLE_SCENES[scene]
    jp = getattr(jdemo, scene)(*args).build_packet()
    pkt = getattr(demo, scene)(*args).build_packet()
    table, T, sky6 = path_replay.build_table(pkt)
    jt, jT, jsky = jpr._build_table(jp)
    assert T == jT
    table, jt = table.numpy(), np.asarray(jt)
    np.testing.assert_array_equal(table[:, 18:], jt[:, 18:])
    np.testing.assert_array_equal(sky6.numpy(), np.asarray(jsky))
    # world-space triangles: the transform's 3x3 products sum in another
    # order than XLA's einsum, one float32 ulp apart for rotated models
    # (config 4); the other scenes are bit-equal
    if scene == "config4_mixed_scene":
        np.testing.assert_allclose(table[:, :18], jt[:, :18], rtol=1.2e-7, atol=0)
    else:
        np.testing.assert_array_equal(table[:, :18], jt[:, :18])


def test_recording_trace_matches_jax_kernel(case):
    torch.set_num_threads(1)
    scene = mk.pack_scene(case["pkt"])
    color, sel = mk.trace_record_reference(
        torch.tensor(case["o"]), torch.tensor(case["d"]), scene,
        mk.TraceConsts.from_config(case["cfg"]), DEPTH, urand=_urand(case))
    jsel = case["sel"]
    hit = jsel[:, 3] > 0.5
    np.testing.assert_array_equal(sel.numpy() >= 0, hit)
    want = interop.selections_from_jax(jsel, scene.tri_rows).numpy()
    np.testing.assert_array_equal(sel.numpy()[hit], want[hit])
    np.testing.assert_allclose(color.numpy(), case["color"], rtol=2e-5, atol=2e-5)
    assert hit.any() and (~hit).any() and (want[hit] >= scene.tri_rows).any()


def test_replay_matches_jax_replay(case):
    torch.set_num_threads(1)
    leaves = {k: v.requires_grad_(True)
              for k, v in interop.params_from_numpy(case["params"]).items()}
    o = torch.tensor(case["o"], requires_grad=True)
    d = torch.tensor(case["d"], requires_grad=True)
    cam = cam_ops.Camera.create(width=W, height=H)
    pk, _ = sh.apply_params(leaves, case["pkt"], cam)
    sel = interop.selections_from_jax(case["sel"], pk.tri_v0.shape[0])
    color = path_replay.replay(o, d, sel, _urand(case), pk, case["cfg"])
    np.testing.assert_allclose(color.detach().numpy(), case["replay_color"],
                               rtol=2e-5, atol=2e-6)
    # the replay re-derives the recorded paths (test_path_replay.py's bound)
    np.testing.assert_allclose(color.detach().numpy(), case["color"],
                               rtol=2e-4, atol=2e-5)

    loss = torch.sum(color * torch.from_numpy(_weights((R, 3))))
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [o, d],
                                allow_unused=True)
    jg, jo, jd = case["grads"]
    for k, g in zip(names, grads):
        got = np.zeros_like(jg[k]) if g is None else g.numpy()
        np.testing.assert_allclose(got, jg[k], rtol=5e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(grads[-2].numpy(), jo, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(grads[-1].numpy(), jd, rtol=5e-4, atol=2e-5)
    # the clip-tie case is exercised: default Oren-Nayar roughness 1.0 moved
    assert float(case["params"]["mat_param"][0]) == 1.0 and abs(jg["mat_param"][0]) > 0
