"""The port's sharded rasterizer and dual pipeline (`ptre_tpu_torch/
parallel/sharding.py`: `shard_raster_step`, `dual_pipeline_step`,
`dual_train_step`, `make_dual_train_step`) against the JAX package's.

JAX runs on its 8 virtual CPU devices; the port as 8 gloo ranks on the CPU,
spawned once for the module (the ``worker`` entry at the end of this file),
on the demo scene at 16x32 (`tests/test_dual_pipeline.py`'s size) and a
ragged 16x30, whose row space pads to 32: the pad rows' windows reach past
the image height, and `to_image_order` drops them. The path-traced terms
take the staged route with the reference's threefry keys, as in
`test_torch_parallel.py`.

Tolerances, those of the single-device tests:
  * hard raster against JAX's one-shot path: every channel within 1e-5 on
    at least 99 % of the pixels (the kernel ties z by Morton order, the
    one-shot path by mesh order: `test_torch_rasterizer.py`);
  * soft raster: atol 3e-5 (`test_torch_soft_raster.py`: online softmax
    against a one-shot softmax);
  * the path-traced accumulator, clamped samples: atol 5e-5. At 16x16
    `test_torch_parallel.py` holds it to `test_parallel.py:84`'s 1e-5; at
    this size one sample of a shard differs from JAX's by up to 1.8e-5
    (clamped; 4.5e-5 at 2.93 unclamped): the staged route's float32
    rounding amplified along a path (ROADMAP C2);
  * `dual_train_step`: loss rtol 1e-5; gradients per leaf rtol 2e-3 with
    atol 1e-4 of the leaf's largest entry (`test_torch_train.py`), except
    the leaves the soft raster term reaches (transforms and camera), held
    to its gradient bound, rtol 2e-3 and atol 2e-3 of the largest entry
    (`test_torch_soft_raster.py`); against the port's own replay rtol 1e-5
    with atol 1e-5 of the leaf's largest entry;
  * `make_dual_train_step` against the direct call: exact.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import _torch_world

W, H = 16, 32
H_RAGGED = 30
WORLD = 8
#: name -> (mesh, soft, row order, height)
RASTER = {
    "hard_4x2": ((4, 2), False, "strided", H),
    "hard_4x2_block": ((4, 2), False, "block", H),
    "hard_8x1_ragged": ((8, 1), False, "strided", H_RAGGED),
    "soft_8x1": ((8, 1), True, "strided", H),
    "soft_4x2_block": ((4, 2), True, "block", H),
    "soft_4x2_ragged": ((4, 2), True, "strided", H_RAGGED),
}
DUAL_MESH, DUAL_SPP, DUAL_KEY = (4, 2), 2, 3
PIPE_KEY = 0
RASTER_LEAVES = ("transforms", "cam_position", "cam_forward", "cam_fov")


def _target(height=H):
    return np.linspace(0.0, 1.0, height * W * 3, dtype=np.float32).reshape(height, W, 3)


def _port(height=H, clamp=False):
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

    scn = demo.reference_demo_scene(8, 4)
    return (scn.build_packet(device="cpu"),
            scn.build_packet(spheres_as_triangles=True, device="cpu"),
            cam_ops.Camera.create(width=W, height=height),
            RenderConfig(width=W, height=height, clamp_samples=clamp, grad_sweep="staged"),
            RasterConfig(width=W, height=height, supersample=2))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the 8-rank world once; returns a loader of rank r's npz."""
    out = tmp_path_factory.mktemp("dual_world")
    _torch_world.run(__file__, WORLD, out / "store", out, timeout=600)
    return lambda name, rank=0: np.load(out / f"{name}_r{rank}.npz")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules and scene (imported here, never in a
    worker). Its sharded steps run under ``jax.jit``: eager ``shard_map``
    takes ~30 s a raster call on the CPU, jitted ~1 s."""
    import jax
    import jax.numpy as jnp

    from ptre_tpu.models import demo as jdemo
    from ptre_tpu.ops import camera as jcam
    from ptre_tpu.ops import rng as jrng
    from ptre_tpu.parallel import sharding as jsh
    from ptre_tpu.render import pathtracer as jpt
    from ptre_tpu.utils.config import RasterConfig, RenderConfig

    scn = jdemo.reference_demo_scene(8, 4)

    def setup(height=H, clamp=False):
        return (jcam.Camera.create(width=W, height=height),
                RenderConfig(width=W, height=height, clamp_samples=clamp),
                RasterConfig(width=W, height=height, supersample=2))

    return dict(jit=jax.jit, jnp=jnp, rng=jrng, sh=jsh, pt=jpt, setup=setup, pkt=scn.build_packet(),
                rpkt=scn.build_packet(spheres_as_triangles=True))


def _grads(r, prefix="grad_"):
    return {k[len(prefix):]: r[k] for k in r.files if k.startswith(prefix)}


def _assert_dual_grads(got, want, what):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        atol = 2e-3 if k in RASTER_LEAVES else 1e-4
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=2e-3,
                                   atol=atol * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", list(RASTER))
def test_shard_raster_step_matches_jax(world, jx, name):
    (dp, sp), soft, order, height = RASTER[name]
    jcam, _, jrcfg = jx["setup"](height)
    jmesh = jx["sh"].make_mesh((dp, sp))
    want = np.asarray(jx["jit"](lambda p: jx["sh"].shard_raster_step(
        jmesh, p, jcam, jrcfg, soft=soft, row_order=order))(jx["rpkt"]))
    got = world(f"raster_{name}")["image"]
    hp = dp * (-(-height // dp))
    assert got.shape == want.shape == (hp, W, 3)  # pad rows included
    if soft:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    else:
        bad = np.any(np.abs(got - want) > 1e-5, axis=-1)
        assert bad.mean() <= 0.01, bad.mean()
    for rank in range(1, WORLD):  # every rank assembles the same image
        np.testing.assert_array_equal(world(f"raster_{name}", rank)["image"], got)


@pytest.mark.parametrize("soft", [False, True])
def test_ragged_shards_in_image_order_equal_the_single_device_image(world, soft):
    """The ragged row space in image order is `rasterize` of the whole
    frame: the windows past H change no real row."""
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import rasterizer as ras

    torch.set_num_threads(1)
    name = "soft_4x2_ragged" if soft else "hard_8x1_ragged"
    (dp, _), _, order, height = RASTER[name]
    _, rpkt, cam, _, rcfg = _port(height)
    with torch.no_grad():
        want = ras.rasterize(rpkt, cam, rcfg, soft=soft).numpy()
    got = sh.to_image_order(torch.from_numpy(world(f"raster_{name}")["image"]), dp, height,
                            order).numpy()
    assert got.shape == (height, W, 3)
    np.testing.assert_array_equal(got, want)


def test_dual_pipeline_step_matches_jax(world, jx):
    """JAX's `dual_pipeline_step` is `shard_render_step` then
    `shard_raster_step` (`sharding.py:357-374`): the accumulator against the
    former run eagerly (under ``jax.jit`` XLA rounds a few pixels 2e-5
    otherwise), the raster slab against the latter under ``jax.jit``."""
    jcam, jcfg, jrcfg = jx["setup"](clamp=True)
    jmesh = jx["sh"].make_mesh(DUAL_MESH)
    acc = jx["sh"].shard_render_step(jmesh, jx["pkt"], jcam, jx["pt"].AccumState.create(H, W),
                                     jx["rng"].key_for(PIPE_KEY), jcfg, spp=DUAL_SPP)
    raster = jx["jit"](lambda p: jx["sh"].shard_raster_step(jmesh, p, jcam, jrcfg))(jx["rpkt"])
    r = world("pipeline")
    assert int(r["frame"]) == int(acc.frame) == DUAL_SPP
    np.testing.assert_allclose(r["linear"], np.asarray(acc.linear), rtol=0, atol=5e-5)
    bad = np.any(np.abs(r["raster"] - np.asarray(raster)) > 1e-5, axis=-1)
    assert bad.mean() <= 0.01, bad.mean()


def test_dual_train_step_matches_jax(world, jx):
    jcam, jcfg, jrcfg = jx["setup"]()
    jsh = jx["sh"]
    dp = DUAL_MESH[0]
    loss, grads = jsh.dual_train_step(
        jsh.make_mesh(DUAL_MESH), jsh.differentiable_params(jx["pkt"], jcam), jx["pkt"],
        jx["rpkt"], jcam, jsh.to_shard_order(jx["jnp"].asarray(_target()), dp),
        jx["rng"].key_for(DUAL_KEY), jcfg, jrcfg, spp=DUAL_SPP)
    r = world("dual")
    np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-5)
    _assert_dual_grads(_grads(r), {k: np.asarray(v) for k, v in grads.items()}, "dual")
    assert float(np.abs(r["grad_transforms"]).max()) > 0  # the raster term reaches it
    for rank in range(1, WORLD):
        rr = world("dual", rank)
        assert float(rr["loss"]) == float(r["loss"])
        for k in _grads(r):
            np.testing.assert_array_equal(rr[f"grad_{k}"], r[f"grad_{k}"])


def test_dual_train_step_equals_replay(world):
    """The sharded step against one autograd graph of every shard's path-
    traced samples and soft raster rows (sp mean, pad mask, dp / n_valid)."""
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import rasterizer as ras

    torch.set_num_threads(1)
    pkt, rpkt, cam, cfg, rcfg = _port()
    (dp, sp), spp = DUAL_MESH, DUAL_SPP
    key = rng.key_for(DUAL_KEY)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in sh.differentiable_params(pkt, cam).items()}
    pk, cm = sh.apply_params(leaves, pkt, cam)
    rp = dataclasses.replace(rpkt, transforms=sh._shared_transforms(
        leaves["transforms"], rpkt.transforms.shape[0]))
    tgt = sh.to_shard_order(torch.from_numpy(_target()), dp)
    rows = H // dp
    total = 0.0
    for dp_i in range(dp):
        y0, stride = sh._row_start_stride(dp_i, rows, dp, "strided")
        imgs = []
        for sp_i in range(sp):
            lkey = rng.fold(key, dp_i * 131071 + sp_i)
            acc = sum(sh._sample_rows(rng.fold(lkey, s), pk, cm, cfg, y0, rows, stride)
                      .reshape(rows, W, 3) for s in range(spp // sp))
            imgs.append(acc / (spp // sp))
        t = tgt[dp_i * rows:(dp_i + 1) * rows]
        rz = ras.raster_rows(rp, cm, rcfg, y0, rows, soft=True, stride=stride)
        total = total + torch.sum((sum(imgs) / sp - t) ** 2) + 0.5 * torch.sum((rz - t) ** 2)
    loss = total / (H * W * 3)
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    r = world("dual")
    np.testing.assert_allclose(float(r["loss"]), float(loss.detach()), rtol=1e-5)
    for k, w in want.items():
        np.testing.assert_allclose(r[f"grad_{k}"], w.numpy(), rtol=1e-5,
                                   atol=1e-5 * max(float(w.abs().max()), 1e-30), err_msg=k)


def test_make_dual_train_step_equals_direct_call(world):
    for rank in (0, WORLD - 1):
        r = world("dual", rank)
        m = world("dual_made", rank)
        assert float(m["loss"]) == float(r["loss"])
        for k in _grads(r):
            np.testing.assert_array_equal(m[f"grad_{k}"], r[f"grad_{k}"], err_msg=k)


# ---- the worker: one rank of the 8-rank world -----------------------------------------------


def _worker(argv):
    rank, world_size, init, (out_dir,) = _torch_world.worker_args(argv)
    torch.set_num_threads(1)
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import distributed
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt

    distributed.initialize(init, world_size, rank, backend="gloo", timeout=300)
    meshes = {shape: sh.make_mesh(shape, device_type="cpu") for shape in ((8, 1), (4, 2))}

    def save(name, **arrays):
        np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
                 **{k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in arrays.items()})

    for name, (shape, soft, order, height) in RASTER.items():
        mesh = meshes[shape]
        _, rpkt, cam, _, rcfg = _port(height)
        slab = sh.shard_raster_step(mesh, rpkt, cam, rcfg, soft=soft, row_order=order)
        save(f"raster_{name}", image=sh.gather_rows(mesh, slab))

    pkt, rpkt, cam, cfg, rcfg = _port(clamp=True)
    mesh = meshes[DUAL_MESH]
    acc0 = pt.AccumState(sh.shard_rows(mesh, torch.zeros((H, W, 3))), 0)
    acc, raster = sh.dual_pipeline_step(mesh, pkt, rpkt, cam, acc0, rng.key_for(PIPE_KEY), cfg,
                                        rcfg, spp=DUAL_SPP)
    pkt, rpkt, cam, cfg, rcfg = _port()
    save("pipeline", linear=sh.gather_rows(mesh, acc.linear), frame=acc.frame,
         raster=sh.gather_rows(mesh, raster))

    params = sh.differentiable_params(pkt, cam)
    target = sh.shard_rows(mesh, sh.to_shard_order(torch.from_numpy(_target()), DUAL_MESH[0]))
    loss, grads = sh.dual_train_step(mesh, params, pkt, rpkt, cam, target,
                                     rng.key_for(DUAL_KEY), cfg, rcfg, spp=DUAL_SPP)
    save("dual", loss=loss, **{f"grad_{k}": v for k, v in grads.items()})
    step = sh.make_dual_train_step(mesh, cam, cfg, rcfg, spp=DUAL_SPP)
    loss, grads = step(params, pkt, rpkt, target, rng.key_for(DUAL_KEY))
    save("dual_made", loss=loss, **{f"grad_{k}": v for k, v in grads.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv)
