"""The port's sharded render and train steps (`ptre_tpu_torch/parallel/
sharding.py`) against the JAX package's, and against a one-process replay of
each shard's maths.

JAX runs on its 8 virtual CPU devices (`conftest.py`); the port runs as 8
gloo ranks on the CPU (`_torch_world.py`), spawned once for the module: the
``worker`` entry at the end of this file drives every case on meshes (8, 1),
(4, 2) and (2, 4) and writes each rank's results as npz files. A world of
one runs in the test process itself. The port takes the staged route with
the reference's threefry keys (``grad_sweep="staged"``: on the CPU JAX's
"auto" routes staged, `integrator.py:76-79`), so both sides draw the same
paths; one render case also takes the port's default (fused) route, held to
the replay only.

Tolerances:
  * row maps: exact (integers and float32 of small integers);
  * `_sample_rows` and `shard_render_step` against JAX: atol 1e-5
    (`tests/test_parallel.py:84`: the same formulas rounded by XLA and by
    torch); against the port's own replay: exact (the same code on the same
    CPU, and the sp mean of at most two ranks, whose sum is exact in either
    order);
  * `shard_train_step` against JAX: loss rtol 1e-5; gradients per leaf rtol
    2e-3 with atol 1e-4 of the leaf's largest entry
    (`tests/test_torch_train.py:91-97`: the staged adjoints in another
    operation order); against the port's replay: loss rtol 1e-5, gradients
    rtol 1e-5 with atol 1e-5 of the leaf's largest entry (only the order of
    the all-reduce sums differs);
  * the ``make_*`` factories against direct calls: exact.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import _torch_world

H = W = 16
WORLD = 8
MESHES = ((8, 1), (4, 2), (2, 4))
#: name -> (mesh, spp, key seed, port grad_sweep, row order)
RENDER = {
    "8x1": ((8, 1), 2, 0, "staged", "strided"),
    "4x2": ((4, 2), 4, 7, "staged", "strided"),
    "4x2_block": ((4, 2), 4, 7, "staged", "block"),
    "4x2_fused": ((4, 2), 4, 7, "auto", "strided"),
}
#: name -> (mesh, height, spp, key seed, lr, target)
TRAIN = {
    "4x2": ((4, 2), 16, 2, 3, 0.01, "zeros"),
    "2x4": ((2, 4), 16, 4, 3, 0.0, "ramp"),
    "h15": ((4, 2), 15, 2, 6, 0.0, "ramp"),
}
FACTORY_MESH, FACTORY_SPP, FACTORY_LR = (4, 2), 2, 0.01


def _target(kind, height):
    if kind == "zeros":
        return np.zeros((height, W, 3), np.float32)
    return np.linspace(0.0, 1.0, height * W * 3, dtype=np.float32).reshape(height, W, 3)


def _port_config(height, grad_sweep="staged", clamp=True):
    from ptre_tpu_torch.utils.config import RenderConfig

    return RenderConfig(width=W, height=height, grad_sweep=grad_sweep, clamp_samples=clamp,
                        remat_bounces=False)


def _port_scene(height=H):
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops

    return (demo.reference_demo_scene(8, 4).build_packet(device="cpu"),
            cam_ops.Camera.create(width=W, height=height, device="cpu"))


# ---- the port's replay of each shard's maths, in one process ------------------------


def replay_render(pkt, cam, cfg, key, dp, sp, spp, row_order="strided"):
    """The shard-layout image `shard_render_step` gives from zeros, each
    shard's samples traced here one after another."""
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh

    rows = sh.padded_height(cam.height, dp) // dp
    full = torch.zeros((dp * rows, cam.width, 3))
    forward = sh._forward(pkt, cfg)
    for dp_i in range(dp):
        y0, stride = sh._row_start_stride(dp_i, rows, dp, row_order)
        per_sp = []
        for sp_i in range(sp):
            lkey = rng.fold(key, dp_i * 131071 + sp_i)
            lin = torch.zeros((rows, cam.width, 3))
            for s in range(spp // sp):
                n = s + 1
                img = sh._sample_rows(rng.fold(rng.fold(lkey, s), n), pkt, cam, cfg, y0, rows,
                                      stride, forward).reshape(rows, cam.width, 3)
                nf = torch.tensor(float(n))
                lin = img / nf + lin * ((nf - 1.0) / nf)
            per_sp.append(lin)
        mean = per_sp[0]
        for x in per_sp[1:]:
            mean = mean + x
        full[dp_i * rows:(dp_i + 1) * rows] = mean / sp if sp > 1 else mean
    return full


def replay_train(pkt, cam, cfg, key, dp, sp, spp, target, row_order="strided"):
    """(loss, grads) of the global image MSE of the sharded sampling, with
    every shard's samples in one autograd graph."""
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh

    leaves = {k: v.detach().requires_grad_(True)
              for k, v in sh.differentiable_params(pkt, cam).items()}
    pk, cm = sh.apply_params(leaves, pkt, cam)
    forward = sh._forward(pk, cfg)
    rows = sh.padded_height(cam.height, dp) // dp
    tgt = sh.to_shard_order(torch.as_tensor(target), dp, row_order)
    total = 0.0
    for dp_i in range(dp):
        y0, stride = sh._row_start_stride(dp_i, rows, dp, row_order)
        imgs = []
        for sp_i in range(sp):
            lkey = rng.fold(key, dp_i * 131071 + sp_i)
            acc = torch.zeros((rows, cam.width, 3))
            for s in range(spp // sp):
                acc = acc + sh._sample_rows(rng.fold(lkey, s), pk, cm, cfg, y0, rows, stride,
                                            forward).reshape(rows, cam.width, 3)
            imgs.append(acc / (spp // sp))
        img = sum(imgs) / sp
        ys = y0 + stride * np.arange(rows)
        mask = torch.from_numpy((ys < cam.height).astype(np.float32))[:, None, None]
        total = total + torch.sum(mask * (img - tgt[dp_i * rows:(dp_i + 1) * rows]) ** 2)
    loss = total / (cam.height * cam.width * 3)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


# ---- fixtures -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the 8-rank world once; returns a loader of rank r's npz of a
    case."""
    out = tmp_path_factory.mktemp("parallel_world")
    _torch_world.run(__file__, WORLD, out / "store", out, timeout=600)

    def load(name, rank=0):
        return np.load(out / f"{name}_r{rank}.npz")

    return load


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules and demo scene (imported here, never in a
    worker)."""
    import jax
    import jax.numpy as jnp

    from ptre_tpu.models import demo as jdemo
    from ptre_tpu.ops import camera as jcam
    from ptre_tpu.ops import rng as jrng
    from ptre_tpu.parallel import sharding as jsh
    from ptre_tpu.render import pathtracer as jpt
    from ptre_tpu.utils.config import RenderConfig as JConfig

    class NS:
        pass

    ns = NS()
    ns.jnp, ns.rng, ns.sh, ns.pt, ns.cam, ns.Config = jnp, jrng, jsh, jpt, jcam, JConfig
    ns.devices = jax.devices()
    ns.pkt = jdemo.reference_demo_scene(8, 4).build_packet()
    # the port's demo packet is the reference's, leaf for leaf
    pkt, _ = _port_scene()
    for k in ("tri_v0", "transforms", "sph_center", "sph_radius", "mat_albedo", "mat_param"):
        np.testing.assert_array_equal(getattr(pkt, k).numpy(), np.asarray(getattr(ns.pkt, k)))
    return ns


@pytest.fixture(scope="module")
def world_of_one():
    """A world of one in this process (`make_mesh` starts it: gloo, an
    in-process store); torn down with the module."""
    import torch.distributed as dist

    from ptre_tpu_torch.parallel import sharding as sh

    assert not dist.is_initialized()
    mesh = sh.make_mesh((1, 1), device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _assert_grads(got, want, rtol, atol_rel, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert np.isfinite(g).all(), (what, k)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_rel * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{what}: {k}")


# ---- row maps --------------------------------------------------------------------------------


@pytest.mark.parametrize("height", [15, 16])
@pytest.mark.parametrize("row_order", ["strided", "block"])
@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_row_maps_match_jax_exactly(jx, dp, row_order, height):
    from ptre_tpu_torch.parallel import sharding as sh

    assert sh.padded_height(height, dp) == jx.sh.padded_height(height, dp)
    img = np.arange(height * 2 * 3, dtype=np.float32).reshape(height, 2, 3)
    shard = sh.to_shard_order(torch.from_numpy(img), dp, row_order)
    jshard = np.asarray(jx.sh.to_shard_order(jx.jnp.asarray(img), dp, row_order))
    np.testing.assert_array_equal(shard.numpy(), jshard)
    back = sh.to_image_order(shard, dp, height, row_order)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jx.sh.to_image_order(jx.jnp.asarray(jshard), dp, height, row_order)))
    np.testing.assert_array_equal(back.numpy(), img)  # the round trip
    rows = sh.padded_height(height, dp) // dp
    for dp_i in range(dp):
        ids = sh.shard_row_ids(dp_i, rows, dp, row_order, device="cpu")
        np.testing.assert_array_equal(ids.numpy(), np.asarray(
            jx.sh.shard_row_ids(dp_i, rows, dp, row_order)))
        y0, stride = sh._row_start_stride(dp_i, rows, dp, row_order)
        jy0, jstride = jx.sh._row_start_stride(jx.jnp.asarray(dp_i), rows, dp, row_order)
        assert (y0, stride) == (float(jy0), jstride)
        # a shard's slab holds exactly its rows
        real = ids.numpy() < height
        np.testing.assert_array_equal(shard[dp_i * rows:(dp_i + 1) * rows].numpy()[real],
                                      img[ids.numpy()[real].astype(int)])


@pytest.mark.parametrize("y0,rows,stride", [(1.0, 4, 4), (8.0, 8, 1)])
def test_sample_rows_matches_jax(jx, y0, rows, stride):
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    pkt, cam = _port_scene()
    key = rng.fold(rng.key_for(5), 3)
    got = sh._sample_rows(key, pkt, cam, _port_config(H), y0, rows, stride)
    jcam = jx.cam.Camera.create(width=W, height=H)
    want = jx.sh._sample_rows(jx.rng.fold(jx.rng.key_for(5), 3), jx.pkt, jcam,
                              jx.Config(width=W, height=H), y0, rows, stride)
    assert got.shape == (rows * W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---- render --------------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, c in RENDER.items() if c[3] == "staged"])
def test_shard_render_step_matches_jax(world, jx, name):
    mesh, spp, seed, _, order = RENDER[name]
    r = world(f"render_{name}")
    jmesh = jx.sh.make_mesh(mesh)
    jcam = jx.cam.Camera.create(width=W, height=H)
    out = jx.sh.shard_render_step(jmesh, jx.pkt, jcam, jx.pt.AccumState.create(H, W),
                                  jx.rng.key_for(seed), jx.Config(width=W, height=H), spp=spp,
                                  row_order=order)
    assert int(r["frame"]) == int(out.frame) == spp
    np.testing.assert_allclose(r["linear"], np.asarray(out.linear), rtol=0, atol=1e-5)
    assert r["linear"].max() > 0.05


@pytest.mark.parametrize("name", list(RENDER))
def test_shard_render_step_equals_replay(world, name):
    from ptre_tpu_torch.ops import rng

    torch.set_num_threads(1)
    (dp, sp), spp, seed, sweep, order = RENDER[name]
    pkt, cam = _port_scene()
    want = replay_render(pkt, cam, _port_config(H, sweep), rng.key_for(seed), dp, sp, spp,
                         order)
    for rank in range(WORLD):  # every rank assembles the same image
        np.testing.assert_array_equal(world(f"render_{name}", rank)["linear"], want.numpy())


# ---- train -----------------------------------------------------------------------------------


def _jax_train(jx, name):
    (dp, sp), height, spp, seed, lr, tkind = TRAIN[name]
    jcam = jx.cam.Camera.create(width=W, height=height)
    jcfg = jx.Config(width=W, height=height, clamp_samples=False, remat_bounces=False)
    params = jx.sh.differentiable_params(jx.pkt, jcam)
    target = jx.sh.to_shard_order(jx.jnp.asarray(_target(tkind, height)), dp)
    return jx.sh.shard_train_step(jx.sh.make_mesh((dp, sp)), params, jx.pkt, jcam, target,
                                  jx.rng.key_for(seed), jcfg, spp=spp, lr=lr)


def _port_grads(r, prefix="grad_"):
    return {k[len(prefix):]: r[k] for k in r.files if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(TRAIN))
def test_shard_train_step_matches_jax(world, jx, name):
    r = world(f"train_{name}")
    loss, grads, new = _jax_train(jx, name)
    np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-5)
    _assert_grads(_port_grads(r), {k: np.asarray(v) for k, v in grads.items()}, 2e-3, 1e-4,
                  name)
    assert float(np.abs(r["grad_mat_albedo"]).max()) > 0
    lr = TRAIN[name][4]
    if lr:  # SGD applied: new = params - lr * grads, on both sides
        _assert_grads(_port_grads(r, "new_"), {k: np.asarray(v) for k, v in new.items()},
                      1e-6, 1e-6, name)
        for k in grads:
            np.testing.assert_allclose(r[f"new_{k}"], r[f"param_{k}"] - lr * r[f"grad_{k}"],
                                       rtol=0, atol=1e-7)
    for rank in range(1, WORLD):  # every rank returns the same loss and gradients
        rr = world(f"train_{name}", rank)
        assert float(rr["loss"]) == float(r["loss"])
        for k in _port_grads(r):
            np.testing.assert_array_equal(rr[f"grad_{k}"], r[f"grad_{k}"])


@pytest.mark.parametrize("name", ["2x4", "h15"])
def test_shard_train_step_equals_replay(world, name):
    from ptre_tpu_torch.ops import rng

    torch.set_num_threads(1)
    (dp, sp), height, spp, seed, _, tkind = TRAIN[name]
    pkt, cam = _port_scene(height)
    loss, grads = replay_train(pkt, cam, _port_config(height, clamp=False), rng.key_for(seed),
                               dp, sp, spp, _target(tkind, height))
    r = world(f"train_{name}")
    np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-5)
    _assert_grads(_port_grads(r), {k: v.numpy() for k, v in grads.items()}, 1e-5, 1e-5, name)


def test_make_step_factories_equal_direct_calls(world):
    for rank in (0, WORLD - 1):
        r = world("factories", rank)
        for k in r.files:
            if k.startswith("direct_"):
                np.testing.assert_array_equal(r[k], r["made_" + k[len("direct_"):]], err_msg=k)
        assert int(r["made_frame"]) == 2 * FACTORY_SPP  # the second call continued the first


# ---- a world of one, in this process ----------------------------------------------------------


def test_world_of_one_render_equals_replay_and_jax(world_of_one, jx):
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt

    torch.set_num_threads(1)
    pkt, cam = _port_scene()
    cfg = _port_config(H)
    out = sh.shard_render_step(world_of_one, pkt, cam, pt.AccumState.create(H, W, "cpu"),
                               rng.key_for(9), cfg, spp=2)
    assert out.frame == 2
    want = replay_render(pkt, cam, cfg, rng.key_for(9), 1, 1, 2)
    np.testing.assert_array_equal(sh.gather_rows(world_of_one, out.linear).numpy(),
                                  want.numpy())
    jmesh = jx.sh.make_mesh((1, 1), devices=jx.devices[:1])
    jout = jx.sh.shard_render_step(jmesh, jx.pkt, jx.cam.Camera.create(width=W, height=H),
                                   jx.pt.AccumState.create(H, W), jx.rng.key_for(9),
                                   jx.Config(width=W, height=H), spp=2)
    np.testing.assert_allclose(out.linear.numpy(), np.asarray(jout.linear), rtol=0, atol=1e-5)


def test_world_of_one_running_average_is_the_reference_expression(world_of_one):
    """Six samples in one step: the running average is the reference's
    img / n + lin * ((n - 1) / n) in float32 bit for bit, at n = 6 too,
    where (n - 1) * (1 / n) rounds otherwise."""
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt

    torch.set_num_threads(1)
    pkt, cam = _port_scene()
    cfg = _port_config(H)
    out = sh.shard_render_step(world_of_one, pkt, cam, pt.AccumState.create(H, W, "cpu"),
                               rng.key_for(12), cfg, spp=6)
    want = replay_render(pkt, cam, cfg, rng.key_for(12), 1, 1, 6)
    np.testing.assert_array_equal(out.linear.numpy(), want.numpy())


def test_world_of_one_train_equals_replay(world_of_one):
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    pkt, cam = _port_scene()
    cfg = _port_config(H, clamp=False)
    target = _target("ramp", H)
    loss, grads, new = sh.shard_train_step(world_of_one, sh.differentiable_params(pkt, cam),
                                           pkt, cam, torch.from_numpy(target), rng.key_for(4),
                                           cfg, spp=2, lr=0.5)
    want_loss, want = replay_train(pkt, cam, cfg, rng.key_for(4), 1, 1, 2, target)
    assert float(loss) == float(want_loss)
    _assert_grads({k: v.numpy() for k, v in grads.items()},
                  {k: v.numpy() for k, v in want.items()}, 1e-6, 1e-7, "world of one")
    params = sh.differentiable_params(pkt, cam)
    for k in params:
        assert torch.equal(new[k], params[k] - 0.5 * grads[k]), k


def test_steps_check_their_arguments(world_of_one):
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.errors import RendererError

    pkt, cam = _port_scene()
    cfg = _port_config(H)
    with pytest.raises(ValueError, match="does not cover"):
        sh.make_mesh((2, 1), device_type="cpu")
    with pytest.raises(RendererError):  # no card: a "cuda" mesh raises, never the CPU
        sh.make_mesh((1, 1), device_type="cuda")
    with pytest.raises(ValueError, match="slab"):
        sh.shard_render_step(world_of_one, pkt, cam, pt.AccumState.create(H - 1, W, "cpu"),
                             rng.key_for(0), cfg)
    with pytest.raises(ValueError, match="row_order"):
        sh.shard_raster_step(world_of_one, pkt, cam, cfg, row_order="rows")
    with pytest.raises(ValueError, match="slab"):
        sh.shard_train_step(world_of_one, sh.differentiable_params(pkt, cam), pkt, cam,
                            torch.zeros((H, W + 1, 3)), rng.key_for(0), cfg)


# ---- the worker: one rank of the 8-rank world -----------------------------------------------


def _worker(argv):
    rank, world_size, init, (out_dir,) = _torch_world.worker_args(argv)
    torch.set_num_threads(1)
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import distributed
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt

    distributed.initialize(init, world_size, rank, backend="gloo", timeout=300)
    meshes = {shape: sh.make_mesh(shape, device_type="cpu") for shape in MESHES}

    def save(name, **arrays):
        np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
                 **{k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in arrays.items()})

    def accum(mesh, height):
        dp = mesh.shape[0]
        return pt.AccumState(sh.shard_rows(mesh, torch.zeros(
            (sh.padded_height(height, dp), W, 3))), 0)

    pkt, cam = _port_scene()
    for name, (shape, spp, seed, sweep, order) in RENDER.items():
        mesh = meshes[shape]
        out = sh.shard_render_step(mesh, pkt, cam, accum(mesh, H), rng.key_for(seed),
                                   _port_config(H, sweep), spp=spp, row_order=order)
        save(f"render_{name}", linear=sh.gather_rows(mesh, out.linear), frame=out.frame)

    for name, (shape, height, spp, seed, lr, tkind) in TRAIN.items():
        mesh = meshes[shape]
        tpkt, tcam = _port_scene(height)
        params = sh.differentiable_params(tpkt, tcam)
        target = sh.shard_rows(mesh, sh.to_shard_order(torch.from_numpy(_target(tkind, height)),
                                                       shape[0]))
        loss, grads, new = sh.shard_train_step(mesh, params, tpkt, tcam, target,
                                               rng.key_for(seed), _port_config(height,
                                                                               clamp=False),
                                               spp=spp, lr=lr)
        save(f"train_{name}", loss=loss, **{f"grad_{k}": v for k, v in grads.items()},
             **{f"new_{k}": v for k, v in new.items()},
             **{f"param_{k}": v for k, v in params.items()})

    mesh = meshes[FACTORY_MESH]
    cfg = _port_config(H)
    step = sh.make_render_step(mesh, cam, cfg, spp=FACTORY_SPP)
    direct = sh.shard_render_step(mesh, pkt, cam, accum(mesh, H), rng.key_for(3), cfg,
                                  spp=FACTORY_SPP)
    made = step(pkt, accum(mesh, H), rng.key_for(3))
    again = step(pkt, made, rng.key_for(4))
    params = sh.differentiable_params(pkt, cam)
    target = sh.shard_rows(mesh, torch.zeros((H, W, 3)))
    tstep = sh.make_train_step(mesh, cam, cfg, spp=FACTORY_SPP, lr=FACTORY_LR)
    l1, g1, p1 = sh.shard_train_step(mesh, params, pkt, cam, target, rng.key_for(5), cfg,
                                     spp=FACTORY_SPP, lr=FACTORY_LR)
    l2, g2, p2 = tstep(params, pkt, target, rng.key_for(5))
    save("factories", direct_linear=direct.linear, made_linear=made.linear,
         made_frame=again.frame, direct_loss=l1, made_loss=l2,
         **{f"direct_g_{k}": v for k, v in g1.items()}, **{f"made_g_{k}": v for k, v in g2.items()},
         **{f"direct_p_{k}": v for k, v in p1.items()}, **{f"made_p_{k}": v for k, v in p2.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv)
