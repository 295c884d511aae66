"""The port's rematerialisation (`ops/gradsafe.remat`) on the CPU: the
sample regions of `render/train.mse_step` and of the sharded train and dual
steps (`parallel/sharding._pt_image`), and the per-bounce regions of
`ops/integrator.trace_staged`, whose sweep winners are computed outside.

Tolerances: none. A region recomputes the same operations on the same
inputs with the same draws, and the recompute feeds the same backward, so
the loss and every gradient with ``remat_bounces=True`` (the default) equal
those with ``remat_bounces=False`` bit for bit, on every route. (On the card
the fused backward sums d(table) and d(sky) by atomics; there they are held
to its run-to-run bound, `tests/test_torch_cuda.py`.)

Memory, counted as the bytes of the tensors autograd saves
(``saved_tensors_hooks``): a step's forward at spp 2 and spp 4 saves the
same bytes (no sample's residuals), and those plus one sample's own
residuals, which the backward recomputes one sample at a time, are what the
forward of a spp-1 step (a direct call) saves. What else the forward
leaves reachable when the backward starts (a region's inputs are held
outside the saved tensors unless each is a tensor argument of its own) is
the same at spp 2 and 4. Per-bounce remat keeps under a tenth of the staged
trace's residuals.

The sharded steps run in a world of one, a gloo rank spawned through
`_torch_world.py` (this file's ``worker`` entry, which imports no JAX).
"""

from __future__ import annotations

import gc
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import _torch_world

W, H = 16, 8
R = W * H
SEED = 5
#: the steps' sample count where both regions are on
SPP = 3
SHARD_SPP = 2


def _demo(width=W, height=H):
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops

    return (demo.reference_demo_scene(8, 4).build_packet(device="cpu"),
            cam_ops.Camera.create(width=width, height=height, device="cpu"))


def _config(remat, width=W, height=H, **kw):
    from ptre_tpu_torch.utils.config import RenderConfig

    return RenderConfig(width=width, height=height, remat_bounces=remat, **kw)


def _target(n):
    return torch.from_numpy(np.random.default_rng(0).uniform(0.0, 0.5, (n, 3))
                            .astype(np.float32))


def _assert_bit_equal(a, b, what):
    (la, ga), (lb, gb) = a, b
    assert float(la) == float(lb), what
    assert set(ga) == set(gb), what
    for k in ga:
        assert torch.equal(ga[k], gb[k]), (what, k)


#: the routes of `mse_step`, each with its packet, grad_sweep and seed (`_route`)
ROUTES = ("dense fused", "config 4 wavefront", "staged philox", "staged key")


def _route(name):
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng

    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    if name == "config 4 wavefront":
        return demo.config4_mixed_scene(12, 6).build_packet(device="cpu"), cam, "auto", SEED
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    if name == "dense fused":
        return pkt, cam, "auto", SEED
    return pkt, cam, "staged", rng.key_for(3) if name == "staged key" else SEED


@pytest.mark.parametrize("name", ROUTES)
def test_mse_step_remat_is_bit_equal(name):
    from ptre_tpu_torch.ops import integrator
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train

    torch.set_num_threads(1)
    pkt, cam, sweep, seed = _route(name)
    want_route = {"dense fused": "fused", "config 4 wavefront": "fused"}.get(name, "staged")
    out = {}
    for remat in (True, False):
        cfg = _config(remat, grad_sweep=sweep)
        assert integrator.grad_route(cfg, pkt) == want_route
        out[remat] = train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, _target(R),
                                    cfg, seed, spp=SPP)
    _assert_bit_equal(out[True], out[False], name)
    assert float(out[True][1]["mat_albedo"].abs().max()) > 0
    if name == "config 4 wavefront":
        assert float(out[True][1]["transforms"].abs().max()) > 0


@pytest.mark.parametrize("keyed", [False, True])
def test_trace_staged_remat_is_bit_equal(keyed):
    """`trace_staged` alone: colour and the gradients of the rays and of
    every packet leaf, per-bounce regions on and off."""
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import integrator, rng
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt

    torch.set_num_threads(1)
    pkt, cam = _demo()
    wts = _target(R)
    out = {}
    for remat in (True, False):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in sh.differentiable_params(pkt, cam).items()}
        pk, cm = sh.apply_params(leaves, pkt, cam)
        px, py = pt.pixel_grid(H, W, "cpu")
        o, d = cam_ops.get_rays(cm, px, py, torch.zeros((R, 2)))
        cfg = _config(remat, grad_sweep="staged")
        color = integrator.trace_staged(o, d, pk, cfg, seed=SEED, sample=1,
                                        key=rng.key_for(9) if keyed else None)
        grads = torch.autograd.grad(torch.sum(color * wts), list(leaves.values()))
        out[remat] = color.detach(), dict(zip(leaves, grads))
    assert torch.equal(out[True][0], out[False][0])
    _assert_bit_equal((0.0, out[True][1]), (0.0, out[False][1]), "trace_staged")
    assert float(out[True][1]["cam_position"].abs().max()) > 0


def test_staged_sweep_runs_once_a_bounce_and_again_only_with_its_sample(monkeypatch):
    """Per-bounce remat passes the sweep's winners in: at spp 1 a staged
    step sweeps max_depth times, forward and backward. At spp 2 the backward
    recomputes each sample, sweeps included: twice max_depth a sample."""
    from ptre_tpu_torch.ops import integrator
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train

    torch.set_num_threads(1)
    pkt, cam = _demo()
    cfg = _config(True, grad_sweep="staged")
    swept = []
    make = integrator._sweep_fn

    def spy(scene, consts, active):
        fn = make(scene, consts, active)

        def counted(*args):
            swept.append(int(active.sum()))
            return fn(*args)

        return counted

    monkeypatch.setattr(integrator, "_sweep_fn", spy)
    for spp in (1, 2):
        swept.clear()
        train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, _target(R), cfg, SEED,
                       spp=spp)
        assert len(swept) == (1 if spp == 1 else 2 * spp) * cfg.max_depth, (spp, swept)


def test_plain_replay_chain_remat_replay_is_bit_equal():
    """`path_replay.replay` (the plain chain, a graph a bounce) with
    ``remat_replay`` on and off: colour and gradients bit for bit."""
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import path_replay
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt

    torch.set_num_threads(1)
    pkt, cam = _demo()
    wts = _target(R)
    out = {}
    for remat in (True, False):
        cfg = _config(False, remat_replay=remat)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in sh.differentiable_params(pkt, cam).items()}
        pk, cm = sh.apply_params(leaves, pkt, cam)
        px, py = pt.pixel_grid(H, W, "cpu")
        o, d = cam_ops.get_rays(cm, px, py, torch.zeros((R, 2)))
        consts = mk.TraceConsts.from_config(cfg)
        with torch.no_grad():
            _, sel = mk.trace_record_reference(o, d, mk.pack_scene(pk), consts, cfg.max_depth,
                                               SEED, 0)
        ur = mk.trace_uniforms(o, cfg.max_depth, SEED, 0)
        color = path_replay.replay(o, d, sel, ur, pk, cfg)
        grads = torch.autograd.grad(torch.sum(color * wts), list(leaves.values()))
        out[remat] = color.detach(), dict(zip(leaves, grads))
    assert torch.equal(out[True][0], out[False][0])
    _assert_bit_equal((0.0, out[True][1]), (0.0, out[False][1]), "replay")
    assert float(out[True][1]["sph_radius"].abs().max()) > 0


def test_render_takes_no_remat_region(monkeypatch):
    """Without autograd (rendering) the staged trace opens no region."""
    from ptre_tpu_torch.ops import gradsafe, rng
    from ptre_tpu_torch.render import pathtracer as pt

    torch.set_num_threads(1)
    pkt, cam = _demo()
    calls = []
    real = gradsafe.remat

    def counted(fn, *args):
        calls.append(fn.__name__)
        return real(fn, *args)

    monkeypatch.setattr(gradsafe, "remat", counted)
    cfg = _config(True, intersect_backend="pallas")
    assert pt.route(pkt, cfg) == "staged"
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, "cpu"), rng.key_for(1), cfg,
                         spp=2)
    assert calls == [] and bool(torch.isfinite(acc.linear).all())


# ---- memory: the bytes autograd saves --------------------------------------------------------


def _saved_bytes(fn, monkeypatch=None):
    """Bytes of the tensors autograd saves while ``fn()`` runs; with
    ``monkeypatch``, those saved before `train.mse_step` asks for its
    gradients (its forward only)."""
    from ptre_tpu_torch.render import train

    state = {"on": True, "bytes": 0}

    def pack(t):
        if state["on"]:
            state["bytes"] += t.numel() * t.element_size()
        return t

    if monkeypatch is not None:
        real = train._grad_dict

        def grad_dict(out, leaves):
            state["on"] = False
            return real(out, leaves)

        monkeypatch.setattr(train, "_grad_dict", grad_dict)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return state["bytes"]


@pytest.mark.parametrize("sweep", ["auto", "staged"])
def test_mse_step_forward_keeps_no_sample_residuals(sweep, monkeypatch):
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train

    torch.set_num_threads(1)
    w, h = 32, 16
    pkt, cam = _demo(w, h)
    cfg = _config(True, w, h, grad_sweep=sweep)
    params = sh.differentiable_params(pkt, cam)
    target = _target(w * h)

    def step(spp):
        return _saved_bytes(lambda: train.mse_step(params, pkt, cam, target, cfg, SEED,
                                                   spp=spp), monkeypatch)

    leaves = train._leaves(params)
    forward = train._forward_of(leaves, pkt, cam, cfg)
    one_sample = _saved_bytes(lambda: train.sample_color(leaves, pkt, cam, cfg, SEED, 0,
                                                         forward=forward))
    at = {spp: step(spp) for spp in (1, 2, 4)}
    assert at[2] == at[4] == w * h * 3 * 4, at  # the loss's (mean - target) alone
    assert at[4] + one_sample == at[1], (at, one_sample)


def _live_tensor_bytes():
    """Bytes of the storages of every tensor the interpreter can reach."""
    seen, total = set(), 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # isinstance on deprecated torch aliases
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor):
                storage = obj.untyped_storage()
                if storage.data_ptr() not in seen:
                    seen.add(storage.data_ptr())
                    total += storage.nbytes()
    return total


@pytest.mark.parametrize("sweep", ["auto", "staged"])
def test_mse_step_forward_holds_no_sample_tensors(sweep, monkeypatch):
    """What the forward leaves reachable when the backward starts (the
    regions' inputs, which they hold outside autograd's saved tensors
    unless they are tensors of their own) does not grow with spp."""
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train

    torch.set_num_threads(1)
    w, h = 32, 16
    pkt, cam = _demo(w, h)
    cfg = _config(True, w, h, grad_sweep=sweep)
    target = _target(w * h)
    real, live = train._grad_dict, {}

    def grad_dict(out, leaves):
        live[spp] = _live_tensor_bytes()
        return real(out, leaves)

    monkeypatch.setattr(train, "_grad_dict", grad_dict)
    for spp in (2, 4):
        train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg, SEED, spp=spp)
    assert live[2] == live[4], live


def test_trace_staged_keeps_a_tenth_of_its_residuals():
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train

    torch.set_num_threads(1)
    w, h = 32, 16
    pkt, cam = _demo(w, h)
    got = {}
    for remat in (True, False):
        cfg = _config(remat, w, h, grad_sweep="staged")
        leaves = train._leaves(sh.differentiable_params(pkt, cam))
        got[remat] = _saved_bytes(lambda: train.sample_color(leaves, pkt, cam, cfg, SEED, 0))
    assert got[True] * 10 < got[False], got


# ---- the sharded steps in a world of one ------------------------------------------------------

SHARD_STEPS = ("shard_train_step", "dual_train_step")
#: the sharded steps' routes: the fused route's plain versions, the staged route with a key
SHARD_SWEEPS = ("auto", "staged")


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    out = tmp_path_factory.mktemp("remat_world")
    _torch_world.run(__file__, 1, out / "store", out, timeout=300)
    return lambda name, sweep, remat: np.load(out / f"{name}_{sweep}_{int(remat)}.npz")


@pytest.mark.parametrize("sweep", SHARD_SWEEPS)
@pytest.mark.parametrize("name", SHARD_STEPS)
def test_sharded_step_remat_is_bit_equal(world_of_one, name, sweep):
    on, off = world_of_one(name, sweep, True), world_of_one(name, sweep, False)
    assert set(on.files) == set(off.files) and "loss" in on.files
    for k in on.files:
        np.testing.assert_array_equal(on[k], off[k], err_msg=f"{name}: {k}")
    assert float(np.abs(on["grad_mat_albedo"]).max()) > 0


def _worker(argv):
    rank, world_size, init, (out_dir,) = _torch_world.worker_args(argv)
    torch.set_num_threads(1)
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import distributed
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.utils.config import RasterConfig

    distributed.initialize(init, world_size, rank, backend="gloo", timeout=300)
    mesh = sh.make_mesh((1, 1), device_type="cpu")
    pkt, cam = _demo()
    rpkt = demo.reference_demo_scene(8, 4).build_packet(spheres_as_triangles=True,
                                                        device="cpu")
    rcfg = RasterConfig(width=W, height=H, supersample=2)
    params = sh.differentiable_params(pkt, cam)
    target = _target(R).reshape(H, W, 3)
    key = rng.key_for(4)
    for sweep in SHARD_SWEEPS:
        for remat in (True, False):
            cfg = _config(remat, grad_sweep=sweep, clamp_samples=False)
            loss, grads, _ = sh.shard_train_step(mesh, params, pkt, cam, target, key, cfg,
                                                 spp=SHARD_SPP)
            dloss, dgrads = sh.dual_train_step(mesh, params, pkt, rpkt, cam, target, key, cfg,
                                               rcfg, spp=SHARD_SPP)
            for name, (l, g) in (("shard_train_step", (loss, grads)),
                                 ("dual_train_step", (dloss, dgrads))):
                np.savez(os.path.join(out_dir, f"{name}_{sweep}_{int(remat)}.npz"),
                         loss=l.numpy(), **{f"grad_{k}": v.numpy() for k, v in g.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv)
