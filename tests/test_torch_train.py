"""The port's training steps vs the JAX package's (`ptre_tpu/render/train.py`).

`train.mse_step` on the CPU takes the JAX package's staged route
(`integrator.trace`: XLA closest hit, autodiff through the bounce scan), run
with ``remat_bounces=False`` so that no rematerialisation noise enters
(ROADMAP section C). The port takes the very uniforms that route draws,
through ``urand``: per sample s, key_s = fold(key, s), rows 0-1 the pixel
jitter ``pixel_jitter(fold(key_s, 0x9E37))`` + 0.5 and rows 2.. the scatter
pairs ``megakernel._build_urand(key_s, R, max_depth)`` — the draws of
`materials.scatter` (`materials.py:71`, `rng.py:73-80`).

Tolerances. The loss within 1e-5 (relative): both sides trace the same
paths with the same float32 formulas up to rounding. The gradients: the
port differentiates the replay chain (`ops/path_replay`), the reference the
staged intersect and scatter code — the same mathematics, written with
other operation orders, so per-leaf rtol 2e-3 with atol 1e-4 of the leaf's
largest entry (rays near the gradsafe floors amplify the rounding
differences). The two-pass schedule against the monolithic one: only the
summation order differs, `test_train_step.py`'s bound (rtol 2e-4, atol
2e-7).

Triangle-scale packets (BASELINE config 4 at test scale, 264 triangle rows:
past the dense class) take the same steps through the wavefront in record
mode and the backward over the Morton-permuted table; they are held to the
same staged JAX step under the same tolerances, and the two-pass schedule
to the monolithic one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.parallel import sharding as jsh
from ptre_tpu.render import train as jtrain
from ptre_tpu.utils.config import RenderConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import fused_grad
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils import interop

W, H, DEPTH = 16, 8, 5
R = W * H


def jax_urand(key, spp, depth=DEPTH):
    """(spp, 2 + 2*depth, H, W): the staged route's draws per sample."""
    out = []
    for s in range(spp):
        skey = jrng.fold(key, s)
        jit = np.asarray(jrng.pixel_jitter(jrng.fold(skey, 0x9E37), (R,)))
        ur = np.asarray(jmk._build_urand(skey, R, depth))
        out.append(np.concatenate([jit.T + np.float32(0.5), ur]).reshape(-1, H, W))
    return torch.from_numpy(np.stack(out).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    jp = jdemo.reference_demo_scene(8, 4).build_packet()
    jc = jcam.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH, remat_bounces=False)
    key = jrng.key_for(3)
    target = np.random.default_rng(0).uniform(0.0, 0.5, (R, 3)).astype(np.float32)
    params = {k: np.asarray(v) for k, v in jsh.differentiable_params(jp, jc).items()}
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    return dict(jp=jp, jc=jc, cfg=cfg, key=key, target=target, params=params,
                pkt=pkt, cam=cam)


@pytest.mark.parametrize("spp", [1, 2])
def test_mse_step_matches_jax_staged(setup, spp):
    torch.set_num_threads(1)
    s = setup
    jl, jg = jtrain.mse_step(jsh.differentiable_params(s["jp"], s["jc"]), s["jp"],
                             s["jc"], jnp.asarray(s["target"]), s["key"], s["cfg"],
                             spp=spp)
    loss, grads = train.mse_step(interop.params_from_numpy(s["params"], device="cpu"), s["pkt"],
                                 s["cam"], torch.from_numpy(s["target"]), s["cfg"],
                                 seed=0, spp=spp, urand=jax_urand(s["key"], spp))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        want = np.asarray(jg[k])
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=k)
    assert float(np.abs(np.asarray(jg["mat_param"])).max()) > 0


def test_remat_staged_mse_step_matches_jax_staged(setup):
    """The port's staged step with its sample and bounce regions on (the
    default, `gradsafe.remat`) against JAX's staged step without remat, the
    same threefry key drawing the same paths: the tolerances above."""
    from ptre_tpu_torch.utils.config import RenderConfig as PortConfig

    torch.set_num_threads(1)
    s = setup
    spp = 2
    jl, jg = jtrain.mse_step(jsh.differentiable_params(s["jp"], s["jc"]), s["jp"],
                             s["jc"], jnp.asarray(s["target"]), s["key"], s["cfg"],
                             spp=spp)
    cfg = PortConfig(width=W, height=H, max_depth=DEPTH, grad_sweep="staged")
    assert cfg.remat_bounces and not s["cfg"].remat_bounces
    loss, grads = train.mse_step(interop.params_from_numpy(s["params"], device="cpu"), s["pkt"],
                                 s["cam"], torch.from_numpy(s["target"]), cfg,
                                 seed=interop.key_from_jax(np.asarray(s["key"])), spp=spp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        want = np.asarray(jg[k])
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=k)
    assert float(np.abs(np.asarray(jg["sph_radius"])).max()) > 0


def _port_inputs(setup):
    s = setup
    return (interop.params_from_numpy(s["params"], device="cpu"), s["pkt"], s["cam"],
            torch.from_numpy(s["target"]), s["cfg"])


def _assert_grads_equal(g1, g2, rtol=2e-4, atol=2e-7):
    assert set(g1) == set(g2)
    for k in g1:
        assert np.isfinite(g1[k].numpy()).all(), k
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


def test_two_pass_matches_mse_step(setup):
    torch.set_num_threads(1)
    args = _port_inputs(setup)
    l1, g1 = train.mse_step(*args, seed=11, spp=3)
    l2, g2 = train.two_pass_mse_step(*args, seed=11, spp=3)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6, atol=1e-9)
    _assert_grads_equal(g1, g2)


def test_ragged_chunks_give_the_same_gradient(setup):
    """spp 5 in chunks of 2 (2 + 2 + 1) == one sample per chunk."""
    torch.set_num_threads(1)
    args = _port_inputs(setup)
    l1, g1 = train.two_pass_mse_step(*args, seed=4, spp=5, samples_per_call=1)
    before = mk.record_launches, fused_grad.launches
    l2, g2 = train.two_pass_mse_step(*args, seed=4, spp=5, samples_per_call=2)
    assert (mk.record_launches, fused_grad.launches) == before  # plain on the CPU
    assert float(l1) == float(l2)
    _assert_grads_equal(g1, g2)


# ---- triangle-scale packets ---------------------------------------------------------

TRI_DEPTH = 3


@pytest.fixture(scope="module")
def tri_setup():
    jp = jdemo.config4_mixed_scene(12, 6).build_packet()
    jc = jcam.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, max_depth=TRI_DEPTH, remat_bounces=False)
    target = np.random.default_rng(1).uniform(0.0, 0.5, (R, 3)).astype(np.float32)
    params = {k: np.asarray(v) for k, v in jsh.differentiable_params(jp, jc).items()}
    pkt = interop.packet_from_reference(jp, device="cpu")
    assert not mk.dense_supported(pkt)
    return dict(jp=jp, jc=jc, cfg=cfg, key=jrng.key_for(5), target=target, params=params,
                pkt=pkt, cam=cam_ops.Camera.create(width=W, height=H, device="cpu"))


def test_mse_step_triangle_packet_matches_jax_staged(tri_setup):
    torch.set_num_threads(1)
    s = tri_setup
    spp = 2
    jl, jg = jtrain.mse_step(jsh.differentiable_params(s["jp"], s["jc"]), s["jp"],
                             s["jc"], jnp.asarray(s["target"]), s["key"], s["cfg"],
                             spp=spp)
    before = mk.record_launches, fused_grad.launches
    loss, grads = train.mse_step(interop.params_from_numpy(s["params"], device="cpu"), s["pkt"],
                                 s["cam"], torch.from_numpy(s["target"]), s["cfg"],
                                 seed=0, spp=spp, urand=jax_urand(s["key"], spp, TRI_DEPTH))
    assert (mk.record_launches, fused_grad.launches) == before  # plain on the CPU
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        want = np.asarray(jg[k])
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=k)
    assert float(np.abs(np.asarray(jg["transforms"])).max()) > 0


@pytest.mark.parametrize("samples_per_call", [1, 2])
def test_two_pass_matches_mse_step_on_triangle_packet(tri_setup, samples_per_call):
    torch.set_num_threads(1)
    args = _port_inputs(tri_setup)
    l1, g1 = train.mse_step(*args, seed=11, spp=3)
    l2, g2 = train.two_pass_mse_step(*args, seed=11, spp=3,
                                     samples_per_call=samples_per_call)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6, atol=1e-9)
    _assert_grads_equal(g1, g2)
    assert float(g1["transforms"].abs().max()) > 0
