"""The port's SoftRas rasterizer against the JAX package's.

Forward: the plain version of the forward kernel against JAX's
`_soft_fwd_call` in interpret mode (image and residuals). Gradients: the
port's `raster_mse_step` (forward and backward plain versions through
`SoftRaster`) against `jax.value_and_grad` of JAX's one-shot soft path, with
respect to the drawcall transforms and the camera position, with the
tolerances of tests/test_dual_pipeline.py:116-155 (value rtol 1e-6, gradient
atol 2e-3 x its largest entry and rtol 2e-3: online-softmax rescaling vs a
one-shot softmax). JAX's backward kernel is not run here: in interpret mode
it takes minutes (tests/test_kernel_smoke.py:193-197).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops.pallas import soft_raster as jsr
from ptre_tpu.render import rasterizer as jras
from ptre_tpu.utils.config import RasterConfig as JRasterConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import raster_kernel as rk
from ptre_tpu_torch.ops.cuda import soft_raster as sr
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import rasterizer as ras
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils import interop
from ptre_tpu_torch.utils.config import RasterConfig

SIGMA = 0.5


def _demo(W, H, ss=1, segments=8, rings=4):
    torch.set_num_threads(1)
    jp = jdemo.reference_demo_scene(segments, rings).build_packet(spheres_as_triangles=True)
    tp = demo.reference_demo_scene(segments, rings).build_packet(spheres_as_triangles=True)
    jcfg = JRasterConfig(width=W, height=H, supersample=ss)
    return (jp, jcam.Camera.create(width=W, height=H), jcfg, tp,
            cam_ops.Camera.create(width=W, height=H), interop.config_from_reference(jcfg))


@pytest.fixture(scope="module")
def interp_forward():
    """JAX's soft forward kernel in interpret mode on the demo scene (8, 4)
    at 128x16 ss 1: (planar image, residuals), with the table and boxes it
    was given."""
    jp, jc, jcfg, _, _, _ = _demo(128, 16)
    cols, cbox = jsr._soft_cols(jp, jc, jcfg)
    dil = jsr._DILATE_SIGMA * SIGMA
    cbox = cbox.at[:, 0].add(-dil).at[:, 1].add(dil).at[:, 2].add(-dil).at[:, 3].add(dil)
    scal = jnp.concatenate([
        0.2 * jnp.asarray(jcfg.clear_color, jnp.float32), jnp.asarray(jcfg.albedo, jnp.float32),
        jnp.asarray([0.0, -1.0, 0.0], jnp.float32), jnp.asarray(jcfg.clear_color, jnp.float32),
        jnp.asarray([1.0 / SIGMA, 0.0, 1.0, 0.0], jnp.float32)])
    img, res = jsr._soft_fwd_call(scal, cbox, cols, 16, 128, 128, 1, interpret=True)
    return (np.asarray(cols), np.asarray(cbox), np.asarray(scal), np.asarray(img),
            np.asarray(res))


def test_soft_cols_and_scalars_match_reference(interp_forward):
    """The soft table (1e-4: the vertex stage's rounding), the dilated boxes
    and the scalars the port builds for the same call."""
    jcols, jbox, jscal, _, _ = interp_forward
    _, _, _, tp, tc, cfg = _demo(128, 16)
    cols, cbox = sr._soft_cols(tp, tc, cfg)
    np.testing.assert_allclose(cols.detach().numpy(), jcols, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sr.dilate(cbox, SIGMA).numpy(), jbox, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(rk.raster_scalars(cfg, 1.0 / SIGMA).numpy(), jscal)


def test_plain_forward_matches_reference_kernel_interpret(interp_forward):
    """On JAX's own table and boxes: the image within 3e-5 (the bound of
    tests/test_dual_pipeline.py for kernel vs XLA), the same live samples
    (D > 0), and the residuals' shift-invariant content — the coverage
    share s = W/D and the colour N/D — within 3e-5. The max logit m and the
    log-sum-exp m + log D agree to 1e-2 only: a pair 7 pixels outside a tiny
    uv-sphere cap triangle extrapolates its depth with barycentrics in the
    hundreds, so XLA's FMA contraction moves that z by up to ~1e-4 (a logit
    by 1e-2), which the normalised image does not see. Through the port's
    whole entry point (its own table) the resolved image within 3e-5."""
    jcols, jbox, jscal, jimg, jres = (x.copy() for x in interp_forward)
    before = sr.fwd_launches
    img, res = sr.soft_forward(torch.from_numpy(jcols), torch.from_numpy(jbox),
                               torch.from_numpy(jscal), 16, 128, 1)
    assert sr.fwd_launches == before
    assert img.shape == (3, 16, 128) and res.shape == (sr.RES_PLANES, 16, 128)
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=3e-5)
    r, j = res.numpy().astype(np.float64), jres[:6].astype(np.float64)
    live = j[1] > 0.0
    np.testing.assert_array_equal(r[1] > 0.0, live)
    assert 0.05 < live.mean() < 0.95  # geometry and sky both in the window
    d_r, d_j = np.where(live, r[1], 1.0), np.where(live, j[1], 1.0)
    for k in (2, 3, 4, 5):  # s, Nr/D, Ng/D, Nb/D
        np.testing.assert_allclose((r[k] / d_r)[live], (j[k] / d_j)[live], rtol=0, atol=3e-5)
    np.testing.assert_allclose((r[0] + np.log(d_r))[live], (j[0] + np.log(d_j))[live],
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(r[0][live], j[0][live], rtol=0, atol=1e-2)
    assert (r[0][~live] == -sr._BIG).all()

    _, _, _, tp, tc, cfg = _demo(128, 16)
    got = ras.rasterize(tp, tc, cfg, soft=True, sigma=SIGMA)
    np.testing.assert_allclose(got.detach().numpy(), jimg.transpose(1, 2, 0), rtol=0, atol=3e-5)


def _port_loss(tp, tc, cfg, tgt, y0=0.0, rows=None, stride=1, backend="auto"):
    """value, d(transforms), d(cam position) of mean((soft - tgt)^2)."""
    tr = tp.transforms.clone().requires_grad_(True)
    pos = tc.position.clone().requires_grad_(True)
    img = ras.raster_rows(dataclasses.replace(tp, transforms=tr),
                          dataclasses.replace(tc, position=pos), cfg, y0,
                          cfg.height if rows is None else rows, soft=True, sigma=SIGMA,
                          stride=stride, backend=backend)
    loss = torch.mean((img - tgt) ** 2)
    g = torch.autograd.grad(loss, [tr, pos])
    return float(loss), g[0].numpy(), g[1].numpy()


def _jax_loss(jp, jc, jcfg, tgt, y0=0.0, rows=None, stride=1):
    def loss(tr, pos):
        img = jras.raster_rows(jp.replace(transforms=tr), dataclasses.replace(jc, position=pos),
                               jcfg, y0, jcfg.height if rows is None else rows, soft=True,
                               sigma=SIGMA, stride=stride, backend="xla")
        return jnp.mean((img - tgt) ** 2)

    v, (gt, gp) = jax.value_and_grad(loss, (0, 1))(jp.transforms, jc.position)
    return float(v), np.asarray(gt), np.asarray(gp)


def _assert_grads_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        scale = float(np.abs(w).max())
        assert scale > 0.0
        np.testing.assert_allclose(g, w, atol=2e-3 * scale, rtol=2e-3)


def test_gradients_match_jax_value_and_grad_of_one_shot_path():
    """tests/test_dual_pipeline.py:116-155's check, against the port: demo
    scene (8, 4) at 128x8 ss 1, target a ramp; also raster_mse_step."""
    jp, jc, jcfg, tp, tc, cfg = _demo(128, 8)
    tgt = np.linspace(0, 1, 8 * 128 * 3, dtype=np.float32).reshape(8, 128, 3)
    want = _jax_loss(jp, jc, jcfg, jnp.asarray(tgt))
    before = (sr.fwd_launches, sr.bwd_launches)
    got = _port_loss(tp, tc, cfg, torch.from_numpy(tgt))
    assert (sr.fwd_launches, sr.bwd_launches) == before
    _assert_grads_close(got, want)

    params = sh.differentiable_params(tp, tc)
    loss, grads = train.raster_mse_step(params, tp, tc, torch.from_numpy(tgt), cfg, SIGMA)
    assert set(grads) == set(train.RASTER_PARAM_KEYS)
    _assert_grads_close((float(loss), grads["transforms"].numpy(),
                         grads["cam_position"].numpy()), want)
    assert float(grads["cam_forward"].abs().max()) > 0.0


def test_gradients_of_a_strided_ss2_window_match_jax():
    """The (y0, stride) window at ss 2, a size the TPU kernels refuse (the
    width is no multiple of 128)."""
    jp, jc, jcfg, tp, tc, cfg = _demo(40, 24, ss=2)
    tgt = np.random.default_rng(8).uniform(0, 1, (6, 40, 3)).astype(np.float32)
    want = _jax_loss(jp, jc, jcfg, jnp.asarray(tgt), y0=2.0, rows=6, stride=4)
    got = _port_loss(tp, tc, cfg, torch.from_numpy(tgt), y0=2.0, rows=6, stride=4)
    _assert_grads_close(got, want)
    oneshot = _port_loss(tp, tc, cfg, torch.from_numpy(tgt), y0=2.0, rows=6, stride=4,
                         backend="oneshot")
    _assert_grads_close(oneshot, want)


def test_plain_backward_equals_autograd_through_plain_forward():
    """The backward's algebra (softmax cotangents from the residuals, then
    the VJP of pair_terms) against torch autograd through the plain forward's
    online softmax, same inputs: 1e-4 of the largest entry (the online
    rescaling's rounding), and the same rows non-zero."""
    _, _, _, tp, tc, cfg = _demo(48, 16, ss=2)
    cols, cbox = sr._soft_cols(tp, tc, cfg)
    tris = cols.detach().clone().requires_grad_(True)
    box = sr.dilate(cbox, SIGMA)
    scal = rk.raster_scalars(cfg, 1.0 / SIGMA, 0.0, 1)
    dimg = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32, 96))
                            .astype(np.float32))
    img, res = sr.soft_forward_reference(tris, box, scal, 32, 96, 2)
    (want,) = torch.autograd.grad((img * dimg).sum(), tris)
    got = sr.soft_backward(tris.detach(), box, scal, res.detach(), dimg, 32, 96, 2)
    scale = float(want.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal((got.abs().sum(1) > 0).numpy(),
                                  (want.abs().sum(1) > 0).numpy())
    assert float(got[:, 23:27].abs().max()) == 0.0 and float(got[:, 30:].abs().max()) == 0.0


def test_soft_raster_function_returns_no_gradient_for_boxes_and_scalars():
    _, _, _, tp, tc, cfg = _demo(24, 8)
    cols, cbox = sr._soft_cols(tp, tc, cfg)
    tris = cols.detach().clone().requires_grad_(True)
    box = sr.dilate(cbox, SIGMA).requires_grad_(True)
    scal = rk.raster_scalars(cfg, 1.0 / SIGMA).requires_grad_(True)
    img = sr.SoftRaster.apply(tris, box, scal, 8, 24, 1)
    g = torch.autograd.grad(img.sum(), [tris, box, scal], allow_unused=True)
    assert g[0] is not None and float(g[0].abs().max()) > 0.0
    assert g[1] is None and g[2] is None
