"""The port's gradsafe forms vs the JAX package's (`ptre_tpu/ops/gradsafe.py`).

Values: bit-equal to JAX's straight-through value everywhere on the grid,
and bit-equal to the forward formula wherever the stable denominator is not
floored (there ``stable == forward``). Gradients: equal to ``jax.grad`` of
the JAX form on a grid that includes the singular points and the ties with
each floor, where JAX's ``maximum`` gives half. Both sides run the same
float32 operations, so the bound is a few ulp (rtol 1e-6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.ops import gradsafe as jgs
from ptre_tpu_torch.ops import gradsafe as gs


def _grad_torch(fn, *xs):
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    out = fn(*leaves)
    if not out.requires_grad:  # a detached form: its gradient is zero
        return out.detach().numpy(), [np.zeros_like(x) for x in xs]
    grads = torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    return out.detach().numpy(), [np.zeros_like(x) if g is None else g.numpy()
                                  for x, g in zip(xs, grads)]


def _grad_jax(fn, *xs):
    out = np.asarray(fn(*map(jnp.asarray, xs)))
    grads = jax.grad(lambda *a: jnp.sum(fn(*a)), argnums=tuple(range(len(xs))))(
        *map(jnp.asarray, xs))
    return out, [np.asarray(g) for g in grads]


def _assert_same(port, ref):
    (v, gp), (w, gr) = port, ref
    np.testing.assert_array_equal(v, w)
    for a, b in zip(gp, gr):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def _f32(*vals):
    return np.asarray(vals, dtype=np.float32)


def test_stable_inv_det():
    e1_sq, e2_sq = np.float32(1.0), np.float32(4.0)
    floor = np.float32(gs.TAU_DET) * np.sqrt(e1_sq * e2_sq)
    det = _f32(-2.0, -0.5, -floor, -1e-4, -1e-9, 0.0, 1e-7, 1e-4, floor,
               np.nextafter(floor, np.float32(1)), 0.7, 3.0)
    n = det.shape[0]
    e1 = np.full(n, e1_sq, np.float32)
    e2 = np.full(n, e2_sq, np.float32)
    port = _grad_torch(gs.stable_inv_det, det, e1, e2)
    _assert_same(port, _grad_jax(jgs.stable_inv_det, det, e1, e2))
    free = np.abs(det) > floor
    np.testing.assert_array_equal(port[0][free], np.float32(1) / det[free])
    assert port[1][0][np.abs(det) == floor].tolist() == pytest.approx(
        [0.5 * -1.0 / floor ** 2] * 2, rel=1e-6)  # the tie with the floor
    assert (port[1][0][np.abs(det) < floor] == 0).all()
    assert (port[1][1] == 0).all() and (port[1][2] == 0).all()  # floor detached


def test_stable_sqrt_delta():
    radius = _f32(0.5, 1.0, 10.0)
    floors = np.float32(gs.TAU_DELTA) * radius * radius + np.float32(1e-24)
    delta = np.concatenate([
        np.stack([_f32(-1.0, 0.0, 1e-30, 1e-9)] * 3, axis=1),
        floors[None, :],
        np.stack([_f32(1e-3, 0.25, 4.0)] * 3, axis=1)]).astype(np.float32)
    r = np.broadcast_to(radius, delta.shape).copy()
    port = _grad_torch(gs.stable_sqrt_delta, delta, r)
    _assert_same(port, _grad_jax(jgs.stable_sqrt_delta, delta, r))
    free = delta > floors[None, :]
    np.testing.assert_array_equal(port[0][free], np.sqrt(delta[free]))
    assert (port[0][delta <= 0] == 0).all() and (port[1][0][delta <= 0] == 0).all()


def test_stable_recip_cos():
    cos_b = _f32(0.0, 1e-7, 1e-6, 0.01, gs.TAU_COS, 0.2, 0.9, 1.0)
    port = _grad_torch(gs.stable_recip_cos, cos_b)
    _assert_same(port, _grad_jax(jgs.stable_recip_cos, cos_b))
    free = cos_b > gs.TAU_COS
    np.testing.assert_array_equal(port[0][free], np.float32(1) / cos_b[free])
    assert port[1][0][cos_b == np.float32(gs.TAU_COS)][0] == pytest.approx(
        0.5 * -1.0 / np.float32(gs.TAU_COS) ** 2, rel=1e-6)


def test_value_with_stable_grad_and_cosine_ratio():
    x = _f32(0.3, 1.5, -2.0)
    y = _f32(0.7, 0.2, 0.9)
    _assert_same(_grad_torch(lambda a, b: gs.value_with_stable_grad(a * a, a * b), x, y),
                 _grad_jax(lambda a, b: jgs.value_with_stable_grad(a * a, a * b), x, y))
    port = _grad_torch(gs.cosine_ratio, x, y)
    _assert_same(port, _grad_jax(jgs.cosine_ratio, x, y))
    assert all((g == 0).all() for g in port[1])


def test_clip_gradient_is_jax_tie_rule():
    """jnp.clip gives 0.5 at either bound (torch.clamp would give 1): the
    default Oren-Nayar roughness 1.0 sits on the upper bound."""
    x = _f32(-0.5, 0.0, 0.5, 1.0, 1.5)
    port = _grad_torch(lambda a: gs.clip(a, 0.0, 1.0), x)
    ref = _grad_jax(lambda a: jnp.clip(a, 0.0, 1.0), x)
    _assert_same(port, ref)
    assert port[1][0].tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]
    # maximum / minimum split a tie the same way
    _assert_same(_grad_torch(lambda a, b: gs.maximum(a, b), x, x),
                 _grad_jax(jnp.maximum, x, x))
    _assert_same(_grad_torch(lambda a: gs.minimum(a, 0.5), x),
                 _grad_jax(lambda a: jnp.minimum(a, 0.5), x))
