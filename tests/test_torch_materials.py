"""`ptre_tpu_torch/ops/materials.py` against `ptre_tpu/ops/materials.py`.

Both sides draw the same uniforms: JAX's ``scatter`` from a threefry key,
the port's from the twin of that key (`rng.cosine_uniforms`, bit-equal,
`test_torch_threefry.py`). Inputs cover every branch: Oren–Nayar with the
roughness below, on and above clip's bounds (the default 1.0 sits on the
upper one: JAX gives half the gradient there), emissive rows, and normals
scaled down to 1e-6 so that pdf < pdf_eps takes the degenerate fallback.

Tolerance: values within 2e-6 relative (1e-6 absolute): the same float32
formulas; the ONB's cross products and cos/sin round differently (XLA
contracts FMAs, other libm), a few ulp. Gradients within 1e-4 relative of
``jax.grad`` (atol 1e-5 of the largest entry).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.ops import materials as jmat
from ptre_tpu.ops import rng as jrng
from ptre_tpu_torch.ops import materials, rng

N = 256


def _batch(seed):
    rs = np.random.default_rng(seed)
    n = rs.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8] *= np.float32(1e-6)  # degenerate pdf: n.wi / pi < pdf_eps
    n[8:12] = [[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0, -1]]  # poles of the azimuths
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * n, axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    d[12] = [0, 0, -1]
    p = rs.normal(size=(N, 3)).astype(np.float32)
    kind = (rs.random(N) < 0.2).astype(np.int32)
    albedo = rs.uniform(0, 1, (N, 3)).astype(np.float32)
    param = rs.choice(np.array([0.0, 0.3, 1.0, 1.0, 1.4], np.float32), N)
    return dict(d=d, p=p, n=n, kind=kind, albedo=albedo, param=param)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_values_and_gradients_match_jax(seed):
    b = _batch(seed)
    jkey = jrng.fold(jrng.key_for(seed), 3)
    u1, u2 = rng.cosine_uniforms(rng.fold(rng.key_for(seed), 3), (N,), device="cpu")
    rs = np.random.default_rng(seed + 10)
    w = [rs.normal(size=(N, 3)).astype(np.float32) for _ in range(3)] + [
        rs.normal(size=N).astype(np.float32) for _ in range(2)]
    diff = ("d", "p", "n", "albedo", "param")

    def j_out(d, p, n, albedo, param):
        return jmat.scatter(jkey, d, p, n, jnp.asarray(b["kind"]), albedo, param)

    def t_out(d, p, n, albedo, param):
        return materials.scatter(u1, u2, d, p, n, torch.from_numpy(b["kind"]), albedo, param)

    def fields(r):
        return (r.attenuation, r.next_dir, r.next_origin, r.pdf, r.cos_weight)

    jr = j_out(*(jnp.asarray(b[k]) for k in diff))
    targs = [torch.from_numpy(b[k]).requires_grad_(True) for k in diff]
    tr = t_out(*targs)
    for a, c in zip(fields(jr), fields(tr)):
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(a), rtol=2e-6, atol=1e-6)
    assert np.array_equal(tr.terminated.numpy(), np.asarray(jr.terminated))
    degen = np.asarray(jr.pdf)[:8]
    assert np.allclose(degen[b["kind"][:8] == 0], 1.0 / np.pi)  # the fallback ran

    def j_loss(*args):
        return sum(jnp.sum(f * wi) for f, wi in zip(fields(j_out(*args)), w))

    jg = jax.grad(j_loss, argnums=tuple(range(5)))(*(jnp.asarray(b[k]) for k in diff))
    tg = torch.autograd.grad(sum(torch.sum(f * torch.from_numpy(wi))
                                 for f, wi in zip(fields(tr), w)), targs)
    for k, a, c in zip(diff, jg, tg):
        a = np.asarray(a)
        np.testing.assert_allclose(c.numpy(), a, rtol=1e-4, atol=1e-5 * np.abs(a).max(),
                                   err_msg=k)
    on_bound = (b["param"] == 1.0) & (b["kind"] == 0)
    assert on_bound.any() and np.abs(tg[4].numpy()[on_bound]).max() > 0


def test_emitted_and_sky_match_jax():
    b = _batch(2)
    got = materials.emitted(torch.from_numpy(b["kind"]), torch.from_numpy(b["albedo"]),
                            torch.from_numpy(b["param"]))
    want = jmat.emitted(jnp.asarray(b["kind"]), jnp.asarray(b["albedo"]), jnp.asarray(b["param"]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    bottom, top = np.float32([1.0, 0.9, 0.8]), np.float32([0.5, 0.7, 1.0])
    got = materials.sky_attenuation(torch.from_numpy(b["d"]), torch.from_numpy(bottom),
                                    torch.from_numpy(top))
    want = jmat.sky_attenuation(jnp.asarray(b["d"]), bottom, top)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1.2e-7)
