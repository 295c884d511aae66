"""The port's threefry2x32 twin (`ptre_tpu_torch/ops/rng.py`) against
`jax.random` (``jax_threefry_partitionable=True``, this suite's default).

Exact: keys (``key_for``, ``fold``, ``split``), random bits, ``uniform`` for
any [minval, maxval), ``uint`` and ``pixel_jitter`` — bit for bit. XLA
contracts uniform's ``floats * span + minval`` into one fused multiply-add
on the CPU; the twin reproduces that single rounding.

Within 2 ulp of values of magnitude <= 1 (2.4e-7): the distributions built
on those uniforms (``cosine_weighted``, ``on_unit_sphere``,
``on_unit_hemisphere``) and ``onb_from_normal``. Their inputs are
bit-equal; cos/sin come from other libraries (XLA's against PyTorch's
vectorised kernels), and XLA contracts the cross products' a*b - c*d into
FMAs where the port rounds each product (as the sweep kernel, built without
contraction, does).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.ops import rng as jrng
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.utils import interop

SEEDS = (0, 1, 3, 1984, 2**31 - 1, -5)
ULP2 = 2.4e-7


def _words(jkey):
    a = np.asarray(jkey)
    return (int(a[0]), int(a[1]))


def test_partitionable_threefry_is_this_suites_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_and_split_are_bit_equal(seed):
    k = rng.key_for(seed)
    assert _words(jrng.key_for(seed)) == (k.k0, k.k1)
    for ids in ((0,), (7, 0x9E37), (2**32 - 1, 5, 1)):
        f = rng.fold(k, *ids)
        assert _words(jrng.fold(jrng.key_for(seed), *ids)) == (f.k0, f.k1)
    for num in (2, 3):
        want = np.asarray(jax.random.split(jrng.key_for(seed), num))
        assert [tuple(map(int, w)) for w in want] == [(s.k0, s.k1) for s in rng.split(k, num)]
    assert interop.key_from_jax(np.asarray(jrng.fold(jrng.key_for(seed), 9))) == rng.fold(k, 9)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((7,), 0.0, 1.0), ((3, 5), -0.5, 0.5),
                                         ((13,), 0.0, 2.0 * np.pi), ((4, 3), -1.0, 1.0),
                                         ((257,), 2.5, 7.25), ((33,), -3.3, 1000.0)])
def test_uniform_is_bit_equal(seed, shape, lo, hi):
    jk = jrng.fold(jrng.key_for(seed), 5)
    want = np.asarray(jrng.uniform(jk, shape, lo, hi))
    got = rng.uniform(rng.fold(rng.key_for(seed), 5), shape, lo, hi, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= np.float32(lo) and got.max() < np.float32(hi)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uint_and_pixel_jitter_are_bit_equal(seed):
    jk, k = jrng.key_for(seed), rng.key_for(seed)
    for lo, hi in ((0, 2**31 - 2), (3, 1000), (0, 0), (7, 8)):
        want = np.asarray(jrng.uint(jk, (11,), lo, hi)).astype(np.int64)
        assert np.array_equal(rng.uint(k, (11,), lo, hi, device="cpu").numpy(), want)
    want = np.asarray(jrng.pixel_jitter(jrng.fold(jk, 0x9E37), (37,)))
    got = rng.pixel_jitter(rng.fold(k, 0x9E37), (37,), device="cpu").numpy()
    assert got.shape == (37, 2) and np.array_equal(got, want)
    with pytest.raises(ValueError, match="uint takes"):
        rng.uint(k, (2,), 5, 4, device="cpu")


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_distributions_within_two_ulp(seed):
    jk, k = jrng.fold(jrng.key_for(seed), 11), rng.fold(rng.key_for(seed), 11)
    n = 2000
    cos_w = rng.cosine_weighted(k, (n,), device="cpu").numpy()
    np.testing.assert_allclose(cos_w, np.asarray(jrng.cosine_weighted(jk, (n,))),
                               rtol=0, atol=ULP2)
    assert cos_w[:, 2].min() >= 0.0
    u1, u2 = rng.cosine_uniforms(k, (n,), device="cpu")
    assert torch.equal(rng.cosine_from_uniforms(u1, u2), torch.from_numpy(cos_w))
    sph = rng.on_unit_sphere(k, (n,), device="cpu").numpy()
    np.testing.assert_allclose(sph, np.asarray(jrng.on_unit_sphere(jk, (n,))),
                               rtol=0, atol=ULP2)
    normal = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    hemi = rng.on_unit_hemisphere(k, torch.from_numpy(normal)).numpy()
    np.testing.assert_allclose(hemi, np.asarray(jrng.on_unit_hemisphere(jk, jnp.asarray(normal))),
                               rtol=0, atol=ULP2)
    assert (np.sum(hemi * normal, axis=-1) >= -1e-6).all()


def test_onb_from_normal_both_branches():
    n = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    n[:6] = [[1, 0, 0], [0.95, 0.1, 0], [0, 0, 0], [0, 1, 0], [-0.91, 0.3, 0.2],
             [0.3, 0.2, -0.9]]
    got = rng.onb_from_normal(torch.from_numpy(n)).numpy()
    want = np.asarray(jrng.onb_from_normal(jnp.asarray(n)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP2)
    w = got[:, 2]
    big_x = np.abs(w[:, 0]) > 0.9
    assert big_x.sum() >= 3 and (~big_x).sum() >= 3  # both helper axes taken
    assert np.array_equal(got[2], np.zeros((3, 3), np.float32))  # zero normal
    ok = np.linalg.norm(n, axis=1) > 0
    eye = np.einsum("rij,rkj->rik", got[ok], got[ok])
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
