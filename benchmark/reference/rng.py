"""Frozen random-number arithmetic of the benchmark's reference.

A copy of the draws the program under test is documented to make, kept here
so that a later change to the program cannot move the yardstick:

* Philox4x32-10 (Salmon et al., SC'11): draw pair k of ray ``r`` in sample
  ``n`` under seed ``s`` comes from the block with counter (r, n, k >> 1, 0)
  and key (s & 0xffffffff, s >> 32), words 0-1 for even k and 2-3 for odd k;
  a word maps to [0, 1) as ``(word >> 8) * 2**-24``. Pair 0 is the pixel
  jitter (+0.5), pair 1 + b bounce b's scatter pair.
* threefry2x32 with JAX's ``fold_in`` / ``split`` / ``randint`` on Python
  ints: the frame keys of the interactive renderer and the seed it derives
  from a key.
* the per-sample seeds a step draws from ``torch.Generator`` seeded with the
  step's int seed.

Words live in int64 tensors (torch has no uint32 arithmetic); a product of
two values below 2**32 wraps mod 2**64 and its high word is still exact.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """One Philox4x32-10 block on int64 counter words (broadcast)."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0 &= MASK
    k1 &= MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK
            k1 = (k1 + _W1) & MASK
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & MASK) ^ c1 ^ k0, p1 & MASK,
                          ((p0 >> 32) & MASK) ^ c3 ^ k1, p0 & MASK)
    return c0, c1, c2, c3


def pair(seed: int, sample: int, rays, k: int):
    """Draw pair k, (u1, u2) float32, of the rays numbered ``rays`` (int64)."""
    dev = rays.device
    smp = torch.full((), sample & MASK, dtype=torch.int64, device=dev)
    blk = torch.full((), (k >> 1) & MASK, dtype=torch.int64, device=dev)
    w = philox4x32(rays, smp, blk, torch.zeros_like(smp), seed & MASK, seed >> 32)
    a, b = (w[2], w[3]) if k & 1 else (w[0], w[1])
    return ((a >> 8).to(torch.float32) * 2.0 ** -24,
            (b >> 8).to(torch.float32) * 2.0 ** -24)


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: int, x1: int):
    """Threefry-2x32, 20 rounds, on Python ints."""
    ks = (k0 & MASK, k1 & MASK, (k0 ^ k1 ^ 0x1BD11BDA) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key_for(seed: int):
    """``jax.random.PRNGKey(seed)`` as a pair of words."""
    seed = int(seed)
    if seed < 0:
        return (0, seed & MASK)
    return ((seed >> 32) & MASK, seed & MASK)


def fold(key, *ids):
    for i in ids:
        key = threefry2x32(key[0], key[1], 0, int(i) & MASK)
    return key


def _split(key):
    return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(2))


def uint_scalar(key, maxval: int) -> int:
    """``randint(key, (), 0, maxval + 1)`` with JAX's two-word remainder
    scheme: an int in [0, maxval]."""
    k1, k2 = _split(key)
    hi, lo = (a ^ b for a, b in (threefry2x32(k1[0], k1[1], 0, 0),
                                 threefry2x32(k2[0], k2[1], 0, 0)))
    span = maxval + 1
    mult = (((2**16 % span) ** 2) & MASK) % span
    off = (((hi % span) * mult) & MASK) + lo % span
    return (off & MASK) % span


def frame_seed(seed: int, frame: int) -> int:
    """The int seed of frame ``frame`` of a renderer seeded ``seed``: its key
    ``fold(key_for(seed), frame)``, then ``randint(fold(key, 0x5EED), (), 0,
    2**31 - 1)``, as the reference path tracer draws its fused seed."""
    return uint_scalar(fold(fold(key_for(seed), frame), 0x5EED), 2**31 - 2)


def sample_seeds(step_seed: int, spp: int):
    """The int seeds of a step's ``spp`` samples: ``randint(0, 2**31 - 1)``
    draws from a CPU ``torch.Generator`` seeded with the step's seed."""
    gen = torch.Generator().manual_seed(int(step_seed))
    return [int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item()) for _ in range(spp)]
