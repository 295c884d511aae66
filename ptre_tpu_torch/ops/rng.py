"""Counter-based RNGs: Philox4x32-10, bit-identical to `csrc/philox.cuh`,
the generator of every kernel; and threefry2x32, a bit-exact twin of
`jax.random` for the staged route's JAX-keyed mode (end of the module).

Philox replaces the TPU hardware PRNG of the fused render kernel
(`ptre_tpu/ops/pallas/render_kernel.py:111-128`, mapped by
`megakernel._u01` at `megakernel.py:226`). The TPU streams cannot be
reproduced off the TPU; this generator is the port's own, and the plain
PyTorch version draws exactly the bits the CUDA kernel draws, so the two
can be compared pixel for pixel.

Every draw is keyed by (seed, pixel, sample, draw index), never by launch or
thread order: an image is deterministic per seed, and a dead path's skipped
draws change nothing.

Layout of the render draws (shared with `csrc/philox.cuh`):
  * key = (seed & 0xffffffff, seed >> 32);
  * draw pair k (k = 0 is the pixel jitter, k = 1 + b is bounce b's
    scatter pair) comes from the Philox block with counter
    (pixel, sample, k >> 1, 0): words 0-1 when k is even, words 2-3 when odd;
  * a 32-bit word maps to [0, 1) as ``(word >> 8) * 2**-24`` — exact in
    float32, so both sides produce the same floats.

Torch has no uint32 arithmetic, so words live in int64. The product of two
values below 2**32 wraps mod 2**64 in int64, and ``(p >> 32) & 0xffffffff``
still extracts its high word.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.utils.device import resolve

_MASK = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = ROUNDS):
    """Philox4x32-R block (Salmon et al., SC'11; Random123's
    ``philox4x32_R``). Counter words are int64 tensors (broadcastable) with
    values in [0, 2**32); key words are Python ints, or int64 tensors that
    broadcast with the counters (a key for each of several samples).
    Returns four int64 tensors of 32-bit words.

    A round's low product words are carried unmasked: each is used once,
    XORed into a word that is masked there, so only that word and the last
    round's low words take a mask."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0 = _round_keys(k0, PHILOX_W0, rounds)
    k1 = _round_keys(k1, PHILOX_W1, rounds)
    for r in range(rounds):
        p0 = c0 * PHILOX_M0
        p1 = c2 * PHILOX_M1
        c0, c1, c2, c3 = (((p1 >> 32) ^ c1 ^ k0[r]) & _MASK, p1,
                          ((p0 >> 32) ^ c3 ^ k1[r]) & _MASK, p0)
    return c0, c1 & _MASK, c2, c3 & _MASK


def _round_keys(k, w: int, rounds: int):
    """Key word ``k`` of each round, (k + r * w) mod 2**32: Python ints, or
    for a tensor one (rounds, *k.shape) tensor made in a few operations."""
    if isinstance(k, int):
        return [(k + r * w) & _MASK for r in range(rounds)]
    r = torch.arange(rounds, dtype=torch.int64, device=k.device).view(-1, *(1,) * k.dim())
    return (k + r * w) & _MASK


def _word(v: int, device):
    """A 0-d int64 counter word on ``device``, filled there (no host copy)."""
    return torch.full((), v & _MASK, dtype=torch.int64, device=device)


def u01(words):
    """32-bit words → float32 uniforms in [0, 1): ``(w >> 8) * 2**-24``."""
    return (words >> 8).to(torch.float32) * (2.0 ** -24)


def ray_uniforms(seed: int, sample: int, n_rays: int, n_pairs: int,
                 device=None):
    """(2 * n_pairs, n_rays) uniforms: rows 2k and 2k+1 are draw pair k of
    each ray (pixel), keyed by (seed, ray, sample, k) as the kernels key
    them. ``n_pairs = 1`` gives only the pixel jitter (+0.5). ``device``:
    None means the card (RendererError where there is none)."""
    device = resolve(device)
    pix = torch.arange(n_rays, dtype=torch.int64, device=device)
    smp = _word(sample, device)
    zero = _word(0, device)
    rows = []
    for block in range((n_pairs + 1) // 2):
        words = philox4x32(pix, smp, _word(block, device), zero, seed & _MASK, seed >> 32)
        rows.extend(words)
    return torch.stack([u01(w) for w in rows[: 2 * n_pairs]])


def sample_jitters(seeds, first: int, n_rays: int, device=None):
    """(len(seeds), 2, n_rays) float32: the pixel jitter (+0.5) of the
    consecutive samples ``first``, ``first + 1``, ..., sample ``first + s``
    keyed by ``seeds[s]``. Row s equals ``ray_uniforms(seeds[s], first + s,
    n_rays, 1)`` bit for bit; all the samples are drawn in one pass.
    ``device``: None means the card."""
    device = resolve(device)
    pix = torch.arange(n_rays, dtype=torch.int64, device=device)
    smp = torch.arange(first, first + len(seeds), dtype=torch.int64, device=device) & _MASK
    zero = _word(0, device)

    def keys(words):
        return torch.stack([_word(w, device) for w in words])[:, None]

    words = philox4x32(pix, smp[:, None], zero, zero, keys(seeds),
                       keys([s >> 32 for s in seeds]))
    return torch.stack([u01(words[0]), u01(words[1])], dim=1)


def pair_uniforms(seed: int, sample: int, ids, k: int):
    """Draw pair k, (u1, u2), of the rays numbered ``ids`` (an int tensor on
    any device): the bits `ray_uniforms` gives in rows 2k and 2k+1 of those
    columns, which the wavefront kernel regenerates from a ray's id."""
    ray = ids.to(torch.int64)
    smp = _word(sample, ray.device)
    w = philox4x32(ray, smp, _word(k >> 1, ray.device), torch.zeros_like(smp),
                   seed & _MASK, seed >> 32)
    return (u01(w[2]), u01(w[3])) if k & 1 else (u01(w[0]), u01(w[1]))


def render_uniforms(seed: int, sample: int, height: int, width: int,
                    max_depth: int, device=None):
    """The (2 + 2*max_depth, H, W) uniforms the render kernel draws in-kernel
    for one sample: rows 0-1 are the pixel jitter (+0.5), rows 2b+2 and
    2b+3 bounce b's scatter pair — the layout of the external ``urand``.
    ``device``: None means the card."""
    return ray_uniforms(seed, sample, height * width, 1 + max_depth,
                        device).reshape(2 + 2 * max_depth, height, width)


# ---- threefry2x32: a bit-exact twin of jax.random ---------------------------
#
# The staged route's JAX-keyed mode (`ptre_tpu/ops/rng.py:26-107`). JAX's
# default PRNG with ``jax_threefry_partitionable=True``: a key is two 32-bit
# words; ``fold_in``, ``split`` and the random bits are each one threefry2x32
# hash of a (hi, lo) counter pair. Keys are small host values (`Key`, Python
# ints), so deriving one never touches a device; only the random bits of a
# tensor are hashed on the caller's device, in int64 with masks like Philox.

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


@dataclasses.dataclass(frozen=True)
class Key:
    """A threefry2x32 key, ``jax.random.PRNGKey``'s two uint32 words."""

    k0: int
    k1: int


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11), as JAX lowers it
    (`jax/_src/prng.py` ``_threefry2x32_lowering``). Works on Python ints
    and on int64 tensors of 32-bit words alike; returns the two words."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _THREEFRY_PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key_for(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the high and low words of the seed (a
    negative 32-bit seed is its two's complement, high word 0)."""
    seed = int(seed)
    if seed < 0:
        return Key(0, seed & _MASK)
    return Key((seed >> 32) & _MASK, seed & _MASK)


def fold(key: Key, *ids) -> Key:
    """Fold integer identifiers into a key, one ``jax.random.fold_in`` each."""
    for i in ids:
        key = Key(*threefry2x32(key.k0, key.k1, 0, int(i) & _MASK))
    return key


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)`` as a tuple of keys."""
    return tuple(Key(*threefry2x32(key.k0, key.k1, 0, i)) for i in range(num))


def random_bits(key: Key, shape, device=None):
    """32 random bits per element of ``shape`` (int64 tensor): the hash of
    the element's row-major index as a (hi, lo) counter, the two output
    words xor-ed (``_threefry_random_bits_partitionable``). ``device``:
    None means the card (RendererError where there is none), as for every
    draw below."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=resolve(device))
    b0, b1 = threefry2x32(key.k0, key.k1, idx >> 32, idx & _MASK)
    return (b0 ^ b1).reshape(tuple(shape))


def _f32(x) -> float:
    return float(np.float32(x))


def uniform(key: Key, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device=None):
    """``jax.random.uniform``: float32 in [minval, maxval). The top 23 bits
    become the mantissa of a float in [1, 2); minus 1, times (maxval -
    minval), plus minval, floored at minval. XLA contracts the multiply and
    add into one fused multiply-add: the float64 product (exact) and sum,
    rounded once to float32, reproduce it."""
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(lo))
    mant = (random_bits(key, shape, device) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def uint(key: Key, shape=(), minval: int = 0, maxval: int = 2**31 - 1,
         device=None):
    """``jax.random.randint(key, shape, minval, maxval + 1, uint32)``:
    integers in [minval, maxval] (int64 tensor), the reference's inclusive
    `random::uint`. JAX's two-word remainder scheme, in wrapped uint32
    arithmetic."""
    k1, k2 = split(key)
    return _uint_of_bits(random_bits(k1, shape, device), random_bits(k2, shape, device),
                         minval, maxval)


def uint_scalar(key: Key, minval: int = 0, maxval: int = 2**31 - 1) -> int:
    """``uint(key, (), minval, maxval)`` as a Python int, hashed on Python
    ints: no tensor, so a per-frame seed costs microseconds on the host."""
    k1, k2 = split(key)
    return _uint_of_bits(*(k.k0 ^ k.k1 for k in (Key(*threefry2x32(k1.k0, k1.k1, 0, 0)),
                                                  Key(*threefry2x32(k2.k0, k2.k1, 0, 0)))),
                         minval, maxval)


def _uint_of_bits(higher, lower, minval: int, maxval: int):
    """JAX's two-word remainder scheme on two draws of 32 random bits (ints
    or int64 tensors), in wrapped uint32 arithmetic."""
    if not 0 <= minval <= maxval < _MASK:
        raise ValueError(f"uint takes 0 <= minval <= maxval < 2**32 - 1, got "
                         f"[{minval}, {maxval}]")
    span = maxval + 1 - minval
    mult = (((2**16 % span) ** 2) & _MASK) % span
    off = (((higher % span) * mult) & _MASK) + lower % span
    return minval + (off & _MASK) % span


def pixel_jitter(key: Key, shape, device=None):
    """Sub-pixel jitter in [-0.5, 0.5), (*shape, 2) (`camera.cu:24-25`)."""
    return uniform(key, tuple(shape) + (2,), -0.5, 0.5, device)


def on_unit_sphere(key: Key, shape=(), device=None):
    """Uniform direction on the unit sphere (`random.cu:72-84`): azimuth
    uniform in [0, tau), z uniform in [-1, 1); (*shape, 3)."""
    k1, k2 = split(key)
    phi = uniform(k1, shape, 0.0, 2.0 * math.pi, device)
    z = uniform(k2, shape, -1.0, 1.0, device)
    sin_theta = torch.sqrt(1.0 - z * z)
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), z],
                       dim=-1)


def on_unit_hemisphere(key: Key, normal):
    """Uniform direction on the hemisphere around ``normal`` (`random.cu:86-94`)."""
    d = on_unit_sphere(key, normal.shape[:-1], normal.device)
    flip = torch.sum(d * normal, dim=-1, keepdim=True) > 0.0
    return torch.where(flip, d, -d)


def cosine_from_uniforms(u1, u2):
    """Cosine-weighted hemisphere direction, local z-up, from two uniforms
    (`random.cu:96-107`): phi = tau u1, (x, y) = (cos phi, sin phi) sqrt(u2),
    z = sqrt(1 - u2)."""
    phi = _f32(2.0 * math.pi) * u1
    r = torch.sqrt(u2)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, torch.sqrt(1.0 - u2)],
                       dim=-1)


def cosine_uniforms(key: Key, shape=(), device=None):
    """The two uniforms `cosine_weighted` draws, from ``split(key)``."""
    k1, k2 = split(key)
    return uniform(k1, shape, device=device), uniform(k2, shape, device=device)


def cosine_weighted(key: Key, shape=(), device=None):
    """Cosine-weighted hemisphere sample, local z-up, (*shape, 3)."""
    return cosine_from_uniforms(*cosine_uniforms(key, shape, device))


def onb_from_normal(n):
    """Orthonormal basis with w = normalize(n) (`onb.h:7-12`), as a (..., 3,
    3) matrix whose ROWS are (u, v, w). The helper axis is y where |w.x| >
    0.9, else x, as in the reference."""
    len_sq = torch.sum(n * n, dim=-1, keepdim=True)
    pos = len_sq > 0
    w = n * torch.where(pos, torch.rsqrt(torch.where(pos, len_sq, torch.ones_like(len_sq))),
                        torch.zeros_like(len_sq))
    big_x = (torch.abs(w[..., 0]) > 0.9)[..., None]
    zero, one = torch.zeros_like(w[..., :1]), torch.ones_like(w[..., :1])
    a = torch.where(big_x, torch.cat([zero, one, zero], dim=-1),
                    torch.cat([one, zero, zero], dim=-1))  # no host-made axes
    v = vm.cross(w, a)
    v_len = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    v = v / torch.where(v_len > 0, v_len, torch.ones_like(v_len))
    u = vm.cross(v, w)
    return torch.stack([u, v, w], dim=-2)
