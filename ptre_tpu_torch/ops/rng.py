"""Counter-based Philox4x32-10 RNG, bit-identical to `csrc/philox.cuh`.

Replaces the TPU hardware PRNG of the fused render kernel
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

import torch

_MASK = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = ROUNDS):
    """Philox4x32-R block (Salmon et al., SC'11; Random123's
    ``philox4x32_R``). Counter words are int64 tensors (broadcastable) with
    values in [0, 2**32); key words are Python ints. Returns four int64
    tensors of 32-bit words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0 &= _MASK
    k1 &= _MASK
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK
            k1 = (k1 + PHILOX_W1) & _MASK
        p0 = c0 * PHILOX_M0
        p1 = c2 * PHILOX_M1
        hi0 = (p0 >> 32) & _MASK
        hi1 = (p1 >> 32) & _MASK
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0, p1 & _MASK,
                          hi0 ^ c3 ^ k1, p0 & _MASK)
    return c0, c1, c2, c3


def u01(words):
    """32-bit words → float32 uniforms in [0, 1): ``(w >> 8) * 2**-24``."""
    return (words >> 8).to(torch.float32) * (2.0 ** -24)


def ray_uniforms(seed: int, sample: int, n_rays: int, n_pairs: int,
                 device=None):
    """(2 * n_pairs, n_rays) uniforms: rows 2k and 2k+1 are draw pair k of
    each ray (pixel), keyed by (seed, ray, sample, k) as the kernels key
    them. ``n_pairs = 1`` gives only the pixel jitter (+0.5)."""
    pix = torch.arange(n_rays, dtype=torch.int64, device=device)
    smp = torch.tensor(sample & _MASK, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    rows = []
    for block in range((n_pairs + 1) // 2):
        blk = torch.tensor(block, dtype=torch.int64, device=device)
        words = philox4x32(pix, smp, blk, zero, seed & _MASK, seed >> 32)
        rows.extend(words)
    return torch.stack([u01(w) for w in rows[: 2 * n_pairs]])


def render_uniforms(seed: int, sample: int, height: int, width: int,
                    max_depth: int, device=None):
    """The (2 + 2*max_depth, H, W) uniforms the render kernel draws in-kernel
    for one sample: rows 0-1 are the pixel jitter (+0.5), rows 2b+2 and
    2b+3 bounce b's scatter pair — the layout of the external ``urand``."""
    return ray_uniforms(seed, sample, height * width, 1 + max_depth,
                        device).reshape(2 + 2 * max_depth, height, width)
