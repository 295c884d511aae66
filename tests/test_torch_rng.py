"""The port's Philox4x32-10 (`ptre_tpu_torch/ops/rng.py`).

Known-answer vectors: Random123 1.09 (D. E. Shaw Research),
``examples/kat_vectors``, the three ``philox4x32 10`` lines — counter,
key, expected output, all 32-bit words in hex.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ptre_tpu_torch.ops import rng

KAT = [
    ((0x00000000, 0x00000000, 0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_philox_known_answers(ctr, key, expected):
    out = rng.philox4x32(*[torch.tensor(c, dtype=torch.int64) for c in ctr], *key)
    assert [int(w) for w in out] == list(expected)


def test_philox_vectorised_matches_scalar():
    # a batch of counters gives, word for word, the per-counter results
    pix = torch.arange(17, dtype=torch.int64)
    words = rng.philox4x32(pix, torch.tensor(3), torch.tensor(1), torch.tensor(0),
                           0x1234, 0x5678)
    for i in (0, 7, 16):
        one = rng.philox4x32(torch.tensor(i), torch.tensor(3), torch.tensor(1),
                             torch.tensor(0), 0x1234, 0x5678)
        assert [int(w[i]) for w in words] == [int(w) for w in one]


def test_u01_range_and_exactness():
    w = torch.tensor([0, 255, 256, 0x7FFFFFFF, 0xFFFFFFFF], dtype=torch.int64)
    u = rng.u01(w)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # exact: (w >> 8) * 2**-24
    assert u.tolist() == [0.0, 0.0, 2.0**-24, (0x7FFFFFFF >> 8) * 2.0**-24,
                          1.0 - 2.0**-24]


def test_uniform_statistics():
    # 1e6 draws: mean 1/2 and variance 1/12; the standard error of the mean
    # is 2.9e-4 and of the variance 7.5e-5, so 2e-3 is a > 6-sigma bound
    torch.set_num_threads(1)
    ctr = torch.arange(250_000, dtype=torch.int64)
    z = torch.zeros((), dtype=torch.int64)
    words = torch.cat(rng.philox4x32(ctr, z + 7, z, z, 1984, 0))
    u = rng.u01(words).double()
    assert u.numel() == 1_000_000
    assert abs(float(u.mean()) - 0.5) < 2e-3
    assert abs(float(u.var()) - 1.0 / 12.0) < 2e-3
    # no gross bin bias: 10 bins, each within 2 % of 1e5
    hist = torch.histc(u.float(), bins=10, min=0.0, max=1.0)
    assert float((hist - 1e5).abs().max()) < 2e3


def test_render_uniforms_layout_and_determinism():
    H, W, B, seed, sample = 3, 5, 3, (7 << 32) | 99, 4
    u = rng.render_uniforms(seed, sample, H, W, B)
    assert u.shape == (2 + 2 * B, H, W)
    pix = torch.arange(H * W, dtype=torch.int64)
    for k in range(1 + B):  # draw pair k: block k >> 1, words 0-1 or 2-3
        blk = rng.philox4x32(pix, torch.tensor(sample), torch.tensor(k >> 1),
                             torch.tensor(0), seed & 0xFFFFFFFF, seed >> 32)
        w = 2 * (k & 1)
        assert torch.equal(u[2 * k].reshape(-1), rng.u01(blk[w]))
        assert torch.equal(u[2 * k + 1].reshape(-1), rng.u01(blk[w + 1]))
    assert torch.equal(u, rng.render_uniforms(seed, sample, H, W, B))
    assert not torch.equal(u, rng.render_uniforms(seed + 1, sample, H, W, B))
    assert not torch.equal(u, rng.render_uniforms(seed, sample + 1, H, W, B))
    # fewer bounces draw a prefix of the same uniforms
    assert torch.equal(rng.render_uniforms(seed, sample, H, W, 1), u[:4])
    assert np.all(np.isfinite(u.numpy()))
