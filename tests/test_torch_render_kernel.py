"""The render kernel's plain PyTorch version vs the JAX render kernel itself.

`ptre_tpu_torch.ops.cuda.render_kernel.sample_accum_reference` against
`ptre_tpu.ops.pallas.render_kernel.sample_accum_fused(..., interpret=True)`
on the same numpy-made uniforms and history: the whole sample — jitter,
closed-form ray, dense bounce loop, clamp, running average. Tolerance
rtol = atol = 2e-5, the bound `tests/test_render_kernel.py` holds the JAX
kernel to. One interpret-mode compile serves every case (same shapes).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops.pallas import render_kernel as jrk
from ptre_tpu.utils.config import RenderConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk

W, H = 128, 8
CFG = RenderConfig(width=W, height=H, max_depth=3)
ROWS = 2 + 2 * CFG.max_depth


@pytest.fixture(scope="module")
def scenes():
    torch.set_num_threads(1)
    jp = jdemo.reference_demo_scene(8, 4).build_packet()
    jc = jcam.Camera.create(width=W, height=H)
    tp = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    tc = cam_ops.Camera.create(width=W, height=H, device="cpu")
    return jp, jc, mk.pack_scene(tp), rk.camera_rows(tc)


def _history(kind, rs):
    if kind == "zeros":
        return np.zeros((H, W, 3), np.float32)
    if kind == "linspace":
        return np.linspace(0.0, 1.0, 3 * H * W, dtype=np.float32).reshape(H, W, 3)
    return rs.random((H, W, 3), dtype=np.float32)


def _both(scenes, prev, urand, n):
    jp, jc, scene, rows = scenes
    want = jrk.sample_accum_fused(
        0, jp, jc, jnp.asarray(prev.transpose(2, 0, 1)), float(n), CFG,
        urand=jnp.asarray(urand), interpret=True)
    want = np.asarray(want).transpose(1, 2, 0)
    got = rk.sample_accum_reference(torch.from_numpy(prev), scene, rows, n, CFG,
                                    urand=torch.from_numpy(urand)).numpy()
    return got, want


@pytest.mark.parametrize("kind,n,seed", [
    ("zeros", 1, 0), ("random", 3, 1), ("linspace", 7, 2), ("random", 64, 3),
])
def test_plain_version_matches_jax_render_kernel(scenes, kind, n, seed):
    rs = np.random.default_rng(seed)
    prev = _history(kind, rs)
    urand = rs.random((ROWS, H, W), dtype=np.float32)
    got, want = _both(scenes, prev, urand, n)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if kind == "zeros":  # n = 1 overwrites history with one clamped sample
        assert got.min() >= 0.0 and got.max() <= 1.0 and got.max() > 0.05


def test_philox_draws_through_jax_render_kernel(scenes):
    # the port's in-kernel Philox uniforms, handed to the JAX kernel as its
    # external urand, give the image the port renders with urand=None
    _, _, scene, rows = scenes
    prev = _history("random", np.random.default_rng(4))
    seed, n = 0xC0FFEE, 2
    urand = rng.render_uniforms(seed, n, H, W, CFG.max_depth, device="cpu").numpy()
    _, want = _both(scenes, prev, urand, n)
    got = rk.sample_accum_reference(torch.from_numpy(prev), scene, rows, n, CFG,
                                    seed=seed).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
