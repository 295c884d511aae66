"""The CUDA render kernel on the card vs its plain PyTorch version.

Marked ``cuda``: each test skips where torch sees no CUDA device (the check
runs inside a fixture, never at import). On a machine with the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which that machine
need not have.) Tolerance, as in chip_smoke.py: the kernel contracts a*b+c
into FMAs inside the bounce loop, so a grazing ray can take another
primitive: >= 99.9 % of channels within 1e-4, and channels beyond 0.05 (a
flipped path) on at most 1e-5 of the pixels, rounded up.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ptre_tpu.utils.config import RenderConfig
from ptre_tpu.utils.errors import RendererError
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.render import pathtracer as pt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _setup(dev, W, H, max_depth=5):
    cfg = RenderConfig(width=W, height=H, max_depth=max_depth)
    packed = mk.pack_scene(demo.reference_demo_scene(16, 8).build_packet().to(dev))
    rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H))
    prev = torch.from_numpy(np.random.default_rng(W).random((H, W, 3), np.float32)).to(dev)
    return cfg, packed, rows, prev


def _assert_close(got, want):
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert float((d <= 1e-4).float().mean()) >= 0.999
    flips = int((d > 0.05).any(dim=-1).sum())
    assert flips <= math.ceil(1e-5 * d.shape[0] * d.shape[1]), flips


@pytest.mark.parametrize("W,H", [(256, 128), (100, 37)])
@pytest.mark.parametrize("external", [True, False])
def test_kernel_matches_plain_version(cuda, W, H, external):
    cfg, packed, rows, prev = _setup(cuda, W, H)
    urand = (torch.rand((2 + 2 * cfg.max_depth, H, W), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if external else None)
    before = rk.launches
    got = rk.sample_accum(prev.clone(), packed, rows, 3, cfg, 77, urand)
    want = rk.sample_accum_reference(prev, packed, rows, 3, cfg, 77, urand)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    _assert_close(got, want)


def test_render_step_goes_through_kernel(cuda):
    W, H = 160, 90
    cfg = RenderConfig(width=W, height=H)
    pkt = demo.reference_demo_scene(16, 8).build_packet().to(cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    before = rk.launches
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, cuda), 3, cfg, spp=3)
    torch.cuda.synchronize()
    assert rk.launches == before + 3 and acc.frame == 3
    lin = acc.linear
    # the running average of clamped samples can round an ulp above 1
    assert bool(torch.isfinite(lin).all()) and 0.0 <= float(lin.min()) <= float(lin.max()) <= 1.0 + 1e-6


def test_wrapper_rejects_bad_inputs(cuda):
    cfg, packed, rows, prev = _setup(cuda, 64, 32)
    with pytest.raises(RendererError, match="contiguous float32"):
        rk.sample_accum(prev.double(), packed, rows, 1, cfg)
    with pytest.raises(RendererError, match="shape"):
        rk.sample_accum(prev, packed, rows, 1, cfg,
                        urand=torch.rand((3, 32, 64), device=cuda))
    with pytest.raises(RendererError, match="accum on"):
        rk.sample_accum(prev, packed, rows, 1, cfg, urand=torch.rand((12, 32, 64)))
