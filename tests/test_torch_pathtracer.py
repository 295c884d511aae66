"""The port's progressive render loop vs the JAX package's.

The JAX `render_step` on the CPU takes its staged route (`integrator.trace`)
with threefry keys. The port takes the very draws that route makes, through
``urand``: per sample s with n1 = frame + s + 1 and skey = fold(fold(key, s),
n1), rows 0-1 are ``pixel_jitter(fold(skey, 0x9E37))`` + 0.5 and rows 2.. are
``megakernel._build_urand(skey, R, max_depth)`` (`pathtracer.py:151-159`).

The staged route builds rays by the near/far unproject, the port by the
closed-form rows of the render kernel, so a ray that grazes an edge can
take another primitive: the tolerance is that of the fused-vs-staged test
`tests/test_megakernel.py:80-83` (atol = rtol = 2e-3, >= 95 % of pixels
within 1e-4 on all channels). The goldens are held to `test_goldens.py`'s
bound (>= 99.5 % of values within 2 uint8 steps, max 8), with one stated
exception: in config2_cornell ONE pixel of 4096 may exceed 8. Its walls are
spheres of radius 1000, where float32 |oc|^2 ~ 1e6 has an ulp of 0.06, so
whether a bounce off a wall re-hits it flips with ulp-level differences in
the ray; the port and the JAX render kernel differ on this scene by 5e-4
even with identical formulas (XLA's rounding), and the fused formulation
differs from the staged one that made the golden (ROADMAP section C).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import rng as jrng
from ptre_tpu.ops.pallas import megakernel as jmk
from ptre_tpu.ops.pallas import render_kernel as jrk
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu.utils.config import RenderConfig
from ptre_tpu.utils.image import read_ppm
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.models.scene import PACKET_COUNTS, PACKET_LEAVES
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.utils import interop

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def jax_urand(key, frame, spp, H, W, max_depth):
    """(spp, 2 + 2*max_depth, H, W) uniforms of the JAX staged route."""
    R = H * W
    out = []
    for s in range(spp):
        skey = jrng.fold(jrng.fold(key, s), frame + s + 1)
        jit = np.asarray(jrng.pixel_jitter(jrng.fold(skey, 0x9E37), (R,)))
        ur = np.asarray(jmk._build_urand(skey, R, max_depth))
        out.append(np.concatenate([jit.T + np.float32(0.5), ur]).reshape(-1, H, W))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def test_render_step_matches_jax_staged_route():
    torch.set_num_threads(1)
    W, H, spp = 64, 32, 2
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    root = jrng.key_for(1984)

    jp = jdemo.reference_demo_scene(16, 8).build_packet()
    jc = jcam.Camera.create(width=W, height=H)
    jacc = jpt.AccumState.create(H, W)
    pkt = demo.reference_demo_scene(16, 8).build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    acc = pt.AccumState.create(H, W)
    for step in range(2):
        key = jrng.fold(root, step)
        urand = jax_urand(key, acc.frame, spp, H, W, cfg.max_depth)
        jacc = jpt.render_step(jp, jc, jacc, key, cfg, spp=spp)
        acc = pt.render_step(pkt, cam, acc, 0, cfg, spp=spp, urand=urand)
        assert acc.frame == int(jacc.frame) == (step + 1) * spp

    _assert_staged_close(acc.linear.numpy(), np.asarray(jacc.linear))


def _assert_staged_close(got, want):
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    close = np.all(np.abs(got - want) < 1e-4, axis=-1)
    assert close.mean() > 0.95, close.mean()


def test_interop_continues_a_jax_render():
    # packet, camera and history cross as numpy leaves; the port then takes
    # the next step of a render the JAX package began
    torch.set_num_threads(1)
    W, H = 32, 16
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    jp = jdemo.reference_demo_scene(8, 4).build_packet()
    jc = jcam.Camera.create(width=W, height=H, position=(0.5, 1.0, -3.5),
                            forward=(-0.1, -0.3, 3.0), fov_degrees=50.0)
    key = jrng.key_for(5)
    jacc = jpt.render_step(jp, jc, jpt.AccumState.create(H, W), key, cfg, spp=1)

    pkt = interop.packet_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in PACKET_LEAVES},
        {k: getattr(jp, k) for k in PACKET_COUNTS})
    cam = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, f)) for f in
          ("position", "forward", "fov_degrees", "znear", "zfar")),
        jc.width, jc.height, jc.projection)
    acc = interop.accum_from_numpy(np.asarray(jacc.linear), np.asarray(jacc.frame))
    assert acc.frame == 1
    np.testing.assert_array_equal(acc.linear.numpy(), np.asarray(jacc.linear))
    np.testing.assert_allclose(rk.camera_rows(cam).numpy(),
                               np.asarray(jrk.camera_rows(jc)), rtol=0, atol=1e-5)

    key2 = jrng.fold(key, 1)
    urand = jax_urand(key2, acc.frame, 1, H, W, cfg.max_depth)
    jacc = jpt.render_step(jp, jc, jacc, key2, cfg, spp=1)
    acc = pt.render_step(pkt, cam, acc, 0, cfg, spp=1, urand=urand)
    assert acc.frame == int(jacc.frame) == 2
    _assert_staged_close(acc.linear.numpy(), np.asarray(jacc.linear))


# the four dense path-traced goldens (`scripts/make_goldens.py:48-71`)
# name: (scene function, args, camera, config, spp, seed, pixels allowed beyond 8)
GOLDENS = {
    "config1_sphere_light.ppm": (
        "sphere_light_scene", (), dict(position=(0.0, 1.0, -4.0), forward=(0.0, -0.2, 4.0)),
        dict(width=64, height=64, max_depth=2), 4, 11, 0),
    "config2_cornell.ppm": (
        "cornell_spheres_scene", (), dict(position=(0.0, 1.5, -6.0), forward=(0.0, -0.2, 6.0)),
        dict(width=64, height=64, max_depth=4), 4, 22, 1),
    "demo_pt.ppm": (
        "reference_demo_scene", (16, 8), {},
        dict(width=64, height=36, max_depth=5), 4, 1984, 0),
    "demo_ortho.ppm": (
        "reference_demo_scene", (16, 8), dict(projection=cam_ops.ORTHOGRAPHIC),
        dict(width=64, height=36, max_depth=3), 2, 7, 0),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_renders_dense_goldens(name):
    torch.set_num_threads(1)
    scene_fn, args, cam_kw, cfg_kw, spp, seed, outliers = GOLDENS[name]
    W, H = cfg_kw["width"], cfg_kw["height"]
    cfg = RenderConfig(**cfg_kw)
    pkt = getattr(demo, scene_fn)(*args).build_packet()
    cam = cam_ops.Camera.create(width=W, height=H, **cam_kw)
    urand = jax_urand(jrng.key_for(seed), 0, spp, H, W, cfg.max_depth)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W), 0, cfg, spp=spp,
                         urand=urand)
    got = pt.to_display(acc.linear).numpy().astype(np.int16)
    want = read_ppm(os.path.join(GOLDEN_DIR, name)).astype(np.int16)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff <= 2).mean() >= 0.995, (diff <= 2).mean()
    bad_pixels = int(np.any(diff > 8, axis=-1).sum())
    assert bad_pixels <= outliers, (bad_pixels, diff.max())


def test_to_display_and_bgra8_bit_equal_to_jax():
    rs = np.random.default_rng(11)
    lin = rs.uniform(-0.5, 1.5, (17, 23, 3)).astype(np.float32)
    lin[0, :3] = [[0.0, 1.0, 0.25], [1.0 / 255.0, 4.0 / 255.0**2, 0.999999],
                  [1e-30, 2.0, -0.0]]
    for gamma in (True, False):
        got = pt.to_display(torch.from_numpy(lin), sqrt_gamma=gamma)
        want = np.asarray(jpt.to_display(jnp.asarray(lin), sqrt_gamma=gamma))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    u8 = pt.to_display(torch.from_numpy(lin))
    np.testing.assert_array_equal(pt.to_bgra8(u8).numpy(),
                                  np.asarray(jpt.to_bgra8(jnp.asarray(u8.numpy()))))


def test_reset_overwrites_history_and_frame_is_host_int():
    torch.set_num_threads(1)
    W, H = 16, 8
    cfg = RenderConfig(width=W, height=H, max_depth=2)
    pkt = demo.reference_demo_scene(8, 4).build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W), 5, cfg, spp=3)
    assert acc.frame == 3 and isinstance(acc.frame, int)
    before = acc.linear.clone()
    reset = acc.reset()
    assert reset.frame == 0
    assert torch.equal(reset.linear, before)  # reset zeroes only the counter
    gen = torch.Generator().manual_seed(42)
    after = pt.render_step(pkt, cam, reset, gen, cfg, spp=1)
    assert after.linear is reset.linear  # updated in place
    fresh = pt.render_step(pkt, cam, pt.AccumState.create(H, W),
                           torch.Generator().manual_seed(42), cfg, spp=1)
    assert torch.equal(after.linear, fresh.linear)  # n = 1 overwrote history
    # the same seed renders the same image; another seed another one
    again = pt.render_step(pkt, cam, pt.AccumState.create(H, W), 5, cfg, spp=3)
    assert torch.equal(again.linear, before)
    other = pt.render_step(pkt, cam, pt.AccumState.create(H, W), 6, cfg, spp=3)
    assert not torch.equal(other.linear, before)
