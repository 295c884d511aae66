"""Camera math parity: `ptre_tpu_torch.ops.{vecmat,camera}` vs the reference.

The matrix factories are the same float32 formulas on both sides, held to
1e-6 (one or two ulp of the O(1) entries; inverses go through two LAPACK
builds). Rays and the closed-form ray rows are held to 1e-5, the bound of
the reference's own camera tests (`tests/test_camera.py`).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import vecmat as jvm
from ptre_tpu.ops.pallas import render_kernel as jrk
from ptre_tpu.render import pathtracer as jpt
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.render import pathtracer as pt

TOL = 1e-6


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("eye,focus", [
    ((0.0, 0.5, -3.0), (0.0, 0.0, 0.0)),  # test_vecmat: look_at properties
    ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
    ((1.0, 2.0, 3.0), (-2.0, 0.5, 7.0)),
])
def test_look_at(eye, focus):
    _close(vm.look_at(_t(eye), _t(focus)), jvm.look_at(jnp.asarray(eye), jnp.asarray(focus)))


def test_look_at_non_orthonormal_parity():
    # `matrix.cu:315-324`: right/up are not normalized for a tilted forward
    eye = _t((0.0, 0.5, -3.0))
    v = vm.look_at(eye, eye + _t((0.0, -0.5, 3.0)))
    _close(v, jvm.look_at(jnp.array([0.0, 0.5, -3.0]), jnp.array([0.0, 0.0, 0.0])))
    assert not math.isclose(float(torch.linalg.norm(v[:3, 0])), 1.0)


@pytest.mark.parametrize("args", [
    (16 / 9, 45.0, 0.01, 100.0),
    (1.0, 90.0, 0.01, 100.0),
    (1280 / 720, 45.0, 0.5, 20.0),
])
def test_perspective(args):
    aspect, fov, zn, zf = args
    _close(vm.perspective(aspect, vm.to_radians(fov), zn, zf),
           jvm.perspective(aspect, jvm.to_radians(fov), zn, zf))


def test_perspective_degenerate_is_infinity():
    bad = vm.perspective(1.0, 1.0, 5.0, 5.0)
    assert torch.isinf(bad).all()
    assert np.all(np.isinf(np.asarray(jvm.perspective(1.0, 1.0, 5.0, 5.0))))


@pytest.mark.parametrize("args", [(1.0, 1.0, 11.0), (16 / 9, 0.01, 100.0)])
def test_orthographic(args):
    _close(vm.orthographic(*args), jvm.orthographic(*args))


def _trs():
    return np.asarray(jvm.compose_trs(jnp.array([2.0, 3.0, 4.0]),
                                      jnp.array([0.3, -0.2, 0.9]),
                                      jnp.array([5.0, 6.0, 7.0])))


def test_inverse_and_normal_matrix():
    m = _trs()
    _close(vm.inverse(_t(m)), jvm.inverse(jnp.asarray(m)))
    _close(vm.normal_matrix(_t(m)), jvm.normal_matrix(jnp.asarray(m)))
    d = np.diag([2.0, 4.0, 0.5, 1.0]).astype(np.float32)
    _close(vm.inverse(_t(d)), np.diag([0.5, 0.25, 2.0, 1.0]))


def test_inverse_singular_is_infinity():
    # `matrix.cu:141-145`, eps 0.00001f
    zero_scale = np.diag([0.0, 1.0, 1.0, 1.0]).astype(np.float32)
    assert torch.isinf(vm.inverse(_t(zero_scale))).all()
    assert np.all(np.isinf(np.asarray(jvm.inverse(jnp.asarray(zero_scale)))))


def test_transform_points_and_normalize():
    m = _trs()
    p = np.array([[1.0, -2.0, 0.5], [0.0, 0.0, 0.0]], np.float32)
    _close(vm.transform_points(_t(p), _t(m)), jvm.transform_points(jnp.asarray(p), jnp.asarray(m)),
           atol=1e-5)
    xyz, w = vm.transform_points_h(_t(p), _t(m))
    jxyz, jw = jvm.transform_points_h(jnp.asarray(p), jnp.asarray(m))
    _close(xyz, jxyz, atol=1e-5)
    _close(w, jw)
    v = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    _close(vm.normalize(_t(v)), jvm.normalize(jnp.asarray(v)))


CAMS = {
    "default": dict(width=64, height=32),
    "ortho": dict(width=64, height=32, projection=1),
    "centered_fov90": dict(width=48, height=48, position=(0.0, 0.0, 0.0),
                           forward=(0.0, 0.0, 1.0), fov_degrees=90.0),
    "tilted": dict(width=40, height=24, position=(1.0, 2.0, -4.0),
                   forward=(-0.3, -0.4, 1.0), fov_degrees=60.0),
}


@pytest.mark.parametrize("name", list(CAMS))
def test_get_rays_match_reference(name):
    torch.set_num_threads(1)
    kw = CAMS[name]
    cam = cam_ops.Camera.create(**kw, device="cpu")
    jc = jcam.Camera.create(**kw)
    rs = np.random.default_rng(3)
    jit = rs.uniform(-0.5, 0.5, (cam.height * cam.width, 2)).astype(np.float32)
    px, py = pt.pixel_grid(cam.height, cam.width, device="cpu")
    jpx, jpy = jpt.pixel_grid(cam.height, cam.width)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))
    o, d = cam_ops.get_rays(cam, px, py, torch.from_numpy(jit))
    jo, jd = jcam.get_rays(jc, jpx, jpy, jnp.asarray(jit))
    _close(o, jo, atol=1e-5)
    _close(d, jd, atol=1e-5)


@pytest.mark.parametrize("name", list(CAMS))
def test_camera_rows_match_reference(name):
    kw = CAMS[name]
    rows = rk.camera_rows(cam_ops.Camera.create(**kw, device="cpu"))
    assert rows.shape == (24,) and rows.dtype == torch.float32
    _close(rows, jrk.camera_rows(jcam.Camera.create(**kw)), atol=1e-5)


@pytest.mark.parametrize("name", list(CAMS))
def test_carried_camera_rows_and_rays_match_reference(name):
    """A camera carried across from the reference's leaves
    (`interop.camera_from_numpy`, on the CPU when asked) and moved with
    `Camera.to` gives the reference's ray rows and rays as before; a camera
    on another device than the rays is refused, not copied."""
    from ptre_tpu_torch.utils import interop

    kw = CAMS[name]
    jc = jcam.Camera.create(**kw)
    cam = interop.camera_from_numpy(
        np.asarray(jc.position), np.asarray(jc.forward), np.asarray(jc.fov_degrees),
        np.asarray(jc.znear), np.asarray(jc.zfar), jc.width, jc.height, jc.projection,
        device="cpu").to("cpu")
    assert cam.device.type == "cpu"
    _close(rk.camera_rows(cam), jrk.camera_rows(jc), atol=1e-5)
    jit = np.random.default_rng(5).uniform(-0.5, 0.5, (cam.height * cam.width, 2))
    px, py = pt.pixel_grid(cam.height, cam.width, device="cpu")
    o, d = cam_ops.get_rays(cam, px, py, torch.from_numpy(jit.astype(np.float32)))
    jo, jd = jcam.get_rays(jc, *jpt.pixel_grid(cam.height, cam.width),
                           jnp.asarray(jit, jnp.float32))
    _close(o, jo, atol=1e-5)
    _close(d, jd, atol=1e-5)
    with pytest.raises(ValueError, match="the camera is on meta"):
        cam_ops.get_rays(cam.to("meta"), px, py, torch.from_numpy(jit.astype(np.float32)))


def test_still_camera_rows_are_made_once():
    """`camera_rows` of a still camera is made once and shared; a leaf
    changed in place, a new leaf, or a leaf that needs a gradient (grad
    mode on) makes it anew, equal to the rows made from scratch."""
    cam = cam_ops.Camera.create(width=64, height=32, device="cpu")
    rows = rk.camera_rows(cam)
    assert rk.camera_rows(cam) is rows
    cam.position.add_(torch.tensor([0.25, 0.0, 0.0]))
    moved = rk.camera_rows(cam)
    assert moved is not rows
    fresh = cam_ops.Camera.create(width=64, height=32, position=(0.25, 0.5, -3.0),
                                  device="cpu")
    assert torch.equal(moved, rk.camera_rows(fresh))
    cam.fov_degrees.requires_grad_(True)
    grad_rows = rk.camera_rows(cam)
    assert grad_rows is not moved and grad_rows.requires_grad
    assert rk.camera_rows(cam) is not grad_rows
    with torch.no_grad():
        assert torch.equal(rk.camera_rows(cam), moved)
