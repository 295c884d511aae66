"""The port's `ops/vecmat` against the JAX package's, helper by helper.

Seeded numpy inputs go through both packages' functions. Tolerance: 1e-6
absolute and relative for the element-wise helpers (the same float32
formulas; XLA's and ATen's sin, cos and arccos may differ by an ulp), 1e-5
for the products of 4x4 matrices and the LAPACK-backed determinant and
normal matrix (other summation orders). Then the 16 cases of
`tests/test_vecmat.py`, against closed-form values, on the port's helpers.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.ops import vecmat as jvm
from ptre_tpu_torch.ops import vecmat as vm

RNG = np.random.default_rng(1234)
V3A = RNG.normal(size=(5, 3)).astype(np.float32)
V3B = RNG.normal(size=(5, 3)).astype(np.float32)
V4 = RNG.normal(size=(5, 4)).astype(np.float32)
ANG = RNG.uniform(-3.0, 3.0, size=(5,)).astype(np.float32)
AXIS = (V3A / np.linalg.norm(V3A, axis=1, keepdims=True)).astype(np.float32)
MATS = np.stack([np.asarray(jvm.compose_trs(RNG.uniform(0.5, 2.0, 3).astype(np.float32),
                                            RNG.uniform(-1, 1, 3).astype(np.float32),
                                            RNG.normal(size=3).astype(np.float32)))
                 for _ in range(5)]).astype(np.float32)
WITH_NAN = np.where(RNG.random((4, 4, 4)) < 0.05, np.nan, 1.0).astype(np.float32)
WITH_INF = np.where(RNG.random((4, 4, 4)) < 0.05, np.inf, 1.0).astype(np.float32)
WITH_NAN[0, 0, 0], WITH_INF[1, 2, 3] = np.nan, -np.inf

T = torch.from_numpy
TIGHT = dict(rtol=1e-6, atol=1e-6)
MATMUL = dict(rtol=1e-5, atol=1e-5)

# (helper, port call, JAX call, tolerance)
CASES = {
    "to_degrees": (lambda m, x: m.to_degrees(x(ANG)), TIGHT),
    "is_zero": (lambda m, x: m.is_zero(x(np.array([0.0, 1e-7, -5e-7, 1e-6, 2e-3],
                                                   np.float32))), TIGHT),
    "vec3": (lambda m, x: m.vec3(x(ANG), x(ANG * 2), x(ANG * 3)), TIGHT),
    "length_sq": (lambda m, x: m.length_sq(x(V3A)), TIGHT),
    "length": (lambda m, x: m.length(x(V3A)), TIGHT),
    "hadamard": (lambda m, x: m.hadamard(x(V3A), x(V3B)), TIGHT),
    "angle": (lambda m, x: m.angle(x(V3A), x(V3B)), TIGHT),
    "angle_of_zero": (lambda m, x: m.angle(x(np.zeros((2, 3), np.float32)), x(V3B[:2])),
                      TIGHT),
    "clamp_length": (lambda m, x: m.clamp_length(x(V3A), 0.8), TIGHT),
    "is_nan": (lambda m, x: m.is_nan(x(WITH_NAN)), TIGHT),
    "is_inf": (lambda m, x: m.is_inf(x(WITH_INF)), TIGHT),
    "reflect": (lambda m, x: m.reflect(x(V3A), x(AXIS)), TIGHT),
    "refract": (lambda m, x: m.refract(x(V3B), x(AXIS), 0.67), TIGHT),
    "refract_tir": (lambda m, x: m.refract(x(V3B), x(AXIS), 2.5), TIGHT),
    "swizzle": (lambda m, x: m.swizzle(x(V4), "wzxy"), TIGHT),
    "identity": (lambda m, x: m.identity(), TIGHT),
    "scale": (lambda m, x: m.scale(x(V3A)), TIGHT),
    "scale_scalar": (lambda m, x: m.scale(1.5), TIGHT),
    "translate": (lambda m, x: m.translate(x(V3A)), TIGHT),
    "rotation_x": (lambda m, x: m.rotation_x(x(ANG)), TIGHT),
    "rotation_y": (lambda m, x: m.rotation_y(x(ANG)), TIGHT),
    "rotation_z": (lambda m, x: m.rotation_z(x(ANG)), TIGHT),
    "rotation_axis": (lambda m, x: m.rotation_axis(x(ANG), x(AXIS)), TIGHT),
    "compose_trs": (lambda m, x: m.compose_trs(x(V3A), x(V3B), x(V3A[::-1].copy())), MATMUL),
    "determinant": (lambda m, x: m.determinant(x(MATS)), MATMUL),
    "transform_dirs": (lambda m, x: m.transform_dirs(x(V3A), x(MATS)), MATMUL),
    "transform_normals": (lambda m, x: m.transform_normals(x(V3B), x(MATS)), MATMUL),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    fn, tol = CASES[name]
    got = fn(vm, T)
    want = np.asarray(fn(jvm, jnp.asarray))
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


def test_constants_and_every_helper_ported():
    assert vm.IS_ZERO_EPS == jvm.IS_ZERO_EPS
    helpers = ("angle", "clamp_length", "compose_trs", "determinant", "hadamard", "identity",
               "is_inf", "is_nan", "is_zero", "length", "length_sq", "reflect", "refract",
               "rotation_axis", "rotation_x", "rotation_y", "rotation_z", "scale", "swizzle",
               "to_degrees", "transform_dirs", "transform_normals", "translate", "vec3")
    assert all(callable(getattr(vm, h)) for h in helpers)


# -- tests/test_vecmat.py's 16 cases on the port -------------------------------

def _t(*v):
    return torch.tensor(v, dtype=torch.float32)


def test_constants():
    assert vm.pi == pytest.approx(np.pi)
    assert vm.tau == pytest.approx(2 * np.pi)
    np.testing.assert_allclose(vm.to_radians(180.0), np.pi, rtol=1e-6)
    np.testing.assert_allclose(vm.to_degrees(np.pi / 2), 90.0, rtol=1e-6)


def test_vector_ops():
    a, b = _t(1.0, 2.0, 3.0), _t(4.0, -5.0, 6.0)
    np.testing.assert_allclose(vm.dot(a, b), 1 * 4 - 2 * 5 + 3 * 6)
    np.testing.assert_allclose(vm.cross(a, b), np.cross(a.numpy(), b.numpy()), atol=1e-6)
    np.testing.assert_allclose(vm.length(_t(3.0, 4.0, 0.0)), 5.0)
    np.testing.assert_allclose(vm.hadamard(a, b), [4.0, -10.0, 18.0])


def test_normalize_zero_safe():
    np.testing.assert_allclose(vm.normalize(torch.zeros(3)), np.zeros(3))
    np.testing.assert_allclose(vm.normalize(_t(0.0, 10.0, 0.0)), [0.0, 1.0, 0.0], atol=1e-7)


def test_reflect():
    np.testing.assert_allclose(vm.reflect(_t(1.0, -1.0, 0.0), _t(0.0, 1.0, 0.0)),
                               [1.0, 1.0, 0.0], atol=1e-6)


def test_refract_and_tir():
    n = _t(0.0, 1.0, 0.0)
    v = vm.normalize(_t(1.0, -1.0, 0.0))
    r = vm.refract(v, n, 0.5)
    sin_t = float(torch.abs(r[0]) / vm.length(r))
    np.testing.assert_allclose(sin_t, 0.5 * np.sin(np.pi / 4), atol=1e-6)
    np.testing.assert_allclose(vm.refract(v, n, 3.0), vm.reflect(v, n), atol=1e-6)


def test_swizzle():
    np.testing.assert_allclose(vm.swizzle(_t(1.0, 2.0, 3.0, 4.0), "wzyx"), [4.0, 3.0, 2.0, 1.0])


def test_translate_row_vector_convention():
    m = vm.translate(_t(1.0, 2.0, 3.0))
    np.testing.assert_allclose(vm.transform_points(_t(1.0, 1.0, 1.0), m), [2.0, 3.0, 4.0])
    np.testing.assert_allclose(vm.transform_dirs(_t(1.0, 1.0, 1.0), m), [1.0, 1.0, 1.0])


def test_rotation_directions():
    p = vm.transform_points(_t(1.0, 0.0, 0.0), vm.rotation_z(math.pi / 2))
    np.testing.assert_allclose(p, [0.0, 1.0, 0.0], atol=1e-6)
    p = vm.transform_points(_t(0.0, 1.0, 0.0), vm.rotation_x(math.pi / 2))
    np.testing.assert_allclose(p, [0.0, 0.0, 1.0], atol=1e-6)
    p = vm.transform_points(_t(0.0, 0.0, 1.0), vm.rotation_y(math.pi / 2))
    np.testing.assert_allclose(p, [1.0, 0.0, 0.0], atol=1e-6)


def test_rotation_axis_matches_elementary():
    np.testing.assert_allclose(vm.rotation_axis(0.7, _t(0.0, 0.0, 1.0)), vm.rotation_z(0.7),
                               atol=1e-6)
    np.testing.assert_allclose(vm.rotation_axis(0.7, _t(1.0, 0.0, 0.0)), vm.rotation_x(0.7),
                               atol=1e-6)


def test_compose_trs_order():
    m = vm.compose_trs(_t(2.0, 2.0, 2.0), _t(0.0, 0.0, math.pi / 2), _t(10.0, 0.0, 0.0))
    np.testing.assert_allclose(vm.transform_points(_t(1.0, 0.0, 0.0), m), [10.0, 2.0, 0.0],
                               atol=1e-5)


def test_look_at_properties():
    eye, focus = _t(0.0, 0.5, -3.0), _t(0.0, 0.0, 0.0)
    v = vm.look_at(eye, focus)
    np.testing.assert_allclose(vm.transform_points(eye, v), [0.0, 0.0, 0.0], atol=1e-6)
    f = vm.transform_points(focus, v)
    np.testing.assert_allclose(f[:2], [0.0, 0.0], atol=1e-6)
    assert f[2] > 0


def test_look_at_non_orthonormal_parity():
    eye = _t(0.0, 0.5, -3.0)
    right = vm.look_at(eye, eye + _t(0.0, -0.5, 3.0)).numpy()[:3, 0]
    assert not np.isclose(np.linalg.norm(right), 1.0)


def test_perspective_d3d_z01():
    znear, zfar = 0.01, 100.0
    m = vm.perspective(16 / 9, vm.to_radians(45.0), znear, zfar)
    pn, wn = vm.transform_points_h(_t(0.0, 0.0, znear), m)
    np.testing.assert_allclose(pn[2] / wn, 0.0, atol=1e-6)
    pf, wf = vm.transform_points_h(_t(0.0, 0.0, zfar), m)
    np.testing.assert_allclose(pf[2] / wf, 1.0, atol=1e-5)
    np.testing.assert_allclose(wf, zfar, rtol=1e-6)
    assert bool(torch.isinf(vm.perspective(1.0, 1.0, 5.0, 5.0)).all())


def test_orthographic_d3d():
    m = vm.orthographic(1.0, 1.0, 11.0)
    p, w = vm.transform_points_h(_t(0.0, 1.0, 1.0), m)
    np.testing.assert_allclose(w, 1.0)
    np.testing.assert_allclose(p[1], 1.0, atol=1e-6)
    np.testing.assert_allclose(p[2], 0.0, atol=1e-6)
    p2, _ = vm.transform_points_h(_t(0.0, 0.0, 11.0), m)
    np.testing.assert_allclose(p2[2], 1.0, atol=1e-6)


def test_normal_matrix_vs_reference_spelling():
    m = vm.compose_trs(_t(2.0, 3.0, 4.0), _t(0.3, -0.2, 0.9), _t(5.0, 6.0, 7.0))
    n = vm.normal_matrix(m)
    m3 = m.numpy()[:3, :3]
    np.testing.assert_allclose(n, np.linalg.inv(m3.T).T.T, atol=1e-5)
    np.testing.assert_allclose(n, np.linalg.inv(m3).T, atol=1e-5)
    sc = vm.scale(_t(2.0, 1.0, 1.0))
    nrm = vm.transform_normals(_t(0.0, 1.0, 0.0), sc)
    tangent = vm.transform_dirs(_t(1.0, 0.0, 0.0), sc)
    np.testing.assert_allclose(vm.dot(nrm, tangent), 0.0, atol=1e-6)


def test_inverse_roundtrip():
    m = vm.compose_trs(_t(2.0, 3.0, 4.0), _t(0.3, -0.2, 0.9), _t(5.0, 6.0, 7.0))
    np.testing.assert_allclose(m @ vm.inverse(m), np.eye(4), atol=1e-5)
