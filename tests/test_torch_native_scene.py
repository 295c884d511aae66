"""The port's native scene binding (`ptre_tpu_torch/models/native_scene.py`).

The cases of `tests/test_native_scene.py` on the port: the C++ core's
meshes against the port's generators, its packets leaf for leaf against the
port's `Scene` (the path tracer's packet exactly; the rasterizer's, whose
sphere meshes the C++ core generates with its own sin and cos, within 1e-6
as in the JAX test), CRUD, raw meshes and materials, and a render. Then
leaf for leaf against the JAX package's `NativeScene` over the same C ABI:
exactly equal. The JAX binding is pointed at the library the port built
(the same source), so this file never runs ``make`` in ``native/``, which
the JAX package's own test does from another worker.
"""

from __future__ import annotations

import math
import os
import shutil

import numpy as np
import pytest
import torch

from ptre_tpu_torch.models import demo, mesh as mg
from ptre_tpu_torch.models import native_scene
from ptre_tpu_torch.models.scene import PACKET_COUNTS, PACKET_LEAVES
from ptre_tpu_torch.utils.errors import SceneError

pytestmark = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                                reason="no C++ toolchain")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _native_demo(module=native_scene, segments=8, rings=4):
    ns = module.NativeScene()
    assert ns.add_mesh_tri("default")
    assert ns.add_mesh_cube("cube")
    assert ns.add_mesh_uv_sphere("sphere", False, segments, rings)
    assert ns.add_model("ground", "sphere")
    ns.set_transforms("ground", 10.0, (math.pi / 2, 0.0, 0.0), (0.0, -10.0, 0.0))
    assert ns.add_model("sph", "sphere")
    ns.set_transforms("sph", 0.5, 0.0, (0.0, 0.5, 0.0))
    assert ns.add_model("wall", "cube")
    ns.set_transforms("wall", 1.0, 0.0, (1.0, 0.5, 0.0))
    return ns


def _assert_packets_equal(a, b, atol=0.0):
    for c in PACKET_COUNTS:
        assert getattr(a, c) == getattr(b, c), c
    for f in PACKET_LEAVES:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        if atol:
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol, rtol=0, err_msg=f)
        else:
            assert torch.equal(x, y), f


def test_library_builds_into_the_port_build_dir_not_native(tmp_path, monkeypatch):
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    monkeypatch.setattr(native_scene, "BUILD_DIR", str(tmp_path / "_build"))
    path = native_scene.build_library()
    assert os.path.dirname(path) == str(tmp_path / "_build") and os.path.isfile(path)
    assert native_scene.build_library() == path  # reused, not rebuilt
    assert os.listdir(tmp_path / "_build") == [os.path.basename(path)]  # no temporaries
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before


def test_mesh_generators_match_python():
    ns = native_scene.NativeScene()
    ns.add_mesh_tri("t")
    ns.add_mesh_quad("q")
    ns.add_mesh_cube("c")
    ns.add_mesh_reg_polygon("p", 7)
    ns.add_mesh_uv_sphere("s", False, 12, 6)
    ns.add_mesh_uv_sphere("sf", True, 12, 6)
    ref = {"t": mg.tri(), "q": mg.quad(), "c": mg.cube(), "p": mg.reg_polygon(7),
           "s": mg.uv_sphere(False, 12, 6), "sf": mg.uv_sphere(True, 12, 6)}
    for name, mesh in ref.items():
        pos, nrm, idx, ty = ns.get_mesh_arrays(name)
        np.testing.assert_allclose(pos, mesh.positions, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(nrm, mesh.normals, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(idx, mesh.indices, err_msg=name)
        assert ty == mesh.mesh_type
    with pytest.raises(SceneError):
        ns.get_mesh_arrays("missing")


def test_demo_packet_matches_python():
    py = demo.reference_demo_scene(8, 4).build_packet(tri_pad=8, sph_pad=4, device="cpu")
    nat = _native_demo().build_packet(tri_pad=8, sph_pad=4, device="cpu")
    _assert_packets_equal(nat, py)


def test_raster_packet_matches_python():
    py = demo.reference_demo_scene(8, 4).build_packet(spheres_as_triangles=True, device="cpu")
    nat = _native_demo().build_packet(spheres_as_triangles=True, device="cpu")
    _assert_packets_equal(nat, py, atol=1e-6)


def test_crud_semantics():
    ns = native_scene.NativeScene()
    assert ns.add_mesh_cube("m")
    assert not ns.add_mesh_tri("m")  # duplicate silently refused
    assert ns.add_model("a", "m")
    with pytest.raises(SceneError):
        ns.add_model("b", "missing")
    assert not ns.delete_mesh("m")  # still referenced
    assert ns.rename_model("a", "z")
    assert ns.delete_model("z")
    assert ns.delete_mesh("m")
    assert ns.modified()
    ns.add_mesh_tri("t")
    ns.add_model("x", "t")
    ns.build_packet(tri_pad=8, device="cpu")
    assert not ns.modified()
    ns.set_transforms("x", 2.0, 0.0, 0.0)
    assert ns.modified()


def test_raw_mesh_and_material():
    from ptre_tpu_torch.models.scene import Material, MaterialKind

    ns = native_scene.NativeScene()
    m = mg.uv_sphere(False, 6, 4, mg.MeshType.TRIANGLES)
    assert ns.add_mesh_raw("ball", m.positions, m.normals, m.indices)
    assert ns.add_model("b", "ball")
    gold = ns.add_material(Material(MaterialKind.OREN_NAYAR, (0.9, 0.7, 0.2), 0.3))
    assert ns.set_model_material("b", gold)
    with pytest.raises(SceneError):
        ns.set_model_material("b", 99)
    with pytest.raises(SceneError):
        ns.add_mesh_raw("bad", m.positions, m.normals, np.array([0, 1, 10**6], np.uint32))
    pkt = ns.build_packet(tri_pad=8, device="cpu")
    assert pkt.num_triangles == m.num_triangles
    assert bool((pkt.tri_mat[: pkt.num_triangles] == gold).all())


def test_native_packet_renders():
    """The native packet feeds the port's path tracer as the Python one does."""
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.config import RenderConfig

    torch.set_num_threads(1)
    cam = cam_ops.Camera.create(width=16, height=16, device="cpu")
    cfg = RenderConfig(width=16, height=16)
    imgs = [pt.render_step(p, cam, pt.AccumState.create(16, 16, device="cpu"), 3, cfg).linear
            for p in (_native_demo().build_packet(device="cpu"),
                      demo.reference_demo_scene(8, 4).build_packet(device="cpu"))]
    assert torch.equal(imgs[0], imgs[1]) and float(imgs[0].sum()) > 0


def test_packet_defaults_to_the_card(monkeypatch):
    from ptre_tpu_torch.utils.errors import RendererError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RendererError, match="CUDA device is required"):
        _native_demo().build_packet()


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's binding over the library the port built."""
    from ptre_tpu.models import native_scene as jns

    monkeypatch.setattr(jns, "build_library", lambda force=False: native_scene.build_library())
    monkeypatch.setattr(jns, "_lib", None)
    return jns


@pytest.mark.parametrize("sat", [False, True])
def test_packets_equal_the_jax_native_scene(jax_native, sat):
    nat = _native_demo().build_packet(spheres_as_triangles=sat, device="cpu")
    jp = _native_demo(jax_native).build_packet(spheres_as_triangles=sat)
    for c in PACKET_COUNTS:
        assert getattr(nat, c) == getattr(jp, c), c
    for f in PACKET_LEAVES:
        want = np.asarray(getattr(jp, f))
        got = getattr(nat, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
