"""ScenePacket parity: the port builds the reference packet, leaf for leaf.

Leaves come from the same numpy scene description on both sides, so they
must be EXACTLY equal; `world_triangles` goes through two different batched
3x3 inverses (LAPACK via jnp / torch), so it is held to 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models.scene import PACKET_COUNTS, PACKET_LEAVES
from ptre_tpu_torch.utils import interop

SCENES = {
    "reference_demo": lambda m: m.reference_demo_scene(16, 8),
    "sphere_light": lambda m: m.sphere_light_scene(),
    "cornell": lambda m: m.cornell_spheres_scene(),
    "config3_flat": lambda m: m.config3_scene(flat=True, segments=12, rings=6,
                                              diffuse=True),
    "config4_mixed": lambda m: m.config4_mixed_scene(segments=12, rings=6),
}
CASES = [(name, sat) for name in SCENES for sat in (False, True)]


def _packets(name, spheres_as_triangles):
    jp = SCENES[name](jdemo).build_packet(spheres_as_triangles=spheres_as_triangles)
    tp = SCENES[name](demo).build_packet(spheres_as_triangles=spheres_as_triangles)
    return jp, tp


@pytest.mark.parametrize("name,sat", CASES)
def test_packet_leaves_equal_reference(name, sat):
    jp, tp = _packets(name, sat)
    for leaf in PACKET_LEAVES:
        want = np.asarray(getattr(jp, leaf))
        got = getattr(tp, leaf).numpy()
        assert got.dtype == want.dtype, (leaf, got.dtype, want.dtype)
        assert got.shape == want.shape, (leaf, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=leaf)
    for count in PACKET_COUNTS:
        assert getattr(tp, count) == getattr(jp, count), count


@pytest.mark.parametrize("name", list(SCENES))
def test_world_triangles_match_reference(name):
    torch.set_num_threads(1)
    jp, tp = _packets(name, False)
    for want, got in zip(jp.world_triangles(), tp.world_triangles()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["reference_demo", "config4_mixed"])
def test_packet_from_numpy_of_reference_equals_port_packet(name):
    jp, tp = _packets(name, False)
    arrays = {leaf: np.asarray(getattr(jp, leaf)) for leaf in PACKET_LEAVES}
    counts = {c: getattr(jp, c) for c in PACKET_COUNTS}
    carried = interop.packet_from_numpy(arrays, counts)
    for leaf in PACKET_LEAVES:
        assert torch.equal(getattr(carried, leaf), getattr(tp, leaf)), leaf
    for c in PACKET_COUNTS:
        assert getattr(carried, c) == getattr(tp, c)


def test_scene_walk_flags_and_to():
    scn = demo.reference_demo_scene(8, 4)
    assert scn.modified()
    pkt = scn.build_packet()
    assert not scn.modified()
    scn.get_model("sph").set_transforms(0.25, 0.0, (0.0, 0.25, 0.0))
    assert scn.modified()  # setters dirty the scene, reads do not
    # sorted by mesh name with insertion-order tie-break: cube, then spheres
    assert [n for n, _ in scn.sorted_models()] == ["wall", "ground", "sph"]
    assert pkt.num_triangles == 12 and pkt.num_spheres == 2
    assert pkt.tri_v0.shape == (128, 3) and pkt.sph_center.shape == (8, 3)
    assert float(pkt.sph_radius[5]) == 1.0  # pad radius 1
    moved = pkt.to("cpu")
    assert moved.num_materials == pkt.num_materials
    assert all(torch.equal(getattr(moved, k), getattr(pkt, k)) for k in PACKET_LEAVES)
