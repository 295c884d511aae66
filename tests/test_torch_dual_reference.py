"""The port's dual training step (`parallel/sharding.dual_train_step`,
BASELINE config 5: the path tracer and SoftRas on one scene) against the
benchmark's plain PyTorch reference (`benchmark/reference/dual.py`), in a
gloo world of one on the CPU, on config 4's scene (`benchmark/configs/
dual_mesh.json`) at 24x16 with the triangle ball cut to 12x6, seeded.

The scene has two analytic spheres, which the raster packet draws as meshes:
each must be drawn at its own centre and radius, and the raster term's
gradient must reach ``sph_center`` and ``sph_radius``.

Tolerances:
  * the loss, rtol 1e-5 (1.7e-7 measured): float32 sums in another order;
  * each gradient leaf, |g - g_ref| <= 1e-3 max(|g_ref|, the median leaf's
    |g_ref|) (the benchmark check's reading, `loops/train.leaf_gaps`; at
    most 5.3e-5 measured, on cam_position and sph_center): the port's plain
    versions (the wavefront's recording forward, the fused backward, the
    online-softmax SoftRas and its adjoint) against the reference's direct
    formulas, float32 operation order; the bfloat16 reference reads 1.26;
  * the raster image, atol 3e-5 (1.0e-5 measured): online softmax against
    a softmax over each sample's pairs (`test_torch_soft_raster.py`'s);
  * the raster term's gradient of one sphere leaf against central
    differences of the reference in float64 (h = 1e-5; h = 1e-4 agrees to
    1e-6 relative, h = 1e-3 already crosses culling and threshold steps),
    rtol 2e-3 (1.2e-4 measured).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import pytest
import torch
import torch.distributed as dist

from benchmark import program_dual as program
from benchmark.loops import train as train_loop
from benchmark.reference import dual as ref
from benchmark.reference.scene import Scene as RefScene
from ptre_tpu_torch.models.scene import DC_SPHERE, DC_TRANSFORM
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import rasterizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 24, 16
KEY_SEED = 2**40 + 77
TARGET_SEED = 99
LEAVES = sh.PARAM_KEYS


def _config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "dual_mesh.json")) as f:
        c = json.load(f)
    c.update(width=W, height=H,
             meshes={**c["meshes"], "ball": {**c["meshes"]["ball"], "segments": 12, "rings": 6}})
    return c


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one, left as it was found."""
    torch.set_num_threads(1)
    started = not dist.is_initialized()
    yield sh.make_mesh((1, 1), device_type="cpu")
    if started:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port():
    c = _config()
    scn = program.build_scene(c)
    pkt = scn.build_packet(device="cpu")
    rpkt = scn.build_packet(spheres_as_triangles=True, device="cpu")
    cam = program.camera(c, "cpu")
    return dict(config=c, pkt=pkt, rpkt=rpkt, cam=cam, cfg=program.render_config(c),
                rcfg=program.raster_config(c), params=sh.differentiable_params(pkt, cam),
                target=train_loop.target_image(c, TARGET_SEED, "cpu").reshape(H, W, 3))


def _dual(mesh, p, raster_weight):
    step = sh.make_dual_train_step(mesh, p["cam"], p["cfg"], p["rcfg"], spp=1,
                                   raster_weight=raster_weight,
                                   sigma=p["config"]["raster"]["sigma"])
    return step(p["params"], p["pkt"], p["rpkt"], p["target"], rng.key_for(KEY_SEED))


@pytest.fixture(scope="module")
def stepped(mesh, port):
    return _dual(mesh, port, port["config"]["raster"]["raster_weight"])


@pytest.fixture(scope="module")
def reference(port):
    c = port["config"]
    key = rng.key_for(KEY_SEED)
    return ref.dual_step(c, RefScene.from_config(c, "cpu"), port["target"].reshape(-1, 3),
                         (key.k0, key.k1), 1, block_rows=8)


def test_dual_step_loss_matches_the_reference(stepped, reference):
    assert float(stepped[0]) == pytest.approx(reference[0], rel=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_dual_step_gradient_matches_the_reference(stepped, reference, leaf):
    grads, ref_grads = stepped[1], reference[1]
    norms = sorted(float(g.double().norm()) for g in ref_grads.values())
    floor = max(float(ref_grads[leaf].double().norm()), norms[len(norms) // 2])
    assert float(ref_grads[leaf].double().norm()) > 0, leaf
    gap = float((grads[leaf].double() - ref_grads[leaf].double()).norm()) / floor
    assert gap <= 1e-3, (leaf, gap)


def test_raster_image_matches_the_reference_softras(port):
    p = port
    with torch.no_grad():
        rpkt = dataclasses.replace(p["rpkt"], transforms=sh.raster_transforms(
            p["params"], p["pkt"], p["rpkt"]))
        got = rasterizer.raster_rows(rpkt, p["cam"], p["rcfg"], 0.0, H, soft=True,
                                     sigma=p["config"]["raster"]["sigma"])
    want = ref.soft_image(p["config"], RefScene.from_config(p["config"], "cpu").params, "cpu")
    assert got.shape == want.shape == (H, W, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)


def test_each_sphere_is_drawn_at_its_own_centre_and_radius(port):
    p = port
    pkt, rpkt = p["pkt"], p["rpkt"]
    assert pkt.num_spheres == 2 and rpkt.num_drawcalls == pkt.num_drawcalls + 2
    table = sh.raster_transforms(p["params"], pkt, rpkt)
    spheres = sh.sphere_transforms(pkt.sph_center, pkt.sph_radius)
    kinds = [kind for kind, _ in rpkt.drawcall_params]
    assert kinds.count(DC_SPHERE) == 2 and kinds.count(DC_TRANSFORM) == pkt.num_drawcalls
    for d, (kind, i) in enumerate(rpkt.drawcall_params):
        want = spheres[i] if kind == DC_SPHERE else pkt.transforms[i]
        assert torch.equal(table[d], want), d
    # unrotated, uniformly scaled spheres: each model's own transform
    assert torch.equal(table, rpkt.transforms)


@pytest.mark.parametrize("leaf, index", [("sph_radius", (0,)), ("sph_radius", (1,)),
                                         ("sph_center", (1, 1))])
def test_raster_gradient_reaches_the_spheres(mesh, port, stepped, leaf, index):
    """The raster term's gradient (the step at raster_weight 0.5 less the
    same step at 0) of one sphere leaf, against central differences of the
    reference's 0.5 x raster MSE in float64."""
    raster = float(stepped[1][leaf][index] - _dual(mesh, port, 0.0)[1][leaf][index])
    c = port["config"]
    rscene = ref.RasterScene.from_config(c, "cpu")
    params = {k: v.double() for k, v in RefScene.from_config(c, "cpu").params.items()}
    target = port["target"].double()

    def loss(p):
        tab, keep = ref.screen_triangles(c, rscene, p)
        img = ref.soft_rows(c, tab, keep, 0, H, torch.float64)
        return c["raster"]["raster_weight"] * float(torch.mean((img - target) ** 2))

    h = 1e-5
    up, down = copy.deepcopy(params), copy.deepcopy(params)
    up[leaf][index] += h
    down[leaf][index] -= h
    fd = (loss(up) - loss(down)) / (2 * h)
    assert abs(fd) > 1e-4, fd
    assert raster == pytest.approx(fd, rel=2e-3)


def test_a_scene_without_spheres_keeps_the_path_traced_table(port):
    """No analytic sphere: the raster packet's table is the transforms leaf
    itself, so the step is the one the tables' match always gave."""
    c = copy.deepcopy(port["config"])
    c["models"] = [m for m in c["models"] if c["meshes"][m["mesh"]]["type"] != "spheres"]
    scn = program.build_scene(c)
    pkt, rpkt = scn.build_packet(device="cpu"), scn.build_packet(spheres_as_triangles=True,
                                                                   device="cpu")
    assert pkt.num_spheres == 0 and rpkt.drawcall_params == pkt.drawcall_params
    params = sh.differentiable_params(pkt, port["cam"])
    assert sh.raster_transforms(params, pkt, rpkt) is params["transforms"]
