"""The system under test, ptre_tpu_torch, as the benchmark drives it: its
public scene, camera, configuration, render, training and engine calls,
built from a configuration file through the public API.

The loops reach the program only through this module's names, so a test can
put a broken program in its place. Nothing else of the benchmark imports
ptre_tpu_torch; the reference imports none of it.
"""

from __future__ import annotations

from ptre_tpu_torch.models.mesh import Mesh, MeshType
from ptre_tpu_torch.models.scene import Model, Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.parallel.sharding import differentiable_params
from ptre_tpu_torch.render.engine import Renderer
from ptre_tpu_torch.render.pathtracer import AccumState, render_step
from ptre_tpu_torch.render.train import mse_step
from ptre_tpu_torch.utils.config import RenderConfig

from benchmark.reference import meshes

__all__ = ["AccumState", "Renderer", "differentiable_params", "mse_step", "render_step",
           "build_scene", "camera", "render_config"]

_KINDS = {"oren_nayar": 0, "emissive": 1}


def build_scene(config: dict) -> Scene:
    """The program's scene of ``config``: the benchmark's own meshes, models
    with their transforms and materials, the material table and the sky."""
    scn = Scene()
    table = [(int(m.kind), tuple(float(a) for a in m.albedo), float(m.param))
             for m in scn.materials]
    for i, m in enumerate(config["materials"]):
        row = (_KINDS[m["kind"]], tuple(float(a) for a in m["albedo"]), float(m["param"]))
        if i < len(table):
            if table[i] != row:
                raise ValueError(f"the program's material {i} is {table[i]}, the "
                                 f"configuration's {row}")
        else:
            raise ValueError("the configuration has more materials than the program's "
                             "defaults; add them here through Scene.add_material")
    for name, spec in config["meshes"].items():
        pos, nrm, idx = meshes.build(spec)
        kind = MeshType.SPHERES if spec["type"] == "spheres" else MeshType.TRIANGLES
        scn.add_mesh(name, Mesh(pos, nrm, idx, kind))
    for mdl in config["models"]:
        scn.add_model(mdl["name"], Model(mdl["mesh"]))
        scn.get_model(mdl["name"]).set_transforms(mdl["scale"], mdl["rotation"],
                                                  mdl["translation"])
        scn.get_model(mdl["name"]).set_material(int(mdl["material"]))
    scn.set_sky(config["sky"]["bottom"], config["sky"]["top"])
    return scn


def camera(config: dict, device):
    c = config["camera"]
    if c["projection"] != "perspective":
        raise ValueError(f"projection {c['projection']!r}: the benchmark builds perspective "
                         "cameras only")
    return cam_ops.Camera.create(width=int(config["width"]), height=int(config["height"]),
                                 position=c["position"], forward=c["forward"],
                                 fov_degrees=c["fov_degrees"], znear=c["znear"],
                                 zfar=c["zfar"], device=device)


def render_config(config: dict, **fields) -> RenderConfig:
    """The program's RenderConfig of ``config``; ``fields`` set the rest
    (the traffic's ``remat_bounces``, a renderer's ``seed``)."""
    return RenderConfig(width=int(config["width"]), height=int(config["height"]),
                        max_depth=int(config["max_depth"]), **config["integrator"],
                        sky_bottom=tuple(config["sky"]["bottom"]),
                        sky_top=tuple(config["sky"]["top"]), **fields)
