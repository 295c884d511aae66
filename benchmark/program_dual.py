"""The program's dual pipeline (BASELINE configuration 5) as the benchmark
drives it: a device mesh of one rank, the differentiable dual step made by
`make_dual_train_step`, the rasterizer's configuration, the threefry keys,
and the scene, camera and parameters of `program`.

The dual loop reaches the program only through this module's names, so a
test can put a broken program in its place (`dual_faults`).
"""

from __future__ import annotations

from ptre_tpu_torch.ops.rng import key_for
from ptre_tpu_torch.parallel import sharding
from ptre_tpu_torch.parallel.sharding import make_dual_train_step, make_mesh
from ptre_tpu_torch.render import rasterizer
from ptre_tpu_torch.utils.config import RasterConfig

from benchmark.program import build_scene, camera, differentiable_params, render_config

__all__ = ["build_scene", "camera", "differentiable_params", "draws_each_model", "key_for",
           "make_dual_train_step", "make_mesh", "raster_config", "rasterizer",
           "render_config"]


def raster_config(config: dict) -> RasterConfig:
    """The program's RasterConfig of ``config``'s ``raster`` block."""
    r = config["raster"]
    return RasterConfig(width=int(config["width"]), height=int(config["height"]),
                        supersample=int(r["supersample"]),
                        clear_color=tuple(r["clear_color"]),
                        cull_backfaces=bool(r["cull_backfaces"]),
                        ambient_strength=float(r["ambient_strength"]),
                        light_dir=tuple(r["light_dir"]), albedo=tuple(r["albedo"]))


def draws_each_model() -> bool:
    """Whether the program's dual step gives every raster drawcall its own
    model's parameters (`sharding.raster_transforms`), so that both
    pipelines draw the same scene; a program without it draws every
    analytic sphere with the last triangle model's transform."""
    return hasattr(sharding, "raster_transforms")
