"""Closed loop of the dual pipeline's training step (BASELINE configuration
5): `make_dual_train_step`'s step called back to back on a mesh of one rank,
as a scene fit that steers the path tracer's photometric loss with SoftRas
silhouettes takes its steps, on fixed parameters (every leaf of
`differentiable_params`) and a fixed target; step i takes its own threefry
key, so every step draws anew.

Configuration: the scene keys of a path-traced configuration and a
``raster`` block (``supersample``, ``sigma``, ``raster_weight`` and the
rasterizer's shading). Traffic keys: ``spp``, ``remat_bounces`` (read past
spp 1), ``warmup_steps``, ``check_steps`` and ``block_rows`` (the
reference's pixel rows a block).

A program whose dual step does not give each raster drawcall its own
model's parameters draws another scene than the reference; setup refuses
it at once (`program_dual.draws_each_model`).

The check: the loss and every gradient leaf of ``check_steps`` timed steps
against `reference.dual.dual_step` under the same key, read as the training
loop reads them (`train.leaf_gaps`).
"""

from __future__ import annotations

import math
import random
import sys

import torch

from benchmark import program_dual as program
from benchmark.loops import train
from benchmark.reference import dual as ref
from benchmark.reference import rng
from benchmark.reference.scene import Scene as RefScene


def step_seed(run, i: int) -> int:
    return run.derive(3, i)


def setup(run):
    if not program.draws_each_model():
        raise RuntimeError("this program's dual step draws the analytic spheres with another "
                           "model's transform: it cannot run the dual configuration")
    c, t = run.config, run.traffic
    r = c["raster"]
    scene = program.build_scene(c)
    packet = scene.build_packet(device=run.device)
    raster_packet = scene.build_packet(spheres_as_triangles=True, device=run.device)
    cam = program.camera(c, run.device)
    mesh = program.make_mesh(tuple(c["mesh"]), device_type=run.device.type)
    H, W = int(c["height"]), int(c["width"])
    state = {
        "packet": packet, "raster_packet": raster_packet, "run": run, "out": {},
        "params": program.differentiable_params(packet, cam),
        "target": train.target_image(c, run.derive(1), run.device).reshape(H, W, 3),
        "spp": int(t["spp"]),
        "step": program.make_dual_train_step(
            mesh, cam, program.render_config(c, remat_bounces=bool(t["remat_bounces"])),
            program.raster_config(c), spp=int(t["spp"]),
            raster_weight=float(r["raster_weight"]), sigma=float(r["sigma"])),
    }
    for w in range(int(t["warmup_steps"])):
        _step(state, program.key_for(run.derive(2, w)))
    return state


def _step(state, key):
    return state["step"](state["params"], state["packet"], state["raster_packet"],
                         state["target"], key)


def call(state, i: int):
    state["out"][i] = _step(state, program.key_for(step_seed(state["run"], i)))


def rays(state) -> int:
    c = state["run"].config
    return int(c["width"]) * int(c["height"]) * state["spp"] * int(c["max_depth"])


def outputs(state):
    run = state["run"]
    steps = sorted(state["out"])
    n = min(int(run.traffic["check_steps"]), len(steps))
    pick = [steps[-1]] + random.Random(run.derive(4)).sample(steps[:-1], n - 1)
    return {"target": state["target"].reshape(-1, 3).cpu(), "spp": state["spp"],
            "steps": {k: (float(state["out"][k][0]), {n_: g.detach().cpu() for n_, g in
                                                       state["out"][k][1].items()})
                      for k in sorted(pick)}}


def check(run, kept, dtype):
    scene = RefScene.from_config(run.config, run.device)
    target = kept["target"].to(run.device)
    block = int(run.traffic["block_rows"])
    worst = {"loss_rel": 0.0, "grad_norm_gap": 0.0, "grad_diff": 0.0}
    for i, (loss, grads) in kept["steps"].items():
        key = rng.key_for(step_seed(run, i))
        r_loss, r_grads = ref.dual_step(run.config, scene, target, key, kept["spp"],
                                        block_rows=block)
        if dtype != torch.float32:  # the control in the program's place
            loss, grads = ref.dual_step(run.config, scene, target, key, kept["spp"],
                                        dtype=dtype, block_rows=block)
        gap, diff, note = train.leaf_gaps(grads, r_grads)
        print(f"dual check: step {i}, {note}, loss {loss!r} against {r_loss!r}",
              file=sys.stderr)
        for k, v in (("loss_rel", abs(loss - r_loss) / abs(r_loss)), ("grad_norm_gap", gap),
                     ("grad_diff", diff)):
            worst[k] = max(worst[k], v if math.isfinite(v) else math.inf)
    return worst
