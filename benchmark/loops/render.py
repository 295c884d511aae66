"""Closed progressive-render loop: `render_step` calls back to back into one
accumulator, each adding ``spp`` samples; after ``steps_per_image`` steps the
image is done (copied out, as a renderer hands a finished image on) and the
accumulator restarts. Step i takes its own seed.

Traffic keys: ``spp``, ``steps_per_image``, ``warmup_steps`` and
``check_pixels`` (pixels drawn from the seed that the reference renders).

The check: at those pixels, the last image finished in the window and the
accumulator as the window left it, against the reference's running average
of the same samples. Readings over both: ``mean_abs``, the mean absolute
difference of the linear values; ``share_off``, the share of values that
differ by more than `OFF`.
"""

from __future__ import annotations

import torch

from benchmark import program
from benchmark.reference import api as ref
from benchmark.reference import rng
from benchmark.reference.scene import Scene as RefScene

#: a linear value this far from the reference's counts as off
OFF = 1.0 / 255.0


def setup(run):
    t = run.traffic
    scene = program.build_scene(run.config)
    packet = scene.build_packet(device=run.device)
    cam = program.camera(run.config, run.device)
    cfg = program.render_config(run.config)
    accum = program.AccumState.create(int(run.config["height"]), int(run.config["width"]),
                                      device=run.device)
    state = {"packet": packet, "cam": cam, "cfg": cfg, "accum": accum, "run": run,
             "spp": int(t["spp"]), "per_image": int(t["steps_per_image"]),
             "done": torch.zeros_like(accum.linear), "done_steps": None, "open_steps": []}
    for w in range(int(t["warmup_steps"])):
        state["accum"] = program.render_step(packet, cam, state["accum"], run.derive(2, w), cfg,
                                             spp=state["spp"])
    state["accum"] = state["accum"].reset()
    return state


def step_seed(run, i: int) -> int:
    return run.derive(3, i)


def call(state, i: int):
    run = state["run"]
    state["accum"] = program.render_step(state["packet"], state["cam"], state["accum"],
                                         step_seed(run, i), state["cfg"], spp=state["spp"])
    state["open_steps"].append(i)
    if len(state["open_steps"]) == state["per_image"]:
        state["done"].copy_(state["accum"].linear)
        state["done_steps"], state["open_steps"] = state["open_steps"], []
        state["accum"] = state["accum"].reset()


def rays(state) -> int:
    c = state["run"].config
    return int(c["width"]) * int(c["height"]) * state["spp"] * int(c["max_depth"])


def outputs(state):
    images = []
    for lin, steps in ((state["done"], state["done_steps"]),
                       (state["accum"].linear, state["open_steps"])):
        if steps:
            images.append((lin.detach().reshape(-1, 3).cpu(), list(steps)))
    return {"images": images, "spp": state["spp"]}


def samples_of(run, steps, spp: int):
    """(sample seed, running-average index) of every sample of ``steps``."""
    out = []
    for j, i in enumerate(steps):
        for s, seed in enumerate(rng.sample_seeds(step_seed(run, i), spp)):
            out.append((seed, spp * j + s + 1))
    return out


def check(run, kept, dtype):
    if not kept["images"]:
        raise RuntimeError("the window left no image to check")
    scene = RefScene.from_config(run.config, run.device)
    pix = run.pixels(int(run.traffic["check_pixels"]))
    diffs = []
    for lin, steps in kept["images"]:
        samples = samples_of(run, steps, kept["spp"])
        want = ref.render_pixels(run.config, scene, pix.to(run.device), samples).cpu()
        got = lin[pix]
        if dtype != torch.float32:
            got = ref.render_pixels(run.config, scene, pix.to(run.device), samples, dtype).cpu()
        diffs.append((got.double() - want.double()).abs().reshape(-1))
    d = torch.cat(diffs)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, 1.0))
    return {"mean_abs": float(d.mean()), "share_off": float((d > OFF).double().mean())}
