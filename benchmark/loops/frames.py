"""Closed interactive-frame loop: `Renderer.draw_frame` back to back, as the
window's frame loop calls it, with the path-tracing engine, ``spp_per_frame``
samples a frame and dispatch-ahead presentation (a call returns the previous
frame's display image); accumulation restarts every ``reset_every`` frames,
as the right mouse button restarts it. The renderer is seeded with the run's
seed, so frame f draws from fold(key_for(seed), f).

Traffic keys: ``spp_per_frame``, ``reset_every``, ``warmup_frames``,
``check_frames`` (returned frames the reference renders: the last and others
drawn from the seed) and ``check_pixels`` (pixels drawn from the seed).

The check: at those pixels of those frames, the displayed bytes against the
reference's display of the same samples. Readings: ``mean_abs``, the mean
absolute difference in display levels; ``share_off``, the share of values
that differ by more than one level.
"""

from __future__ import annotations

import random

import torch

from benchmark import program
from benchmark.reference import api as ref
from benchmark.reference import rng
from benchmark.reference.scene import Scene as RefScene


def setup(run):
    t = run.traffic
    cfg = program.render_config(run.config, seed=run.seed)
    renderer = program.Renderer(program.build_scene(run.config),
                                program.camera(run.config, run.device), cfg,
                                spp_per_frame=int(t["spp_per_frame"]), present_async=True,
                                device=run.device)
    state = {"renderer": renderer, "run": run, "reset_every": int(t["reset_every"]),
             "spp": int(t["spp_per_frame"]), "frame": 0, "kept": [], "seen": 0,
             "pick": random.Random(run.derive(4)), "k": int(t["check_frames"]) - 1}
    for _ in range(int(t["warmup_frames"])):
        _draw(state)
    return state


def _draw(state):
    """One frame; returns (index of the frame drawn, the image returned)."""
    f = state["frame"]
    if f and f % state["reset_every"] == 0:
        state["renderer"].reset()
    img = state["renderer"].draw_frame()
    state["frame"] = f + 1
    return f, img


def call(state, i: int):
    f, img = _draw(state)
    if f == 0:
        return  # the cleared framebuffer
    # a reservoir of k returned frames drawn from the seed, and the latest
    item, res, k = (f - 1, img), state["kept"], state["k"]
    if len(res) < k:
        res.append(item)
    else:
        j = state["pick"].randint(0, state["seen"])
        if j < k:
            res[j] = item
    state["seen"] += 1
    state["last"] = item


def rays(state) -> int:
    c = state["run"].config
    return int(c["width"]) * int(c["height"]) * state["spp"] * int(c["max_depth"])


def outputs(state):
    frames = list(state["kept"])
    if "last" in state:
        frames.append(state["last"])
    return {"frames": sorted(dict(frames).items()), "spp": state["spp"],
            "reset_every": state["reset_every"]}


def samples_of(run, frame: int, spp: int, reset_every: int):
    """(sample seed, running-average index) of the samples accumulated when
    frame ``frame`` is displayed."""
    start = frame - frame % reset_every
    out = []
    for f in range(start, frame + 1):
        for s, seed in enumerate(rng.sample_seeds(rng.frame_seed(run.seed, f), spp)):
            out.append((seed, spp * (f - start) + s + 1))
    return out


def check(run, kept, dtype):
    if not kept["frames"]:
        raise RuntimeError("the window returned no frame to check")
    scene = RefScene.from_config(run.config, run.device)
    pix = run.pixels(int(run.traffic["check_pixels"]))
    diffs = []
    for frame, img in kept["frames"]:
        samples = samples_of(run, frame, kept["spp"], kept["reset_every"])
        want = ref.to_display(ref.render_pixels(run.config, scene, pix.to(run.device),
                                                samples)).cpu()
        got = torch.as_tensor(img).reshape(-1, 3)[pix]
        if dtype != torch.float32:
            got = ref.to_display(ref.render_pixels(run.config, scene, pix.to(run.device),
                                                   samples, dtype)).cpu()
        diffs.append((got.to(torch.int32) - want.to(torch.int32)).abs().reshape(-1))
    d = torch.cat(diffs).double()
    return {"mean_abs": float(d.mean()), "share_off": float((d > 1.0).double().mean())}
