"""Closed training loop: `mse_step` calls back to back, as a scene fit takes
its steps, on fixed parameters (every leaf of `differentiable_params`) and a
fixed target; step i takes its own seed, so every step draws anew.

Traffic keys: ``spp`` (samples a step), ``remat_bounces``, ``warmup_steps``,
``check_steps`` (steps the reference follows) and ``block_rows`` (the
reference's rows a block).

The check: the loss and every gradient leaf of ``check_steps`` timed steps,
the last and others drawn from the seed, against the reference's step with
the same seed. Readings, the worst over those steps: ``loss_rel``, |L - L_ref|
/ |L_ref|; ``grad_norm_gap``, over the leaves, | |g| - |g_ref| | / max(|g_ref|,
the median leaf's |g_ref|); ``grad_diff``, the same with |g - g_ref| on top.
"""

from __future__ import annotations

import math
import random
import statistics
import sys

import torch

from benchmark import program
from benchmark.reference import api as ref
from benchmark.reference.scene import Scene as RefScene


def target_image(config: dict, seed: int, device):
    """A smooth (H*W, 3) image in [0, 1] from the seed: per channel
    0.5 + 0.5 sin(2 pi (fx x / W + fy y / H) + phase)."""
    H, W = int(config["height"]), int(config["width"])
    g = torch.Generator().manual_seed(seed)
    f = (torch.rand((3, 3), generator=g, dtype=torch.float64) * torch.tensor([3.0, 3.0, 6.3])
         ).tolist()
    y = torch.arange(H, device=device, dtype=torch.float32)[:, None] / H
    x = torch.arange(W, device=device, dtype=torch.float32)[None, :] / W
    chans = [0.5 + 0.5 * torch.sin(2.0 * math.pi * (fx * x + fy * y) + ph) for fx, fy, ph in f]
    return torch.stack(chans, dim=-1).reshape(H * W, 3)


def setup(run):
    t = run.traffic
    scene = program.build_scene(run.config)
    packet = scene.build_packet(device=run.device)
    cam = program.camera(run.config, run.device)
    state = {
        "packet": packet, "cam": cam, "params": program.differentiable_params(packet, cam),
        "cfg": program.render_config(run.config, remat_bounces=bool(t["remat_bounces"])),
        "target": target_image(run.config, run.derive(1), run.device),
        "spp": int(t["spp"]), "run": run, "out": {},
    }
    for w in range(int(t["warmup_steps"])):
        program.mse_step(state["params"], packet, cam, state["target"], state["cfg"],
                         seed=run.derive(2, w), spp=state["spp"])
    return state


def step_seed(run, i: int) -> int:
    return run.derive(3, i)


def call(state, i: int):
    run = state["run"]
    state["out"][i] = program.mse_step(state["params"], state["packet"], state["cam"],
                                       state["target"], state["cfg"], seed=step_seed(run, i),
                                       spp=state["spp"])


def rays(state) -> int:
    c = state["run"].config
    return int(c["width"]) * int(c["height"]) * state["spp"] * int(c["max_depth"])


def outputs(state):
    run = state["run"]
    steps = sorted(state["out"])
    n = min(int(run.traffic["check_steps"]), len(steps))
    pick = [steps[-1]] + random.Random(run.derive(4)).sample(steps[:-1], n - 1)
    return {"target": state["target"].cpu(), "spp": state["spp"],
            "steps": {k: (float(state["out"][k][0]), {n_: g.detach().cpu() for n_, g in
                                                       state["out"][k][1].items()})
                      for k in sorted(pick)}}


def check(run, kept, dtype):
    scene = RefScene.from_config(run.config, run.device)
    target = kept["target"].to(run.device)
    block = int(run.traffic["block_rows"])
    worst = {"loss_rel": 0.0, "grad_norm_gap": 0.0, "grad_diff": 0.0}
    for i, (loss, grads) in kept["steps"].items():
        r_loss, r_grads = ref.mse_step(run.config, scene, target, step_seed(run, i), kept["spp"],
                                       block_rows=block)
        if dtype != torch.float32:  # the control in the program's place
            loss, grads = ref.mse_step(run.config, scene, target, step_seed(run, i),
                                       kept["spp"], dtype=dtype, block_rows=block)
        gap, diff, note = leaf_gaps(grads, r_grads)
        print(f"train check: step {i}, {note}, loss {loss!r} against {r_loss!r}",
              file=sys.stderr)
        for k, v in (("loss_rel", abs(loss - r_loss) / abs(r_loss)), ("grad_norm_gap", gap),
                     ("grad_diff", diff)):
            worst[k] = max(worst[k], v if math.isfinite(v) else math.inf)
    return worst


def leaf_gaps(grads: dict, ref_grads: dict):
    """(worst | |g| - |g_ref| |, worst |g - g_ref|) over the leaves, each as a
    share of max(|g_ref| of the leaf, the median leaf's |g_ref|), and a note
    naming the worst leaf and any leaf that is missing, misshapen or not
    finite on either side (those read infinity)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grads.items()}
    floor = statistics.median(norms.values())
    gap = diff = 0.0
    worst, bad = "", []
    for k, r in ref_grads.items():
        g = grads.get(k)
        if g is None or tuple(g.shape) != tuple(r.shape):
            bad.append(f"{k}: missing or misshapen")
            continue
        g, r = g.double().cpu(), r.double().cpu()
        if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(r).all())):
            bad.append(f"{k}: {int((~torch.isfinite(g)).sum())} program and "
                       f"{int((~torch.isfinite(r)).sum())} reference entries not finite")
            continue
        den = max(norms[k], floor)
        d = float(torch.linalg.vector_norm(g - r)) / den
        gap = max(gap, abs(float(torch.linalg.vector_norm(g)) - norms[k]) / den)
        if d >= diff:
            diff, worst = d, k
    if bad:
        return math.inf, math.inf, "; ".join(bad)
    return gap, diff, f"worst leaf {worst}"
