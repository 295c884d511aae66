"""What the benchmark asks of the reference: rendered pixels, displayed
pixels and a training step's loss and gradients, each from a configuration,
the seeds the program was given and nothing else.

``dtype`` is the precision of the trace, from the primary rays on: float32
for the reference, a lower one for the control that the comparison has to
refuse. The camera's rays are made in float32 either way (a camera matrix
in bfloat16 collapses the near and far planes into one: no ray at all).
"""

from __future__ import annotations

import torch

from benchmark.reference import rng
from benchmark.reference.scene import Scene, camera_inverses, primary_rays, world_triangles
from benchmark.reference.trace import Consts, Tracer, average_weights, clamp_sample

#: rays a trace call takes at once (the search's temporaries scale with it)
RAYS_PER_CALL = 1 << 20


def consts_of(config: dict) -> Consts:
    return Consts(**{k: float(torch.tensor(v, dtype=torch.float32))
                     for k, v in config["integrator"].items()})


def _camera(scene: Scene, params):
    return camera_inverses(params["cam_position"], params["cam_forward"], params["cam_fov"],
                           scene.width, scene.height, scene.znear, scene.zfar)


def render_pixels(config: dict, scene: Scene, pixels, samples, dtype=torch.float32):
    """The running average, as the program accumulates it, of the clamped
    samples ``samples`` — (int seed, running-average index n) in order, n
    from 1 — at the pixels numbered ``pixels`` (int64, row-major): (P, 3)
    float32 linear colour. Sample (s, n) draws Philox pair k of pixel p as
    (s, p, n, k)."""
    with torch.no_grad():
        W = scene.width
        params = scene.params
        tracer = Tracer(scene, world_triangles(scene, params["transforms"]), params,
                        consts_of(config), int(config["max_depth"]), dtype)
        inverses = _camera(scene, params)
        px = (pixels % W).float()
        py = (pixels // W).float()
        P = pixels.numel()
        lin = torch.zeros((P, 3), dtype=torch.float32, device=pixels.device)
        group = max(1, RAYS_PER_CALL // max(P, 1))
        for g0 in range(0, len(samples), group):
            part = samples[g0:g0 + group]
            jx, jy = zip(*(rng.pair(s, n, pixels, 0) for s, n in part))
            jx = torch.cat(jx) - 0.5
            jy = torch.cat(jy) - 0.5
            o, d = primary_rays(inverses, scene.width, scene.height, px.repeat(len(part)),
                                py.repeat(len(part)), jx, jy)

            def uniforms(b, part=part):
                u = [rng.pair(s, n, pixels, 1 + b) for s, n in part]
                return torch.cat([a for a, _ in u]), torch.cat([c for _, c in u])

            cols = clamp_sample(tracer.colour(o, d, uniforms)).reshape(len(part), P, 3)
            for (_, n), c in zip(part, cols):
                inv_n, w_old = average_weights(n)
                lin = c * inv_n + lin * w_old
        return lin


def to_display(linear):
    """Linear colour to display bytes: sqrt gamma, x255, truncated."""
    return (255.0 * torch.clamp(torch.sqrt(torch.clamp(linear, min=0.0)), 0.0, 1.0)).to(torch.uint8)


def mse_step(config: dict, scene: Scene, target, seed: int, spp: int,
             dtype=torch.float32, block_rows: int = 128):
    """(loss, gradients by the keys of `Scene.params`) of mean((mean_s I_s - target)^2)
    over the (H*W, 3) image, I_s raw sample s, whose Philox draws are keyed
    (seed, pixel, s, k). Computed in blocks of ``block_rows`` pixel rows, each
    block's part of the loss back-propagated on its own."""
    H, W = scene.height, scene.width
    dev = scene.device
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params.items()}
    world = world_triangles(scene, leaves["transforms"])
    inverses = _camera(scene, leaves)
    world_leaf = world.detach().to(dtype).requires_grad_(True)
    inv_leaves = [m.detach().requires_grad_(True) for m in inverses]
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    n_values = H * W * 3
    for y0 in range(0, H, block_rows):
        rows = min(block_rows, H - y0)
        pixels = torch.arange(y0 * W, (y0 + rows) * W, device=dev)
        P = pixels.numel()
        px, py = (pixels % W).float().repeat(spp), (pixels // W).float().repeat(spp)
        # a tracer a block: its casts and tables are this block's graph
        tracer = Tracer(scene, world_leaf, leaves, consts_of(config), int(config["max_depth"]),
                        dtype)
        jit = [rng.pair(seed, s, pixels, 0) for s in range(spp)]
        o, d = primary_rays(inv_leaves, W, H, px, py, torch.cat([j[0] for j in jit]) - 0.5,
                            torch.cat([j[1] for j in jit]) - 0.5)

        def uniforms(b):
            u = [rng.pair(seed, s, pixels, 1 + b) for s in range(spp)]
            return torch.cat([a for a, _ in u]), torch.cat([c for _, c in u])

        cols = tracer.colour(o, d, uniforms).reshape(spp, P, 3)
        acc = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        for s in range(spp):  # the program's order of adds
            acc = acc + cols[s]
        part = torch.sum((acc / spp - target[pixels]) ** 2) / n_values
        part.backward()
        loss += part.detach().double()
    torch.autograd.backward(
        [world, *inverses],
        [torch.zeros_like(m) if leaf.grad is None else leaf.grad.to(m.dtype)
         for m, leaf in zip([world, *inverses], [world_leaf, *inv_leaves])])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach()
             for k, v in leaves.items()}
    return float(loss), grads
