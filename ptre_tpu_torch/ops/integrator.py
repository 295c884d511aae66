"""Path-tracing integrator: per-sample post-processing and the
differentiable trace (`ptre_tpu/ops/integrator.py`).

`trace` routes a packet as the reference's ``_grad_route`` does
(`integrator.py:49-79`, `RenderConfig.grad_sweep`):

  * "fused": the fused gradient path (`ops/cuda/fused_grad.trace_grad`), a
    recording forward — the dense recording kernel, or for triangle-scale
    packets the wavefront in record mode — and the fused backward kernel;
    taken by "auto" and "fused" for every packet it supports;
  * "replay": the planar replay route (`ops/path_replay.trace_fused_grad`),
    the dense recording kernel's selections replayed over winner rows
    gathered outside the replay kernels (`ops/cuda/replay_kernel`); taken by
    ``grad_sweep="replay"`` for dense-class packets only, as the reference
    keeps it for A/B checks of the fused route (`integrator.py:69-73`);
  * "staged": `trace_staged`, the per-bounce sweep plus autograd
    (`integrator.py:110-168`), always available: every packet past the
    fused kernels' limits (more leaves than the mask kernel takes, or more
    materials than float32 ids hold, `wavefront.supports`), every packet
    under ``grad_sweep="staged"``, every packet past the dense class under
    ``grad_sweep="replay"``, and every trace deeper than the kernels' ``megakernel.MAX_DEPTH`` (8)
    bounces under any ``grad_sweep``.

The staged route's sweep is the sweep kernel (`ops/cuda/sweep_kernel.py`)
on CUDA tensors and its plain version on CPU tensors
(``intersect_backend`` "auto", "pallas", "fused"); "xla" asks for the plain
sweep, which on the card would be a hidden fallback with (R, T)
temporaries, so it raises there. Each bounce sweeps only the rays still
live: a dead ray's selection is never read, its factor being masked out.
CUDA tensors run kernels, CPU tensors their plain versions, for both
routes.

Random numbers of the staged route, bounce b's scatter pair: with a
threefry ``key`` (`rng.Key`) exactly the reference's draws,
``cosine_weighted(fold(key, b), (R,))``; else the port's Philox pair 1 + b
keyed by (seed, ray, sample), or rows 2 + 2b and 3 + 2b of ``urand`` — the
draws of the fused route, so on one packet both routes trace the same
paths.

Rematerialisation (``config.remat_bounces``, default True, as in the
reference's `integrator.py:149-156`): under autograd each staged bounce is
split in two. Its sweep and its draws run outside, without a graph; the
differentiable rest — the closest-hit recompute from the sweep's winners,
the material gather, the scatter, the sky and the next (o, d, colour,
active) — runs in a `gradsafe.remat` region. The backward then keeps a
bounce's inputs (about 60 bytes a ray) instead of its ~20 (R, 3)
residuals (about 6.6 KB a ray a sample at max_depth 5), and recomputes the
region from the same winners: the sweep kernel is not run again. With
``remat_bounces=False`` every bounce's residuals are kept.
"""

from __future__ import annotations

import torch

from ptre_tpu_torch.ops import gradsafe, intersect, materials, path_replay, rng
from ptre_tpu_torch.ops.cuda import fused_grad
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import sweep_kernel
from ptre_tpu_torch.ops.cuda.take_rows import take_rows
from ptre_tpu_torch.utils.errors import ConfigError


def postprocess_sample(color, clamp: bool = True):
    """Per-sample clamp to [0, 1] + non-finite scrub (`path_tracer.cu:345-353`,
    `integrator.py:171-188`): NaN and ±inf become 0 in both modes, so an
    unclamped inf sample cannot poison the running average."""
    if clamp:
        color = torch.clamp(color, 0.0, 1.0)
    return torch.where(torch.isfinite(color), color, torch.zeros_like(color))


def grad_route(config, packet) -> str:
    """"fused", "replay" or "staged" for a differentiable trace of
    ``packet`` (`integrator.py:49-79`), from the config and the packet's
    counts alone, on any device. The fused and replay kernels keep state for
    at most `megakernel.MAX_DEPTH` bounces: deeper traces take "staged", as
    the reference's ``fits(packet, max_depth)`` gate sends a packet whose
    backward does not fit (`fused_grad.py:69-83`)."""
    mode = config.grad_sweep
    if mode == "staged" or config.max_depth > mk.MAX_DEPTH:
        return "staged"
    if mode == "replay":
        return "replay" if mk.dense_supported(packet) else "staged"
    return "fused" if fused_grad.supported(packet) else "staged"


def check_staged_sweep(config, device) -> None:
    """Raise ConfigError where the staged route has no sweep for
    ``config.intersect_backend`` on ``device``: "xla" (the plain sweep) on
    CUDA tensors."""
    if torch.device(device).type == "cuda" and config.intersect_backend == "xla":
        raise ConfigError(
            "intersect_backend='xla' runs the plain sweep, with (rays x triangles) "
            "temporaries, and is refused on CUDA tensors; use 'auto' or 'pallas' "
            "(the sweep kernel)")


def check_grad_dispatch(packet, device, config=None) -> None:
    """Raise unless `trace` has a path for this packet on ``device`` under
    ``config`` (None: the defaults). Touches no tensor."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"trace runs on cuda or cpu, not {device}")
    if config is not None and grad_route(config, packet) == "staged":
        check_staged_sweep(config, device)


def _sweep_fn(scene, consts, active):
    """``closest_hit``'s sweep over the leaf table packed once per trace, of
    the rays ``active`` at this bounce: a dead ray is not swept and selects
    nothing (its factor is masked out of the colour)."""
    def fn(o, d, packet, world_tris, t_min, t_max, det_eps):
        return sweep_kernel.sweep_packed(o.contiguous(), d.contiguous(), scene,
                                         consts.t_min, consts.t_max, consts.det_eps, active)
    return fn


def _bounce(o, d, color, active, i_tri, hit_tri, i_sph, hit_sph, u1, u2, v0, v1, v2, n0,
            n1, n2, mat_table, mat_kind, packet, consts):
    """The differentiable part of one staged bounce, from the sweep's
    winners (``i_tri`` .. ``hit_sph``) and the scatter pair ``u1``, ``u2``:
    the closest-hit recompute on the world-space triangles ``v0`` .. ``n2``,
    the material gather, the scatter and the sky → the next (o, d, colour,
    active). Every per-sample tensor comes in as an argument of its own: a
    `gradsafe.remat` region keeps its tensor arguments as saved tensors,
    which an enclosing region (a sample's) drops and recomputes, but holds
    any other argument (a tuple) until the backward."""
    winners = (i_tri, hit_tri, i_sph, hit_sph)
    hit = intersect.closest_hit(o, d, packet, (v0, v1, v2, n0, n1, n2), consts.t_min,
                                consts.t_max, consts.det_eps, sweep_fn=lambda *_: winners)
    mat = take_rows(mat_table, hit.mat_id)
    srec = materials.scatter(u1, u2, d, hit.position, hit.normal, mat_kind[hit.mat_id],
                             mat[:, 0:3], mat[:, 3], consts.shadow_eps, consts.pdf_eps)
    sky = materials.sky_attenuation(d, packet.sky_bottom, packet.sky_top)
    # cos/pdf is the constant pi in every branch: its exact gradient is 0
    hit_factor = gradsafe.cosine_ratio(srec.cos_weight, srec.pdf)[:, None] * srec.attenuation
    factor = torch.where(hit.hit[:, None], hit_factor, sky)
    color = color * torch.where(active[:, None], factor, torch.ones_like(factor))
    next_active = active & hit.hit & ~srec.terminated
    o = torch.where(next_active[:, None], srec.next_origin, o)
    d = torch.where(next_active[:, None], srec.next_dir, d)
    return o, d, color, next_active


def trace_staged(origins, directions, packet, config, seed: int = 0, sample: int = 0,
                 urand=None, key=None):
    """The staged trace (`integrator.py:110-168`): per bounce the detached
    sweep, the differentiable closest-hit recompute, the scatter and the
    sky, as a masked loop over ``max_depth`` bounces → linear colour (R, 3),
    differentiable w.r.t. the rays and the packet's float leaves. Draws:
    ``key`` (`rng.Key`), else ``urand`` (2 + 2*max_depth, R), else Philox
    keyed by (seed, ray, sample) (module docstring). Under autograd and
    ``config.remat_bounces`` each bounce's differentiable part is a
    `gradsafe.remat` region (module docstring)."""
    check_staged_sweep(config, origins.device)
    consts = mk.TraceConsts.from_config(config)
    R = origins.shape[0]
    world_tris = packet.world_triangles()  # hoisted: shared by every bounce
    detached_tris = tuple(w.detach() for w in world_tris)
    scene = sweep_kernel.prepare(packet)
    if key is None:
        ur = mk.trace_uniforms(origins, config.max_depth, seed, sample, urand)
    mat_kind = packet.mat_kind.long()
    mat_table = torch.cat([packet.mat_albedo, packet.mat_param[:, None]], dim=1)
    remat = config.remat_bounces and torch.is_grad_enabled()
    o, d = origins, directions
    color = torch.ones((R, 3), dtype=torch.float32, device=origins.device)
    active = torch.ones((R,), dtype=torch.bool, device=origins.device)
    for b in range(config.max_depth):
        with torch.no_grad():
            winners = _sweep_fn(scene, consts, active)(
                o.detach(), d.detach(), packet, detached_tris, consts.t_min, consts.t_max,
                consts.det_eps)
        if key is not None:
            u1, u2 = rng.cosine_uniforms(rng.fold(key, b), (R,), origins.device)
        else:
            u1, u2 = ur[2 + 2 * b], ur[3 + 2 * b]
        args = (o, d, color, active, *winners, u1, u2, *world_tris, mat_table, mat_kind,
                packet, consts)
        o, d, color, active = gradsafe.remat(_bounce, *args) if remat else _bounce(*args)
    return color


def trace(origins, directions, packet, config, seed: int = 0, sample: int = 0,
          urand=None, screen_cam=None, forward=None, key=None):
    """Trace one sample per ray → linear color (R, 3), differentiable
    w.r.t. the rays and the packet's float leaves, by `grad_route`.

    ``seed``/``sample`` key the Philox draws (seed, ray, sample, draw);
    ``urand`` (2 + 2*max_depth, R) replaces them (parity runs); ``key``, an
    `rng.Key`, makes the staged route draw as the reference does (the fused
    and replay kernels draw Philox: a key there raises). ``screen_cam``: the
    camera whose jittered per-pixel rays (origins, directions) are, in
    row-major order; lets the triangle-scale fused forward bin bounce 0 in
    screen space, the image is unchanged. ``forward``: the packet packed once by
    `fused_grad.prepare_forward` for many samples (fused and replay routes).
    """
    check_grad_dispatch(packet, origins.device, config)
    route = grad_route(config, packet)
    if route == "staged":
        return trace_staged(origins, directions, packet, config, seed, sample, urand, key)
    if key is not None:
        raise ConfigError(f"a threefry key keys the staged route only: the {route} "
                          "route's kernels draw Philox (pass an int seed, or "
                          "grad_sweep='staged')")
    if route == "replay":
        return path_replay.trace_fused_grad(origins, directions, packet, config, seed,
                                            sample, urand, forward=forward)
    return fused_grad.trace_grad(origins, directions, packet, config, seed,
                                 sample, urand, screen_cam=screen_cam, forward=forward)
