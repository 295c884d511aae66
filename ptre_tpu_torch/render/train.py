"""Single-device differentiable training steps (`ptre_tpu/render/train.py`).

Two exact schedules for the image-MSE loss L = mean((M - T)^2), with the
mean image M = (1/S) sum_s I_s over S samples per pixel:

* `mse_step` — one autograd graph over all samples. At spp > 1 each
  sample is a `gradsafe.remat` region, as the reference checkpoints its
  sample scan's body (`train.py:94-96`): the forward keeps no sample's
  residuals, and the backward recomputes one sample at a time (one more
  forward a sample: a recording launch on the fused route, the staged
  route's sweeps and bounces), so the memory does not grow with spp. At spp
  1 the sample is a direct call (`train.py:91-93`). The reference
  checkpoints whatever its config says; here ``remat_bounces=False`` keeps
  every sample's residuals instead, as it does in the sharded steps
  (`sharding.py:278-282`): memory that grows with spp for one forward a
  sample less.

* `two_pass_mse_step` — constant memory in the sample count:

      pass 1:  M = (1/S) sum_s I_s(theta)             (forward only)
      cot    = dL/dI_s = 2 (M - T) / (N S)            (the same for every s)
      pass 2:  dL/dtheta = sum_s cot . dI_s/dtheta    (one backward per chunk)

  The exact gradient: dM/dI_s = 1/S does not depend on s, so the cotangent
  factors out of the sum (validated against `mse_step`).

`raster_mse_step` is the rasterizer's counterpart: the image MSE of the
SoftRas path, one launch each of its forward and backward kernels.

Each step routes its packet once (`integrator.grad_route`, by
``config.grad_sweep`` and the packet's counts). On the fused route, on CUDA
tensors, a sample of a dense-class packet is one launch of the recording
kernel and one of the fused backward kernel (`ops/cuda/fused_grad`); a
sample of a triangle-scale packet runs the wavefront in record mode (a mask
and a bounce launch per live bounce) and one launch of the backward kernel's
global-table instantiation; the scene is packed (world-space triangles,
Morton sort, boxes) once per step, without a graph: only the unified table
carries gradients to the packet. On the replay route
(``grad_sweep="replay"``, dense-class packets) a sample is one launch each
of the recording kernel, the replay forward and the replay backward kernels
(`ops/cuda/replay_kernel`), with the winners' rows gathered between them
(`path_replay.gather_rows`); the scene is packed once per step as on the
fused route. On the staged route — every packet past the fused kernels'
limits (`wavefront.supports`), max_depth past 8, or ``grad_sweep="staged"``
— a sample is `integrator.trace_staged`,
one sweep launch a bounce and autograd through the rest. On CPU tensors the plain versions run. Random numbers: per sample s,
the port's Philox keyed by (seed, pixel, s, draw) — draw 0 the pixel jitter,
draw 1 + b bounce b — or given uniforms ``urand`` (S, 2 + 2*max_depth, H, W),
the layout of `render/pathtracer.render_step`; or, on the staged route, a
threefry ``seed`` (`rng.Key`), which keys sample s ``fold(key, s)`` and
draws as the reference does (`train.py:56-126`).

Not carried over from the reference: the dead ``n = target.size`` of
``mse_step``, the ``spp % samples_per_call`` assert (a ragged last chunk
runs instead) and the ``samples_per_call = 8`` default, which bounded the
length of one TPU dispatch; here a chunk only sets how many samples' graphs
one backward holds.
"""

from __future__ import annotations

import torch

from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import gradsafe, integrator, rng
from ptre_tpu_torch.ops.cuda import fused_grad
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import rasterizer
from ptre_tpu_torch.utils.metrics import span


def pack_forward(params, packet, cam):
    """The step's packed forward (`fused_grad.prepare_forward`) of the packet
    and camera with ``params`` applied: every sample of a step shares it."""
    pk, cm = sh.apply_params(params, packet, cam)
    return fused_grad.prepare_forward(pk, screen_cam=cm)


def _forward_of(params, packet, cam, config):
    """`pack_forward` where the step takes the fused or the replay route
    (both record with a packed forward), else None."""
    if integrator.grad_route(config, packet) in ("fused", "replay"):
        with span("ptre.train.pack"):
            return pack_forward(params, packet, cam)
    return None


def sample_color(params, packet, cam, config, seed, sample: int,
                 urand=None, forward=None):
    """One jittered sample per pixel → RAW linear color (H*W, 3), row-major.

    ``params`` (`sharding.differentiable_params`) override the packet's and
    camera's leaves; the color is unclamped (training integrates in linear
    space). ``seed``: an int, or an `rng.Key` (staged route: this sample is
    keyed ``fold(seed, sample)``, the jitter ``pixel_jitter(fold(., 0x9E37))``
    as in `train.py:56-70`). ``urand``: this sample's (2 + 2*max_depth, H,
    W) uniforms, rows 0-1 the pixel jitter + 0.5; None draws Philox keyed by
    (seed, pixel, sample, draw). ``forward``: `pack_forward` of the same
    ``params``, when a caller renders several samples of them.

    The sample is the span ``ptre.train.sample``, inside the function, so
    that a `gradsafe.remat` region's recompute in the backward opens it
    again.
    """
    with span("ptre.train.sample"):
        pk, cm = sh.apply_params(params, packet, cam)
        dev = packet.device
        R = cm.height * cm.width
        px, py = pt.pixel_grid(cm.height, cm.width, dev)
        if isinstance(seed, rng.Key):
            key = rng.fold(seed, sample)
            o, d = cam_ops.get_rays(cm, px, py,
                                    rng.pixel_jitter(rng.fold(key, 0x9E37), (R,), dev))
            return integrator.trace(o, d, pk, config, key=key)
        if urand is None:
            jit = rng.ray_uniforms(seed, sample, R, 1, dev)
        else:
            urand = urand.reshape(2 + 2 * config.max_depth, R)
            jit = urand[:2]
        o, d = cam_ops.get_rays(cm, px, py, (jit - 0.5).T)
        return integrator.trace(o, d, pk, config, seed, sample, urand, screen_cam=cm,
                                forward=forward)


def _leaves(params):
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _grad_dict(out, leaves):
    with span("ptre.train.backward"):
        grads = torch.autograd.grad(out, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def mse_step(params, packet, cam, target, config, seed, spp: int = 1,
             urand=None):
    """(loss, grads) of the image MSE at ``spp`` samples, one graph.

    ``target``: (H*W, 3) linear, row-major. ``seed``: an int or an
    `rng.Key` (`sample_color`). ``urand``: optional (spp, 2 + 2*max_depth,
    H, W) uniforms. Returns the loss as a 0-d tensor and a dict of gradients
    with ``params``' keys. At spp > 1, under ``config.remat_bounces``,
    every sample is rematerialised (module docstring); the packed forward
    is made once, outside. Under a profiler the step is the span
    ``ptre.train.step``, and in it ``ptre.train.pack`` (the packed
    forward), ``ptre.train.forward`` (the samples and the loss) and
    ``ptre.train.backward``, in which a rematerialised sample's recompute
    opens ``ptre.train.sample`` again.
    """
    with span("ptre.train.step"):
        integrator.check_grad_dispatch(packet, target.device, config)
        leaves = _leaves(params)
        forward = _forward_of(leaves, packet, cam, config)
        remat = spp > 1 and config.remat_bounces
        with span("ptre.train.forward"):
            acc = torch.zeros_like(target)
            for s in range(spp):
                args = (leaves, packet, cam, config, seed, s,
                        None if urand is None else urand[s], forward)
                acc = acc + (gradsafe.remat(sample_color, *args) if remat
                             else sample_color(*args))
            loss = torch.mean((acc / spp - target) ** 2)
        return loss.detach(), _grad_dict(loss, leaves)


def two_pass_mse_step(params, packet, cam, target, config, seed,
                      spp: int = 64, samples_per_call: int = 1, urand=None):
    """Exact (loss, grads) of the image MSE with memory independent of spp.

    Pass 1 renders the mean image without a graph; pass 2 backpropagates the
    fixed cotangent 2 (M - T) / (N S) through ``samples_per_call`` samples at
    a time (the last chunk may be shorter). One sample per backward keeps
    the memory at one sample's graph, the point of this schedule.
    """
    integrator.check_grad_dispatch(packet, target.device, config)
    c = max(1, min(samples_per_call, spp))
    forward = _forward_of(params, packet, cam, config)

    def urand_of(s):
        return None if urand is None else urand[s]

    with torch.no_grad():
        acc = torch.zeros_like(target)
        for s in range(spp):
            acc = acc + sample_color(params, packet, cam, config, seed, s,
                                     urand_of(s), forward)
        mean_img = acc / spp
        loss = torch.mean((mean_img - target) ** 2)
        cot = 2.0 * (mean_img - target) / (target.numel() * spp)

    grads = None
    for s0 in range(0, spp, c):
        leaves = _leaves(params)
        part = sum(torch.sum(sample_color(leaves, packet, cam, config, seed, s,
                                          urand_of(s), forward) * cot)
                   for s in range(s0, min(s0 + c, spp)))
        g = _grad_dict(part, leaves)
        grads = g if grads is None else {k: grads[k] + g[k] for k in grads}
    return loss, grads


#: the parameters the rasterizer reads: the drawcall transforms and the camera
RASTER_PARAM_KEYS = ("transforms", "cam_position", "cam_forward", "cam_fov")


def raster_mse_step(params, raster_packet, cam, target, raster_config, sigma: float = 0.5):
    """(loss, grads) of the soft rasterizer's image MSE,
    mean((rasterize(soft=True) - target)^2), with ``target`` (H, W, 3): the
    raster term of the reference's ``dual_train_step``
    (`ptre_tpu/parallel/sharding.py:377-445`) on one device. ``params``
    (`sharding.differentiable_params`) override the raster packet's
    transforms (it shares them with the path-traced packet) and the camera;
    ``grads`` holds the RASTER_PARAM_KEYS. On CUDA tensors one launch each
    of the soft forward and backward kernels."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in RASTER_PARAM_KEYS}
    pkt, cm = sh.apply_params({**params, **leaves}, raster_packet, cam)
    img = rasterizer.rasterize(pkt, cm, raster_config, soft=True, sigma=sigma)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(RASTER_PARAM_KEYS, grads))
