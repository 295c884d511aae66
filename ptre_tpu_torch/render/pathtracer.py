"""Progressive path-tracer frame pipeline.

PyTorch port of `ptre_tpu/render/pathtracer.py`. Three routes, chosen per
packet and config (`route`):

  * dense packets (<= 64 triangles, <= 64 spheres): each sample is one
    launch of the whole-sample render kernel (`ops/cuda/render_kernel.py`);
  * larger packets the wavefront takes (`ops/cuda/wavefront.supports`): each
    sample is `sample_image` — Philox jitter, `camera.get_rays`, the sorted
    wavefront (mask and bounce kernels), clamp and scrub — then the running
    average, with the packing done once per step;
  * every other packet (past the mask kernel's `wavefront.MAX_MASK_LEAVES`
    leaves, or past `megakernel.MAX_MATERIALS` materials, which float32 ids
    hold exactly; the reference's 8-material SMEM select is not carried
    over), and every packet under ``intersect_backend`` "pallas" or "xla":
    the staged route,
    `sample_image_staged` — `ops/integrator.trace_staged`, whose sweep is one
    launch of the sweep kernel a bounce (`ops/cuda/sweep_kernel.py`)
    (`pathtracer.py:101-121`: the reference falls back to it "rather than
    crash").

CUDA tensors run the kernels; CPU tensors their plain PyTorch versions. The
accumulation reproduces the reference render kernel (`path_tracer.cu:330-366`):
per-sample clamp to [0, 1], running average lin = c/n + lin*(n-1)/n, sqrt
display gamma with a truncating uint8 cast. Reset only zeroes the sample
counter; the n = 1 step then overwrites history (`path_tracer.cu:394-400`).
"""

from __future__ import annotations

import dataclasses

import torch

from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator, rng
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.ops.integrator import postprocess_sample
from ptre_tpu_torch.utils.device import resolve
from ptre_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class AccumState:
    """Progressive accumulation state (reference `path_tracer.h:61-62`).

    ``frame`` is a host int (the JAX package keeps a device scalar): the
    per-sample running-average index never needs a device read."""

    linear: torch.Tensor  # (H, W, 3) float32 running-average linear color
    frame: int = 0  # samples accumulated so far (m_crt_frame)

    @classmethod
    def create(cls, height: int, width: int, device=None) -> "AccumState":
        """A zeroed (H, W, 3) accumulator on ``device``: None means the card
        (RendererError where there is none), ``"cpu"`` the host."""
        return cls(linear=torch.zeros((height, width, 3), dtype=torch.float32,
                                      device=resolve(device)), frame=0)

    def reset(self) -> "AccumState":
        """Restart accumulation by zeroing only the counter; the buffer is
        overwritten at n = 1 by the running average."""
        return dataclasses.replace(self, frame=0)


def pixel_grid(height: int, width: int, device=None):
    """Flattened pixel coordinates: x right, y down (pixelid = y*W + x), on
    ``device`` (None: the card, RendererError where there is none)."""
    device = resolve(device)
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def route(packet, config=None) -> str:
    """The route of a packet under ``config`` (None: the defaults): "dense"
    (the render kernel), "wavefront" (the mask and bounce kernels) or
    "staged" (the sweep kernel), from the packet's counts alone.
    ``intersect_backend`` "pallas" or "xla" forces "staged"; otherwise it is
    taken when neither fused route takes the packet (`pathtracer.py:62-121`)."""
    if config is not None and config.intersect_backend in ("pallas", "xla"):
        return "staged"
    if mk.dense_supported(packet):
        return "dense"
    if wf.supports(packet):
        return "wavefront"
    return "staged"


def check_dispatch(packet, device, config=None) -> None:
    """Raise unless ``render_step`` has a path for this packet on ``device``
    under ``config``: every packet has one on CUDA and on the CPU, except
    that the staged route refuses ``intersect_backend="xla"`` on CUDA (the
    plain sweep on the card would be a hidden fallback)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"render_step runs on cuda or cpu, not {device}")
    if config is not None and route(packet, config) == "staged":
        integrator.check_staged_sweep(config, device)


def sample_image(scene: wf.WaveScene, cam, config, seed: int, n: int, urand=None,
                 timer=None):
    """One jittered sample per pixel through the wavefront → clamped linear
    colour (H*W, 3) (`pathtracer.py:74-121`, triangle-scale branch).

    The draws are keyed as the render kernel keys them: pair 0 (the jitter)
    and pair 1 + b (bounce b) by (seed, pixel, n); or ``urand`` (2 + 2 *
    max_depth, H, W), rows 0-1 the jitter plus 0.5. ``timer``: a
    `wavefront.StageTimer` for the trace's stages."""
    H, W = cam.height, cam.width
    dev = scene.tris.device
    px, py = pixel_grid(H, W, dev)
    if urand is None:
        u = rng.ray_uniforms(seed, n, H * W, 1, dev)
    else:
        urand = urand.reshape(urand.shape[0], H * W)
        u = urand[0:2]
    o, d = cam_ops.get_rays(cam, px, py, (u - 0.5).T)
    color = wf.trace(o.contiguous(), d.contiguous(), scene,
                     mk.TraceConsts.from_config(config), config.max_depth, seed, n,
                     urand, tile_hint=(H, W), timer=timer)
    return postprocess_sample(color, config.clamp_samples)


def sample_image_staged(packet, cam, config, seed: int = 0, n: int = 0, urand=None,
                        key=None, ray_chunk: int = 0):
    """One jittered sample per pixel through the staged route → clamped
    linear colour (H*W, 3) (`pathtracer.py:74-121`, staged branch).

    Draws: with ``key`` (`rng.Key`) the reference's, the jitter
    ``pixel_jitter(fold(key, 0x9E37))`` and the bounces keyed from ``key``;
    else as the other routes draw them, pair 0 (the jitter) and pair 1 + b
    (bounce b) by (seed, pixel, n), or ``urand`` (2 + 2*max_depth, H, W).
    ``ray_chunk`` > 0 traces the pixels in chunks of that many rays (the last
    may be shorter), each keyed ``fold(key, chunk)`` in key mode as the
    reference keys them; without a key chunking changes nothing."""
    H, W = cam.height, cam.width
    R = H * W
    dev = packet.device
    px, py = pixel_grid(H, W, dev)
    ur = None
    if key is not None:
        jitter = rng.pixel_jitter(rng.fold(key, 0x9E37), (R,), dev)
    else:
        ur = (rng.ray_uniforms(seed, n, R, 1 + config.max_depth, dev) if urand is None
              else urand.reshape(2 + 2 * config.max_depth, R))
        jitter = (ur[0:2] - 0.5).T
    o, d = cam_ops.get_rays(cam, px, py, jitter)
    chunk = ray_chunk if 0 < ray_chunk < R else R
    parts = []
    for cid, c0 in enumerate(range(0, R, chunk)):
        sl = slice(c0, c0 + chunk)
        if key is not None:
            parts.append(integrator.trace_staged(
                o[sl], d[sl], packet, config, key=key if chunk == R else rng.fold(key, cid)))
        else:
            parts.append(integrator.trace_staged(o[sl], d[sl], packet, config,
                                                 urand=ur[:, sl].contiguous()))
    return postprocess_sample(torch.cat(parts), config.clamp_samples)


def fused_seed(key: rng.Key) -> int:
    """The int seed that ``key`` gives the dense and wavefront routes: the
    twin of the reference's ``randint(fold(key, 0x5EED), (), 0, 2**31 - 1)``
    (`pathtracer.py:88`), whose bound is exclusive."""
    return rng.uint_scalar(rng.fold(key, 0x5EED), maxval=2**31 - 2)


def render_step(packet, cam, accum: AccumState, seed_or_generator, config,
                spp: int = 1, urand=None, ray_chunk: int = 0) -> AccumState:
    """Accumulate ``spp`` progressive samples into the running average.

    Sample s uses running-average index n = frame + s + 1. On CUDA a dense
    sample is one kernel launch, a wavefront sample one mask and one bounce
    launch per live bounce (bounce 0 bins in screen space instead of the
    mask when the image tiles), a staged sample one sweep launch per bounce;
    ``accum.linear`` is updated IN PLACE (the port's answer to JAX buffer
    donation) and the returned state shares it. Under a profiler the step
    is the span ``ptre.render.step``, its packing ``ptre.render.pack`` and
    each sample ``ptre.render.sample`` (`utils.metrics.span`).

    Args:
      packet: ScenePacket on the accumulator's device.
      cam: Camera on the accumulator's device (its rows or rays are made
        there, once a step on the dense route).
      accum: AccumState; its ``linear`` device picks the path.
      seed_or_generator: an int seed, a CPU ``torch.Generator`` or an
        `rng.Key`. An int or a generator gives each sample a Python-int
        Philox seed, so no step reads the device. A key on the staged route
        keys sample s by ``fold(fold(key, s), n)`` and draws as the
        reference does (`pathtracer.py:151-159`); on the dense and
        wavefront routes, whose kernels draw Philox, it becomes the int
        `fused_seed` (key), as the reference draws its fused seed.
      config: RenderConfig; ``intersect_backend`` takes part in `route`.
      spp: samples in this step.
      urand: optional (spp, 2 + 2*max_depth, H, W) float32 uniforms in
        [0, 1) to use instead of Philox draws (parity runs).
      ray_chunk: rays per chunk of the staged route (0: all at once).
    """
    with span("ptre.render.step"):
        device = accum.linear.device
        check_dispatch(packet, device, config)
        if packet.device != device:
            raise ValueError(f"packet is on {packet.device}, accum on {device}")
        cam_ops.check_device(cam, device, "the accumulator")
        H, W = accum.linear.shape[:2]
        if (H, W) != (cam.height, cam.width):
            raise ValueError(f"accum is {H}x{W}, camera {cam.height}x{cam.width}")
        if urand is not None and tuple(urand.shape) != (spp, 2 + 2 * config.max_depth, H, W):
            raise ValueError(f"urand has shape {tuple(urand.shape)}")
        r = route(packet, config)
        key = seed_or_generator if isinstance(seed_or_generator, rng.Key) else None
        if key is not None and r != "staged":
            seed_or_generator, key = fused_seed(key), None
        if key is None:
            gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
                   else torch.Generator().manual_seed(int(seed_or_generator)))

        if r == "staged":
            with torch.no_grad():
                for s in range(spp):
                    with span("ptre.render.sample"):
                        n = accum.frame + s + 1
                        if key is not None:
                            img = sample_image_staged(packet, cam, config,
                                                      key=rng.fold(key, s, n),
                                                      ray_chunk=ray_chunk)
                        else:
                            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
                            img = sample_image_staged(packet, cam, config, seed, n,
                                                      None if urand is None else urand[s],
                                                      ray_chunk=ray_chunk)
                        inv_n, w_old = rk._average_weights(n)
                        accum.linear.mul_(w_old).add_(img.reshape(H, W, 3) * inv_n)
            return AccumState(linear=accum.linear, frame=accum.frame + spp)

        if r == "wavefront":
            # world-space triangles, Morton sort and packing once per step
            with span("ptre.render.pack"):
                scene = wf.prepare_scene(packet, screen_cam=cam)
            for s in range(spp):
                with span("ptre.render.sample"):
                    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
                    n = accum.frame + s + 1
                    img = sample_image(scene, cam, config, seed, n,
                                       None if urand is None else urand[s])
                    inv_n, w_old = rk._average_weights(n)
                    accum.linear.mul_(w_old).add_(img.reshape(H, W, 3) * inv_n)
            return AccumState(linear=accum.linear, frame=accum.frame + spp)

        with span("ptre.render.pack"):
            scene = mk.pack_scene(packet)
            rows = rk.camera_rows(cam)
        for s in range(spp):
            with span("ptre.render.sample"):
                seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
                rk.sample_accum(accum.linear, scene, rows, accum.frame + s + 1, config,
                                seed, None if urand is None else urand[s])
        return AccumState(linear=accum.linear, frame=accum.frame + spp)


def to_display(linear, sqrt_gamma: bool = True):
    """Linear → display uint8 RGB: sqrt gamma, ×255, truncating cast
    (`path_tracer.cu:360-365`)."""
    img = torch.sqrt(torch.clamp(linear, min=0.0)) if sqrt_gamma else linear
    return (255.0 * torch.clamp(img, 0.0, 1.0)).to(torch.uint8)


def to_bgra8(rgb_u8):
    """RGB uint8 → BGRA8, the reference framebuffer format (`path_tracer.h:15-21`)."""
    alpha = torch.full_like(rgb_u8[..., :1], 255)
    return torch.cat([rgb_u8[..., 2:3], rgb_u8[..., 1:2], rgb_u8[..., 0:1], alpha],
                     dim=-1)
