"""Progressive path-tracer frame pipeline.

PyTorch port of `ptre_tpu/render/pathtracer.py`'s forward path. Two routes,
chosen per packet (`route`):

  * dense packets (<= 64 triangles, <= 64 spheres): each sample is one
    launch of the whole-sample render kernel (`ops/cuda/render_kernel.py`);
  * larger packets the wavefront takes (`ops/cuda/wavefront.supports`): each
    sample is `sample_image` — Philox jitter, `camera.get_rays`, the sorted
    wavefront (mask and bounce kernels), clamp and scrub — then the running
    average, with the packing done once per step.

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
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.ops.integrator import postprocess_sample


@dataclasses.dataclass
class AccumState:
    """Progressive accumulation state (reference `path_tracer.h:61-62`).

    ``frame`` is a host int (the JAX package keeps a device scalar): the
    per-sample running-average index never needs a device read."""

    linear: torch.Tensor  # (H, W, 3) float32 running-average linear color
    frame: int = 0  # samples accumulated so far (m_crt_frame)

    @classmethod
    def create(cls, height: int, width: int, device=None) -> "AccumState":
        return cls(linear=torch.zeros((height, width, 3), dtype=torch.float32,
                                      device=device), frame=0)

    def reset(self) -> "AccumState":
        """Restart accumulation by zeroing only the counter; the buffer is
        overwritten at n = 1 by the running average."""
        return dataclasses.replace(self, frame=0)


def pixel_grid(height: int, width: int, device=None):
    """Flattened pixel coordinates: x right, y down (pixelid = y*W + x)."""
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def route(packet) -> str:
    """The route of a packet: "dense" (the render kernel), "wavefront" (the
    mask and bounce kernels) or "none" when neither takes it."""
    if mk.dense_supported(packet):
        return "dense"
    if wf.supports(packet):
        return "wavefront"
    return "none"


def check_dispatch(packet, device) -> None:
    """Raise unless ``render_step`` has a path for this packet on ``device``:
    on CUDA the dense kernel or the wavefront kernels — nothing runs plain
    PyTorch on the card instead. On the CPU every packet has a path (a
    packet neither route takes runs the dense plain version)."""
    device = torch.device(device)
    if device.type == "cuda":
        if route(packet) == "none":
            raise NotImplementedError(
                "render_step on CUDA takes a dense packet (<= "
                f"{mk.DENSE_MAX_TRI} triangles, <= {mk.DENSE_MAX_SPH} spheres) or "
                f"one the wavefront takes (<= {wf.MAX_WAVE_TRIS} triangle rows, <= "
                f"{wf.MAX_WAVE_SPHS} sphere rows), with <= {mk.MAX_MATS} materials; "
                f"this packet has {packet.tri_valid.shape[0]} triangle rows, "
                f"{packet.sph_center.shape[0]} sphere rows, {packet.num_materials} "
                "materials.")
    elif device.type != "cpu":
        raise NotImplementedError(f"render_step runs on cuda or cpu, not {device}")


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


def render_step(packet, cam, accum: AccumState, seed_or_generator, config,
                spp: int = 1, urand=None) -> AccumState:
    """Accumulate ``spp`` progressive samples into the running average.

    Sample s uses running-average index n = frame + s + 1. On CUDA a dense
    sample is one kernel launch, a wavefront sample one mask and one bounce
    launch per live bounce (bounce 0 bins in screen space instead of the
    mask when the image tiles); ``accum.linear`` is updated IN PLACE (the
    port's answer to JAX buffer donation) and the returned state shares it.

    Args:
      packet: ScenePacket on the accumulator's device.
      cam: Camera (host tensors).
      accum: AccumState; its ``linear`` device picks the path.
      seed_or_generator: an int seed or a CPU ``torch.Generator``; it gives
        each sample a Python-int Philox seed, so no step reads the device.
      config: RenderConfig.
      spp: samples in this step.
      urand: optional (spp, 2 + 2*max_depth, H, W) float32 uniforms in
        [0, 1) to use instead of Philox draws (parity runs).
    """
    device = accum.linear.device
    check_dispatch(packet, device)
    if packet.device != device:
        raise ValueError(f"packet is on {packet.device}, accum on {device}")
    H, W = accum.linear.shape[:2]
    if (H, W) != (cam.height, cam.width):
        raise ValueError(f"accum is {H}x{W}, camera {cam.height}x{cam.width}")
    if urand is not None and tuple(urand.shape) != (spp, 2 + 2 * config.max_depth, H, W):
        raise ValueError(f"urand has shape {tuple(urand.shape)}")
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator().manual_seed(int(seed_or_generator))

    if route(packet) == "wavefront":
        # world-space triangles, Morton sort and packing once per step
        scene = wf.prepare_scene(packet, screen_cam=cam)
        for s in range(spp):
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
            n = accum.frame + s + 1
            img = sample_image(scene, cam, config, seed, n,
                               None if urand is None else urand[s])
            inv_n, w_old = rk._average_weights(n)
            accum.linear.mul_(w_old).add_(img.reshape(H, W, 3) * inv_n)
        return AccumState(linear=accum.linear, frame=accum.frame + spp)

    scene = mk.pack_scene(packet)
    rows = rk.camera_rows(cam)
    for s in range(spp):
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
