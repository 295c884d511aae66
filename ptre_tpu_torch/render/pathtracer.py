"""Progressive path-tracer frame pipeline.

PyTorch port of `ptre_tpu/render/pathtracer.py`'s forward path. Each sample
is one launch of the hand-written render kernel (`ops/cuda/render_kernel.py`)
on CUDA tensors, or its plain PyTorch version on CPU tensors. The
accumulation reproduces the reference render kernel (`path_tracer.cu:330-366`):
per-sample clamp to [0, 1], running average lin = c/n + lin*(n-1)/n, sqrt
display gamma with a truncating uint8 cast. Reset only zeroes the sample
counter; the n = 1 step then overwrites history (`path_tracer.cu:394-400`).
"""

from __future__ import annotations

import dataclasses

import torch

from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import render_kernel as rk


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


def check_dispatch(packet, device) -> None:
    """Raise unless ``render_step`` has a path for this packet on ``device``:
    on CUDA that is the dense kernel only — larger scenes wait for the
    wavefront kernels, and nothing runs plain PyTorch on the card instead."""
    device = torch.device(device)
    if device.type == "cuda":
        if not mk.dense_supported(packet):
            raise NotImplementedError(
                "render_step on CUDA runs the dense kernel only (<= "
                f"{mk.DENSE_MAX_TRI} triangles, <= {mk.DENSE_MAX_SPH} spheres, "
                f"<= {mk.MAX_MATS} materials); this packet has "
                f"{packet.num_triangles} triangles, {packet.num_spheres} "
                f"spheres, {packet.num_materials} materials. Larger scenes "
                "need the triangle-scale path still to be ported (ROADMAP "
                "A9, B6, B7).")
    elif device.type != "cpu":
        raise NotImplementedError(f"render_step runs on cuda or cpu, not {device}")


def render_step(packet, cam, accum: AccumState, seed_or_generator, config,
                spp: int = 1, urand=None) -> AccumState:
    """Accumulate ``spp`` progressive samples into the running average.

    Sample s uses running-average index n = frame + s + 1. On CUDA each
    sample is one kernel launch; ``accum.linear`` is updated IN PLACE (the
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
