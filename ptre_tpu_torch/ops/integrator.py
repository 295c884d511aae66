"""Path-tracing integrator: per-sample post-processing and the
differentiable trace (`ptre_tpu/ops/integrator.py`).

``trace`` routes every packet to the fused gradient path
(`ops/cuda/fused_grad.trace_grad`), as the reference's ``_grad_route`` does
on the TPU (`integrator.py:49-79`): a recording forward — the dense
recording kernel, or for triangle-scale packets the wavefront in record
mode — and the fused backward kernel on the card, their plain versions on
the CPU. The staged, autograd-capable trace of the reference (ROADMAP A5) is
not ported, so a packet past the wavefront's caps raises instead of falling
back.
"""

from __future__ import annotations

import torch

from ptre_tpu_torch.ops.cuda import fused_grad


def postprocess_sample(color, clamp: bool = True):
    """Per-sample clamp to [0, 1] + non-finite scrub (`path_tracer.cu:345-353`,
    `integrator.py:171-188`): NaN and ±inf become 0 in both modes, so an
    unclamped inf sample cannot poison the running average."""
    if clamp:
        color = torch.clamp(color, 0.0, 1.0)
    return torch.where(torch.isfinite(color), color, torch.zeros_like(color))


def check_grad_dispatch(packet, device) -> None:
    """Raise unless `trace` has a path for this packet on ``device``: the
    fused gradient kernels (or their plain versions on the CPU) for a
    dense-class packet or one the wavefront supports. Touches no tensor."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"trace runs on cuda or cpu, not {device}")
    fused_grad.check_supported(packet)


def trace(origins, directions, packet, config, seed: int = 0, sample: int = 0,
          urand=None, screen_cam=None, forward=None):
    """Trace one sample per ray → linear color (R, 3), differentiable
    w.r.t. the rays and the packet's float leaves.

    ``seed``/``sample`` key the Philox draws (seed, ray, sample, draw);
    ``urand`` (2 + 2*max_depth, R) replaces them (parity runs).
    ``screen_cam``: the camera whose jittered per-pixel rays (origins,
    directions) are, in row-major order; lets the triangle-scale forward bin
    bounce 0 in screen space, the image is unchanged. ``forward``: the
    packet packed once by `fused_grad.prepare_forward` for many samples.
    """
    check_grad_dispatch(packet, origins.device)
    return fused_grad.trace_grad(origins, directions, packet, config, seed,
                                 sample, urand, screen_cam=screen_cam, forward=forward)
