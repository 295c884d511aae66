"""Per-sample post-processing of the integrator (`ptre_tpu/ops/integrator.py`).

Only `postprocess_sample` is ported so far; the staged differentiable
``trace`` is still to come (ROADMAP A5).
"""

from __future__ import annotations

import torch


def postprocess_sample(color, clamp: bool = True):
    """Per-sample clamp to [0, 1] + non-finite scrub (`path_tracer.cu:345-353`,
    `integrator.py:171-188`): NaN and ±inf become 0 in both modes, so an
    unclamped inf sample cannot poison the running average."""
    if clamp:
        color = torch.clamp(color, 0.0, 1.0)
    return torch.where(torch.isfinite(color), color, torch.zeros_like(color))
