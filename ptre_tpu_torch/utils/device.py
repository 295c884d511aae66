"""Device checks.

Replaces the reference's backend sniffing (`ptre_tpu/utils/backend.py`): the
port never guesses a device. A caller that asks for the CUDA path gets it or
an error — there is no fallback to the CPU.
"""

from __future__ import annotations

import torch

from ptre_tpu_torch.utils.errors import RendererError


def require_cuda() -> torch.device:
    """Return the current CUDA device, or raise if this process has none."""
    if not torch.cuda.is_available():
        raise RendererError(
            "a CUDA device is required for this path, but "
            "torch.cuda.is_available() is False"
        )
    return torch.device("cuda", torch.cuda.current_device())
