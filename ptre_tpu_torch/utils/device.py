"""Device checks.

Replaces the reference's backend sniffing (`ptre_tpu/utils/backend.py`): the
port never guesses a device. A caller that asks for the CUDA path gets it or
an error — there is no fallback to the CPU. The public constructors that
allocate without an input tensor (`Scene.build_packet`,
`AccumState.create`) place it on the card unless the caller names another
device (`resolve`), as the reference's ``jnp.asarray`` places it on the
accelerator. A constant that a frame needs on the card (`constant`) is copied
there once and reused, never rebuilt from Python values every frame.
"""

from __future__ import annotations

import functools

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


def resolve(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card (`require_cuda`),
    which raises where there is none — never the CPU by default."""
    return require_cuda() if device is None else torch.device(device)


def constant(values, device) -> torch.Tensor:
    """A float32 tensor of the Python floats ``values`` on ``device``: made,
    with one copy, at the first call for these values and device, and the
    same tensor after that. Read it only: it is shared."""
    return _constant(tuple(float(v) for v in values), torch.device(device))


@functools.lru_cache(maxsize=256)
def _constant(values, device):
    return torch.tensor(values, dtype=torch.float32).to(device)


def card_name_and_power_limit():
    """(name, power limit) of the first card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    None where there is no ``nvidia-smi`` or it fails."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        return None
    name, _, limit = out.stdout.strip().splitlines()[0].rpartition(",")
    return name.strip(), limit.strip()
