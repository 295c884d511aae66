"""Checkpoint / resume of progressive renders.

The port's own copy of `ptre_tpu/utils/checkpoint.py`, in the same format:
one ``.npz`` with ``version`` (1), ``linear`` (H, W, 3) float32, ``frame``
(a 0-d int32, as the JAX package writes its device scalar), ``seed``,
``frame_index`` and optional ``extra:<name>`` leaves. A file written by
either package loads in the other. The port's ``AccumState.frame`` is a
host int, so it is read back as one.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ptre_tpu_torch.render.pathtracer import AccumState
from ptre_tpu_torch.utils.device import resolve
from ptre_tpu_torch.utils.errors import CheckpointError

_FORMAT_VERSION = 1


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_render_state(
    path: str,
    accum: AccumState,
    seed: int,
    frame_index: int,
    extra: Dict[str, Any] | None = None,
):
    """Persist accumulation + RNG cursor (+ optional tensors or arrays),
    written to a temporary file and swapped in atomically."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "linear": _host(accum.linear).astype(np.float32, copy=False),
        "frame": np.asarray(int(accum.frame), np.int32),
        "seed": np.int64(seed),
        "frame_index": np.int64(frame_index),
    }
    for k, v in (extra or {}).items():
        payload[f"extra:{k}"] = _host(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # file object: savez won't append .npz
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic swap


def load_render_state(path: str, device=None):
    """Load → (AccumState, seed, frame_index, extra dict), the accumulator
    and the ``extra`` tensors on ``device`` (None: the card, as
    `AccumState.create`; RendererError where there is none)."""
    if not os.path.exists(path):
        raise CheckpointError(f"no checkpoint at {path}")
    device = resolve(device)
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise CheckpointError(f"unsupported checkpoint version {int(z['version'])}")
        accum = AccumState(linear=torch.from_numpy(z["linear"]).to(device),
                           frame=int(z["frame"]))
        extra = {k.split(":", 1)[1]: torch.from_numpy(z[k]).to(device)
                 for k in z.files if k.startswith("extra:")}
        return accum, int(z["seed"]), int(z["frame_index"]), extra
