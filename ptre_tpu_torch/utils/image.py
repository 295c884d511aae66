"""Image file IO (PPM/PNG/NPY).

The port's own copy of `ptre_tpu/utils/image.py` (same functions, same
formats): frames are written to files in place of the reference's swap
chain. Every writer takes an (H, W, 3) uint8 numpy array or a CPU uint8
tensor; PNG goes through PIL where it is installed, and otherwise falls back
to a ``.ppm`` beside the requested name, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host_array(rgb_u8) -> np.ndarray:
    """A numpy view of ``rgb_u8``; a tensor must already lie on the CPU (a
    device tensor would make the writer a hidden synchronisation)."""
    if isinstance(rgb_u8, torch.Tensor):
        if rgb_u8.device.type != "cpu":
            raise ValueError(f"image writers take host arrays, got a tensor on {rgb_u8.device}")
        return rgb_u8.numpy()
    return np.asarray(rgb_u8)


def write_ppm(path: str, rgb_u8) -> None:
    """Write a binary P6 PPM (the reference's leftover image.ppm format)."""
    arr = np.asarray(_host_array(rgb_u8), np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"a PPM holds (H, W, 3) pixels, got shape {arr.shape}")
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM → (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, dims, maxval — whitespace/comment tolerant
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P6":
        raise ValueError(f"{path}: not a binary P6 PPM ({tokens[0]!r})")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval}, expected 255")
    i += 1  # single whitespace after maxval
    return np.frombuffer(data[i : i + w * h * 3], np.uint8).reshape(h, w, 3).copy()


def write_npy(path: str, arr) -> None:
    np.save(path, _host_array(arr))


def write_image(path: str, rgb_u8) -> None:
    """Write by extension: .ppm native; .npy raw; .png via PIL if available."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ppm":
        write_ppm(path, rgb_u8)
    elif ext == ".npy":
        write_npy(path, rgb_u8)
    elif ext == ".png":
        try:
            from PIL import Image  # optional dependency
        except ImportError:
            write_ppm(os.path.splitext(path)[0] + ".ppm", rgb_u8)
        else:
            Image.fromarray(np.asarray(_host_array(rgb_u8), np.uint8)).save(path)
    else:
        raise ValueError(f"unsupported image extension: {path}")
