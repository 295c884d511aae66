"""Build the CUDA kernels from the repository's own sources at first use.

``nvcc`` compiles ``csrc/render_kernel.cu`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes). The library lands in ``ptre_tpu_torch/_build/``
(git-ignored) under a name keyed on a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.

A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

from ptre_tpu.utils.errors import RendererError

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: the kernel translation unit and the headers it includes
SOURCES = ("render_kernel.cu", "trace.cuh", "philox.cuh")

#: (seconds, ptxas report) of the build this process ran, or None if the
#: library was already built
last_build = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RendererError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global last_build
    lib_path = os.path.join(BUILD_DIR, f"libptre_kernels_{_source_hash()}.so")
    if not os.path.exists(lib_path):
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, "render_kernel.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RendererError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds both succeed
        last_build = (time.perf_counter() - t0, proc.stderr)
    lib = ctypes.CDLL(lib_path)
    lib.ptre_render_sample.restype = ctypes.c_int
    # (params, accum, urand, tris, sphs, mats, sky, stream)
    lib.ptre_render_sample.argtypes = [ctypes.c_void_p] * 8
    lib.ptre_cuda_error_string.restype = ctypes.c_char_p
    lib.ptre_cuda_error_string.argtypes = [ctypes.c_int]
    return lib
