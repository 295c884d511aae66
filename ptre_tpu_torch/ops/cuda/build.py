"""Build the CUDA kernels from the repository's own sources at first use.

``nvcc`` compiles each kernel translation unit (``KERNEL_UNITS``) to an
object file — all of them at once, one process each — and links them into
one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). The library lands
in ``ptre_tpu_torch/_build/`` (git-ignored) under a name keyed on a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused.

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

from ptre_tpu_torch.utils.errors import RendererError

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: the kernel translation units, each compiled by its own nvcc process
KERNEL_UNITS = ("render_kernel.cu", "record_kernel.cu", "fused_grad_kernel.cu",
                "mask_kernel.cu", "wave_kernel.cu", "raster_kernel.cu",
                "soft_raster_kernel.cu", "mega_kernel.cu", "sweep_kernel.cu",
                "replay_kernel.cu", "take_rows_kernel.cu")
#: every source the library is built from: the units and their headers
SOURCES = KERNEL_UNITS + ("trace.cuh", "philox.cuh", "replay.cuh", "wave.cuh",
                          "raster.cuh", "sweep.cuh", "take_rows.cuh")
#: flags of single units on top of NVCC_FLAGS, all without FMA contraction.
#: The SoftRas pair terms: a contracted edge distance or barycentric moves a
#: near-degenerate triangle's d(inverse squared edge length) by far more than
#: float rounding, against the plain version's separate roundings. The sweep:
#: its selections are integers, held exactly against the plain version. The
#: replay pair and the fused backward, which share replay.cuh's chain:
#: contracted, the chain's near-singular terms (Oren-Nayar's tan at grazing
#: incidence, the ground sphere's horizon) put colours beyond 1e-4 of the
#: plain version and summed geometry gradients 2-2.25x further from float64
#: than the plain float32's; uncontracted the replay pair is bit-equal to the
#: plain version (chip_smoke.py phases 7, 17 and 21 read both builds).
UNIT_FLAGS = {"soft_raster_kernel.cu": ("-fmad=false",),
              "sweep_kernel.cu": ("-fmad=false",),
              "replay_kernel.cu": ("-fmad=false",),
              "fused_grad_kernel.cu": ("-fmad=false",)}

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
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(UNIT_FLAGS.items()))).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _compile_all(nvcc: str, tmp_dir: str):
    """Compile every unit to ``tmp_dir/<unit>.o``, all processes started
    together; returns the concatenated ptxas reports."""
    procs = []
    for unit in KERNEL_UNITS:
        cmd = [nvcc, *NVCC_FLAGS, *UNIT_FLAGS.get(unit, ()), "-I", CSRC_DIR, "-c", "-o",
               os.path.join(tmp_dir, unit + ".o"), os.path.join(CSRC_DIR, unit)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    reports, failures = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                            f"{out}\n{err}")
        reports.append(err)
    if failures:
        raise RendererError("\n".join(failures))
    return "".join(reports)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global last_build
    lib_path = os.path.join(BUILD_DIR, f"libptre_kernels_{_source_hash()}.so")
    if not os.path.exists(lib_path):
        nvcc = find_nvcc()
        tmp_dir = os.path.join(BUILD_DIR, f"obj.{os.getpid()}")
        os.makedirs(tmp_dir, exist_ok=True)
        t0 = time.perf_counter()
        report = _compile_all(nvcc, tmp_dir)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp,
               *(os.path.join(tmp_dir, u + ".o") for u in KERNEL_UNITS)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RendererError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds both succeed
        shutil.rmtree(tmp_dir, ignore_errors=True)
        last_build = (time.perf_counter() - t0, report)
    lib = ctypes.CDLL(lib_path)
    ptr = ctypes.c_void_p
    lib.ptre_render_sample.restype = ctypes.c_int
    # (params, cam, accum, urand, tris, sphs, mats, sky, stats, lens, stream)
    lib.ptre_render_sample.argtypes = [ptr] * 11
    lib.ptre_trace_record.restype = ctypes.c_int
    # (params, o, d, urand, tris, sphs, mats, sky, color, sel, stats, lens,
    #  stream)
    lib.ptre_trace_record.argtypes = [ptr] * 13
    lib.ptre_fused_bwd_blocks.restype = ctypes.c_int
    # (n_rays, global_table, max_depth, n_rows)
    lib.ptre_fused_bwd_blocks.argtypes = [ctypes.c_int] * 4
    lib.ptre_fused_bwd.restype = ctypes.c_int
    # (params, table, sky, o, d, sel, urand, dcol, d_o, d_d, dtab_part,
    #  dsky_part, n_blocks, stream)
    lib.ptre_fused_bwd.argtypes = [ptr] * 12 + [ctypes.c_int, ptr]
    lib.ptre_fused_bwd_global.restype = ctypes.c_int
    # (params, table (P, 28), sky, o, d, sel, urand, dcol, d_o, d_d,
    #  dtable (P, 28), dsph_part, dsky_part, n_blocks, n_sph_acc, stream)
    lib.ptre_fused_bwd_global.argtypes = [ptr] * 13 + [ctypes.c_int, ctypes.c_int, ptr]
    lib.ptre_wave_mask.restype = ctypes.c_int
    # (params, state, boxes, supers, mask, stats, lanes, stream)
    lib.ptre_wave_mask.argtypes = [ptr] * 6 + [ctypes.c_int, ptr]
    lib.ptre_wave_mask_lists.restype = ctypes.c_int
    # (params, state, boxes, supers, list, count, stats, lanes, stream)
    lib.ptre_wave_mask_lists.argtypes = [ptr] * 7 + [ctypes.c_int, ptr]
    lib.ptre_shortlists.restype = ctypes.c_int
    # (mask, nb, n_leaf, list, count, stream)
    lib.ptre_shortlists.argtypes = [ptr, ctypes.c_int, ctypes.c_int, ptr, ptr, ptr]
    lib.ptre_wave_mask_max_staged_leaves.restype = ctypes.c_int
    lib.ptre_wave_mask_max_staged_leaves.argtypes = []
    lib.ptre_wave_bounce.restype = ctypes.c_int
    # (params, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats,
    #  sky, urand, out, sel, lanes, stream)
    lib.ptre_wave_bounce.argtypes = [ptr] * 14 + [ctypes.c_int, ptr]
    lib.ptre_wave_bounce_counted.restype = ctypes.c_int
    # (params, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats,
    #  sky, urand, out, sel, stats, lanes, stream)
    lib.ptre_wave_bounce_counted.argtypes = [ptr] * 15 + [ctypes.c_int, ptr]
    lib.ptre_trace_culled.restype = ctypes.c_int
    # (params, o, d, urand, tris, rows, boxes, boxes2, sphs, mats, sky, color,
    #  sel, stats, lanes, stream)
    lib.ptre_trace_culled.argtypes = [ptr] * 14 + [ctypes.c_int, ptr]
    lib.ptre_raster_hard.restype = ctypes.c_int
    # (params, tris, cbox, out, stats, stream)
    lib.ptre_raster_hard.argtypes = [ptr] * 6
    lib.ptre_soft_fwd.restype = ctypes.c_int
    # (params, tris, cbox, img, res, stats, stream)
    lib.ptre_soft_fwd.argtypes = [ptr] * 7
    lib.ptre_soft_bwd.restype = ctypes.c_int
    # (params, tris, cbox, res, dimg, dtab, stats, stream)
    lib.ptre_soft_bwd.argtypes = [ptr] * 8
    lib.ptre_sweep.restype = ctypes.c_int
    # (params, o, d, active, rows, boxes, boxes2, sphs, out, stats, stream)
    lib.ptre_sweep.argtypes = [ptr] * 11
    lib.ptre_replay_blocks.restype = ctypes.c_int
    lib.ptre_replay_blocks.argtypes = [ctypes.c_int]
    lib.ptre_replay_occupancy.restype = ctypes.c_int
    # (max_depth, fwd blocks/SM *, bwd blocks/SM *, bwd dynamic smem bytes *)
    lib.ptre_replay_occupancy.argtypes = [ctypes.c_int, ptr, ptr, ptr]
    lib.ptre_replay_fwd.restype = ctypes.c_int
    # (params, g, sky, o, d, sel, urand, color, stream)
    lib.ptre_replay_fwd.argtypes = [ptr] * 9
    lib.ptre_replay_bwd.restype = ctypes.c_int
    # (params, g, sky, o, d, sel, urand, dcol, d_o, d_d, d_g, dsky_part, stream)
    lib.ptre_replay_bwd.argtypes = [ptr] * 13
    lib.ptre_take_rows_max_cells.restype = ctypes.c_int
    lib.ptre_take_rows_max_cells.argtypes = []
    lib.ptre_take_rows_blocks.restype = ctypes.c_longlong
    lib.ptre_take_rows_blocks.argtypes = [ctypes.c_longlong]
    # (g, idx, m, n, f, part | acc, out, stream)
    for fn in (lib.ptre_take_rows_shared, lib.ptre_take_rows_global):
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr, ptr, ptr]
    lib.ptre_cuda_error_string.restype = ctypes.c_char_p
    lib.ptre_cuda_error_string.argtypes = [ctypes.c_int]
    return lib
