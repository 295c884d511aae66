#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ptre_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the kernels from ``ptre_tpu_torch/csrc`` with nvcc (one process per
source, all at once), then:

  1-5. holds the render kernel against its plain PyTorch version and, pixel
       for pixel, against its first design (``csrc/baseline/``), and drives
       the progressive main path — demo scene → ``render_step`` →
       ``to_display`` at 1920x1080 and 1280x720, spp 4 — checking that every
       sample went through the kernel; times the kernel in turns with its
       first design, with the active-lane shares of both (its counting
       instantiation: every pixel's path started once, and each path's
       length, which gives the first design's warp-bounces), and counts the
       render bound from the kernel's own live ray-bounces, triangle rows
       tested and hits;
  6-7. holds the recording forward and the fused backward kernels of the
       gradient path against their plain versions at 1920x1080, the
       recording kernel also ray for ray against its first design and timed
       in turns with it (active-lane shares of both, every ray started
       once), the backward (built without FMA contraction) bit
       for bit in d(o), d(d) against its first design and timed in turns
       against it and against its unit built with FMA contraction, with its
       registers, spills and stack frame and a bound recounted from the
       source by kind of bounce;
  8.   drives the training main path — ``differentiable_params`` →
       ``mse_step`` at 1920x1080, spp 1 (1 + 8 steps) and one spp-64 step
       (its samples rematerialised: two record launches a sample) —
       checking that every sample went through both kernels, and that
       ``two_pass_mse_step`` equals ``mse_step`` at 320x180; then one
       ``mse_step`` at max_depth 9, past the kernels' depth cap, through the
       staged route (the sweep kernel, no record or backward launch);
  9-10. holds the wavefront's mask kernel against its plain version, its
       first design (``csrc/baseline/``) and the unit shipped before it
       took more than 1,024 leaves (``csrc/baseline/mask_static/``, timed
       in turns beside the others) at every live bounce after the
       first of a sample of BASELINE config 3 (16,128 triangles) at 512x512
       and config 4 (16,140 triangles) at 1920x1080, each bounce timed in
       turns beside its bound and the supertile and leaf tests its counting
       instantiation made, and at config 4's bounce 1 the kernel writing
       the shortlists in turns with the dense mask and its sort
       (``python3 chip_smoke.py shortlists`` runs that timing alone, with
       bounces 1-4 of the 4,080-leaf mesh); the bounce kernel against its
       plain version on
       the bounce-1 state, with the (ray, leaf) pairs the shortlists list
       and those whose box the ray itself passes, then the whole kernel
       ``wavefront.trace`` against the plain one;
  11.  drives the triangle-scale main path — ``render_step`` on config 3 at
       512x512 and config 4 at 1920x1080, spp 4 (1 + 8 steps) — checking
       that every live bounce went through the kernels, and prints where a
       bounce's time goes;
  12-14. the rasterizer on the demo scene with spheres as triangles (1,932
       triangles) at 1280x720, supersample 2 (2560x1440 samples): holds the
       hard kernel, the SoftRas forward and the SoftRas backward kernels
       against their plain versions, the hard kernel also sample for sample
       against its first design (``csrc/baseline/raster_mega/``) there and
       on a ragged and a strided window, timed in turns with it, and the
       row gates by their counting instantiations (the hard kernel's pairs
       evaluated between those in the rows' boxes and in their gate boxes;
       the soft kernels' beside those an ungated sweep takes and those in
       the rows' dilated boxes, pairs above the coverage threshold equal to
       the plain version's), then
       drives ``rasterize`` (1 + 8 frames), ``rasterize_frames`` (K = 4),
       ``rasterize(soft=True)`` and ``train.raster_mse_step`` (1 + 8 steps),
       checking that every frame or step went through the kernels; a ragged
       size and a strided window (hard, and soft at sigma 2), an empty scene
       and tests/goldens/demo_raster.ppm check the image; a torch.profiler
       window splits a frame's and a step's time between the host and the
       device;
  15-17. triangle-scale training's kernels on BASELINE config 4 at 1920x1080
       and config 3 at 512x512: holds the culled megakernel against its
       plain version (external uniforms and in-kernel Philox), against its
       first design (``csrc/baseline/raster_mega/``) bit for bit, recording
       and not, culling on against culling off and against the wavefront's
       kernels on the same rays and draws, with its counting
       instantiation's warp visits beside the (ray, leaf) pairs the rays
       pass, timed in turns with the first design; the wavefront's record
       mode against record=False (bit-equal colour), its plain version and
       the megakernel's
       selections, the recording bounce kernel beside the non-recording
       one; the backward kernel's global-table instantiation against its
       plain version on config 4's recorded selections, and bit for bit in
       d(o), d(d) against its first design (timed in turns against it and
       against its unit built with FMA contraction), and two runs of it
       against each other;
  18.  drives the triangle-scale training path — ``differentiable_params``
       → ``mse_step`` on config 4 at 1920x1080 and config 3 at 512x512, spp
       1 (1 + 8 steps), one ``two_pass_mse_step`` at spp 64 on config 4, one
       step forced through the culled megakernel — checking that every
       sample went through the mask, recording bounce and global-table
       backward kernels, that the gradients are finite and d(transforms)
       non-zero, and that ``two_pass_mse_step`` equals ``mse_step`` on a
       triangle packet; a torch.profiler window splits a step's time;
  19.  holds the staged route's culled sweep kernel against the brute-force
       plain sweep, exactly, on the demo scene, config 4 and a 65,024-row
       uv-sphere mesh at 1920x1080: primary and bounce-1 rays, and on the
       mesh every bounce of one staged sample (dead rays masked), with the
       (ray, leaf) pairs the rays pass and the warps sweep; times it in turns
       against its unit built with FMA contraction;
  20.  drives the staged main path — ``render_step`` and ``mse_step`` (spp
       1, 1 + 2 steps each) on that mesh, the staged route forced
       (``intersect_backend="pallas"``, ``grad_sweep="staged"``) —
       checking that every bounce went through the sweep kernel, profiles a
       staged step, holds the staged route's gradients against the fused
       route's on the demo scene, with the staged gathers' float64 sums and,
       beside them, ``embedding``'s float32 ones;
  21.  the replay route (``grad_sweep="replay"``) on the demo scene at
       1920x1080: holds the replay forward and backward kernels against
       their plain versions on the recording kernel's selections (the
       backward by column group, against float64 too, the fused backward
       held there beside it) and bit for bit against their first designs
       (``csrc/baseline/replay_pair/``) at max_depth 5 and 8, timed in turns
       with them, with the registers, shared memory and blocks an SM of
       both depths and the warps' dead tails and slabs
       (`warp_slabs`), the route's loss and gradients
       against the fused route's on the same seed, and drives
       ``mse_step`` (spp 1, 1 + 8 steps) and ``two_pass_mse_step`` (spp 64)
       on it — checking one record, one replay forward and one replay
       backward launch a sample — with a device profile of a step;
  22.  the engine facade on the demo at 1280x720, spp 1: twelve
       ``Renderer`` frames with the engine toggled before frames 4 and 8
       and a reset before frame 6 — one render kernel launch a path-traced
       frame, one hard raster launch a raster frame, every frame bit-equal
       to the same seeds replayed through ``render_step`` / ``rasterize``
       (dispatch-ahead frames one behind) — a resume from a checkpoint
       bit-equal to an uninterrupted run, ``python -m ptre_tpu_torch.cli
       render`` in a subprocess (its frames equal to the engine's),
       ``cli info`` and ``cli bench``, ``NativeScene``'s demo packet against
       ``Scene.build_packet`` on the card, and the host ms/frame of
       path-traced frames with dispatch-ahead presentation on and off and
       of raster frames;
  23.  the sharded steps (``parallel/sharding.py``, ``parallel/distributed.py``)
       on the demo at 1920x1080: a world of one over NCCL in this process
       (mesh (1, 1): ``shard_render_step`` on the default and the staged
       route, ``shard_train_step``, ``shard_raster_step`` hard and soft,
       ``dual_train_step``, each held to a one-process replay of the shard's
       maths with its launch counts and host ms/step), then four gloo ranks
       sharing the card (``--shard-rank`` subprocesses, mesh (2, 2), and
       (4, 1) at H = 1078), rank 0 holding the assembled results against the
       replay of all shards;
  24.  meshes past the reference's 49,152-row cap, which the wavefront and
       the fused route now take: the 65,024-row mesh (1,016 leaves) and
       ``config3_scene(False, 512, 256, diffuse=True)`` (261,120 rows, 4,080
       leaves: the mask's global instantiation) at 1920x1080 — the packing
       against the CPU's, the screen binning (bounce 0 bit-equal to every
       leaf listed), the mask at every live bounce (against the plain
       version, with its counted bound; the staged instantiation in turns
       with the parent's unit; at 4,080 leaves the kernel writing the
       shortlists in turns with the dense mask and its sort), the
       shortlists against the CPU's compaction, the bounce kernel plain and
       recording, the whole trace on 8 rows of pixels, the
       table and its Morton gather, the global backward (as phase 17) and
       the culled megakernel on those rows against their plain versions;
       then ``render_step`` and ``mse_step`` on the default route in turns
       with the forced staged route, and a ``force="culled"`` step, with
       their launches and device profiles, printed as a before/after table;
  25.  material tables past the reference's 8 rows (`materials_phase`): the
       demo and config 4 with 8 materials (A) and with 16 decoy rows before
       A's 8 (B, 24 materials, every model on its id + 16), at 1920x1080 —
       the render and recording kernels (demo), the wave kernels and the
       culled megakernel (config 4) on B against their plain versions and
       bit for bit against A, ``render_step`` (spp 4), ``mse_step`` (spp 1)
       and a force="culled" step on B through those kernels with no sweep
       launch, B's image, loss and gradients A's; the default route in
       turns with the forced staged route (the parent's route for B) and
       with A's, as a table; config 4 with 300 distinct materials held to
       the plain version on 8 rows of pixels and driven through both steps;
  26.  rematerialisation (`remat_phase`): ``mse_step`` on the demo at
       1920x1080 (spp 1, 4, 16), on the 65,024-row mesh with the staged
       route forced (spp 1 and 4, and spp 12 with remat only) and
       ``shard_train_step`` in a world of one over NCCL (local spp 1 and 4),
       each with ``remat_bounces`` on and off in turns: peak memory, host
       ms/step, launches (a sample's forward again in the backward past
       spp 1; the staged bounces' sweeps not again), the camera's gradients
       bit for bit and the table's and sky's within REMAT_GRAD_REL, the
       peak at the largest spp within REMAT_PEAK_RATIO of spp 1's; the
       synchronizing calls of a dense and a config-4 step at spp 2 by line;
  27.  the row gathers' backward (`take_rows_phase`): each of the six
       differentiable gathers that build the path tracer's and the
       rasterizer's tables (drawcall transforms, triangle and sphere
       materials, the Morton permutation; the raster transforms and the
       raster permutation) at BASELINE config 4's shapes, its backward
       through `take_rows` timed in turns with ``table[idx]``'s, each held
       within a float32 ulp of float64 ``index_add_`` and bit-equal across
       runs, with the kernels' registers and shared memory and the bytes
       bound (the cotangent read once); then the counters from 0 over one
       config-4 ``mse_step`` (spp 4, the ``mixed_mesh.train`` cell's step)
       and one ``dual_train_step`` at 1920x1080: backward calls (shared,
       global) of (12, 4) and (4, 2), 2 launches a shared call and 3 a
       global one.
       ``python3 chip_smoke.py take_rows`` runs this phase alone.

Any failed check raises and the script exits non-zero; it prints its result
lines only after every phase passed:

  * a JSON line ``{"kernels": [...]}``: per kernel its launches on its main
    path, its largest error against the plain version (for the gradient
    kernels outside the rays whose path flipped, which are counted and
    bounded on their own), its and the plain version's time per call at
    the main path's shape, and its bound: the larger of the bytes it must
    move over the card's memory rate and its float32 operations on this
    run's inputs over the card's float32 rate (`bound`);
  * last, ``{"ok": true, "device": {...}}``.

Every time printed is beside the card's name and power limit as
``nvidia-smi`` reports them. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

W_MAIN, H_MAIN = 1920, 1080
SPP, STEPS = 4, 8  # bench.py's defaults: 1 warm-up step + 8 timed steps
# Kernel vs plain version. The kernel contracts a*b+c into FMAs inside the
# bounce loop, so a ray that grazes an edge can take another primitive than
# in the plain version, and that one sample of that pixel then differs by up
# to 1 (1/n of it in the average). Ray generation, the sky and the running
# average are rounded identically. Hence: nearly all channels tight; after
# to_display the golden bound of tests/test_goldens.py (>= 99.5 % within 2
# steps, max 8) except on at most 1e-5 of the pixels (rounded up), where a
# path flipped. Measured: one such pixel of 2,073,600 at 1920x1080.
TIGHT, TIGHT_FRAC = 1e-4, 0.999
DISPLAY_STEPS, DISPLAY_FRAC, DISPLAY_MAX = 2, 0.995, 8
FLIP_FRAC = 1e-5
# Gradient kernels vs plain versions (phases 6-7). The record kernel's color
# is unclamped (an emitter gives 10): TIGHT is relative above 1. The
# backward kernel recomputes the chain (built without FMA contraction, so in
# the plain version's roundings but for its shared-memory sums), and float32
# is too coarse for some rays: a ray whose path flips (a near/far root or the
# degenerate-pdf test decided the other way) differs wholesale, and the
# ground sphere (r = 10) computes |oc|^2 - r^2 ~ 2e-3 for rays leaving its
# surface with an ulp of 7.6e-6, so its center and radius gradients carry
# float32 noise. Measured at 1920x1080 (NVIDIA H100 80GB HBM3, 700 W): the
# plain version in float32 flips 86-90 rays against its own float64
# evaluation, and without them its summed d(center), d(radius) are 8e-4 to
# 9.5e-4 (relative L2) from float64.
# Hence: per-ray d(o), d(d) >= 99.9 % of elements within RAY_TIGHT of the
# largest; at most BWD_FLIP_FRAC of the rays flipped (error beyond FLIP_REL
# of the ray's own gradient); with the flipped rays' cotangents zeroed, the
# material and sky gradients within SUM_REL of the plain version, and the
# geometry gradients no further from float64 than GEOM_FACTOR times the
# plain float32 version (or SUM_REL).
RAY_TIGHT, FLIP_REL, RAY_ATOL, SUM_REL = 1e-4, 1e-2, 1e-3, 1e-4
BWD_FLIP_FRAC, GEOM_FACTOR = 1e-4, 2.0
GRAD_SEED = 0x5EED
SPP_TRAIN = 64  # bench.py's 64-spp step
# two_pass_mse_step vs mse_step: test_train_step.py's rtol; atol relative to
# the leaf's largest entry, since atomics sum d(table) in no fixed order
TWO_PASS_RTOL, TWO_PASS_ATOL = 2e-4, 1e-5


# The bound of a kernel (the H100's peak rates below): the larger
# of the bytes it must move (each input read once, each output written once)
# over HBM3's 3.35 TB/s and its float32 operations on this run's inputs over
# the 67 TFLOP/s of the CUDA cores (H100 SXM data sheet, at 700 W). The
# operation counts are hand counts of the CUDA sources, per unit of work
# (each add, multiply, divide, compare, select, sqrt, exp, sin or cos counts
# one; integer work such as Philox is not counted, so the bound errs low).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_TRI_TEST = 64     # trace.cuh / wave.cuh: one Moller-Trumbore test
OPS_SPH_TEST = 27     # trace.cuh / wave.cuh: one sphere's roots and test
OPS_SHADE = 150       # a hit's attributes and scatter_shade (rough count)
# replay.cuh, one bounce of ray_backward by kind, counted from the source:
# the forward (ray_forward's chain_bounce), the recompute (hit_bounce_forward
# again inside chain_bounce_adjoint) and the adjoint, and the row's 27
# additions into d(table). hit_bounce_forward is 290 on a triangle (its
# attributes 130) and 217 on a sphere (57), of which the ONB scatter 70 and
# Oren-Nayar 90; chain_bounce's update 18; the adjoint 268 plus its geometry
# part, 196 (triangle) or 84 (sphere).
OPS_BWD_TRI = 290 + 18 + 290 + 268 + 196 + 27     # 1,089
OPS_BWD_SPH = 217 + 18 + 217 + 268 + 84 + 27      # 831
OPS_BWD_EMIT = 7 + 18 + 27                        # an emitter ends the path
OPS_BWD_MISS = 17 + 37                            # the sky ends the path
OPS_BWD_BOUNCE_OLD = 800  # the rough count these replace, a hit bounce
OPS_SLAB = 30         # wave.cuh slab_pass
OPS_HARD_PAIR = 30    # raster.cuh covers + the z test
OPS_HARD_SAMPLE = 76  # raster.cuh shade_winner
OPS_SOFT_PAIR = 168   # raster.cuh pair_forward + its share of soft_group
OPS_SOFT_ADJ = 270    # pair_backward's cotangents + pair_adjoint + warp sums


def bound(nbytes, ops):
    """(bound_ms, bound_by) of moving ``nbytes`` and doing ``ops``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_bound(entry, nbytes, ops):
    """``entry`` with its bound_ms, bound_by and library_ms (no single
    PyTorch call computes any of these kernels' functions: null)."""
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"  {entry['name']}: bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
          f"{ops / 1e9:.3f} GFLOP) against {entry['ms']:.4f} ms", flush=True)
    return dict(entry, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def cuda_events(fn, reps):
    """ms per call of ``fn`` by CUDA events over ``reps`` calls, after one."""
    import torch

    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


#: the CUDA runtime calls that block the host until the stream or device
#: drains, and the event wait (the engine's dispatch-ahead read of the
#: previous frame), as the profiler names them
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
EVENT_WAITS = ("cudaEventSynchronize",)


def sync_counts(prof, reps):
    """(stream or device synchronizes, event waits, host-to-device copies,
    device-to-host copies) per call in a profile of ``reps`` calls, less
    the two device synchronizes of the window itself: its closing
    ``torch.cuda.synchronize`` and the profiler's own when it stops."""
    names = [e.name for e in prof.events()]
    syncs = sum(n in SYNC_CALLS for n in names) - 2
    waits = sum(n in EVENT_WAITS for n in names)
    h2d = sum(n.startswith("Memcpy HtoD") for n in names)
    d2h = sum(n.startswith("Memcpy DtoH") for n in names)
    return tuple(x / reps for x in (syncs, waits, h2d, d2h))


def sync_sites(fn):
    """The synchronizing calls of one call of ``fn()``, with torch's CUDA
    sync debug mode set to warn: {site: count}, a site the innermost frame
    of the port (``ptre_tpu_torch/...``) that made the call, as
    "path:line (function)", or the caller's frame where the port made
    none."""
    import collections
    import traceback
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if f"{os.sep}ptre_tpu_torch{os.sep}" in f.filename]
        f = (port or [f for f in stack if f.name != "sync_sites"])[-1]
        path = f.filename
        if f"{os.sep}ptre_tpu_torch{os.sep}" in path:
            path = path[path.rindex(f"{os.sep}ptre_tpu_torch{os.sep}") + 1:]
        else:
            path = os.path.relpath(path, root)
        sites[f"{path}:{f.lineno} ({f.name})"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(sites)


def device_share(fn, reps, what, card):
    """Where ``reps`` steady calls of ``fn`` spend their time, by
    torch.profiler: host-clock ms per call (the window ends in a
    synchronize), device-busy ms per call (the union of the kernels'
    intervals), the device's idle share, the four kernels that take most
    of the device time, and per call the stream or device synchronizes,
    event waits and host-to-device / device-to-host copies
    (`sync_counts`). Returns those four counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end, by_name = 0.0, -math.inf, {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if b > end:
            busy_us += b - max(a, end)
            end = b
        by_name[e.name] = by_name.get(e.name, 0.0) + b - a
    counts = sync_counts(prof, reps)
    syncs = (f"{counts[0]:g} synchronizes, {counts[1]:g} event waits, {counts[2]:g} "
             f"host-to-device and {counts[3]:g} device-to-host copies a call")
    if not kernels:
        print(f"  {what}: the profiler saw no device events: idle share not measured; "
              f"{syncs}", flush=True)
        return counts
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:4]
    print(f"  {what} (torch.profiler, {reps} calls): {wall_us / reps / 1e3:.3f} ms/call host "
          f"clock, device busy {busy_us / reps / 1e3:.3f} ms/call, idle "
          f"{100 * (1 - busy_us / wall_us):.1f} %, {len(kernels) / reps:.0f} device events/call; "
          "device: " + "; ".join(f"{n[:48]} {t / reps / 1e3:.3f} ms" for n, t in top)
          + "; host (self CPU): " + "; ".join(
              f"{e.key[:32]} {e.self_cpu_time_total / reps / 1e3:.3f} ms x{e.count // reps}"
              for e in host) + f"; {syncs} [{card}]", flush=True)
    return counts


def ptxas_summary(report):
    """["kernel: N registers, F B stack frame, S B spill stores, L B spill
    loads, M B smem"]
    from nvcc's ``-Xptxas=-v`` output, one entry per kernel, by its mangled
    name's identifier and template arguments."""
    import re

    out, name = [], None
    spills = ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # _ZN4ptre[4rast]11mega_kernelILb1EEE...: the last name of the
            # nested-name prefix, and a bool template argument after it
            name, rest = m.group(1), m.group(1)[3:] if m.group(1).startswith("_ZN") else ""
            while rest[:1].isdigit():
                n = int(re.match(r"\d+", rest).group())
                start = len(str(n))
                name, rest = rest[start:start + n], rest[start + n:]
            # template arguments: bools and the names of class arguments,
            # e.g. dense_kernelILb1ENS_9RenderJobINS_12PhiloxSourceEEEEEv...
            args, head, i = [], rest.split("Ev", 1)[0] if rest[:1] == "I" else "", 0
            while i < len(head):
                if head[i:i + 4] in ("Lb1E", "Lb0E"):
                    args.append("true" if head[i + 2] == "1" else "false")
                    i += 4
                elif head[i].isdigit():
                    n = re.match(r"\d+", head[i:]).group()
                    i += len(n)
                    args.append(head[i:i + int(n)])
                    i += int(n)
                else:
                    i += 1
            if len(args) == 3:  # <bool, Job<Source>>
                name += f"<{args[0]}, {args[1]}<{args[2]}>>"
            elif args:
                name += "<" + ", ".join(args) + ">"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            spills = (f"{m.group(1)} B stack frame, {m.group(2)} B spill stores, "
                      f"{m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name}: {m.group(1)} registers, {spills}, "
                       f"{smem.group(1) if smem else 0} B smem")
            name = None
    return out


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sh(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def compare(got, want, pt, what):
    """Kernel output vs plain version under the stated tolerance; returns
    the largest absolute difference."""
    import torch

    d = (got - want).abs()
    max_err = float(d.max())
    tight = float((d <= TIGHT).float().mean())
    dd = (pt.to_display(got).int() - pt.to_display(want).int()).abs()
    disp_frac = float((dd <= DISPLAY_STEPS).float().mean())
    flips = int((dd > DISPLAY_MAX).any(dim=-1).sum())
    allowed = math.ceil(FLIP_FRAC * got.shape[0] * got.shape[1])
    print(f"  {what}: max_abs_err {max_err:.3e}, {100 * tight:.4f}% within "
          f"{TIGHT:g}, display: {100 * disp_frac:.4f}% within "
          f"±{DISPLAY_STEPS}, {flips} pixels beyond {DISPLAY_MAX} "
          f"(allowed {allowed})", flush=True)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(tight >= TIGHT_FRAC, f"{what}: only {tight:.6f} within {TIGHT}")
    check(disp_frac >= DISPLAY_FRAC, f"{what}: only {disp_frac:.6f} within ±2")
    check(flips <= allowed, f"{what}: {flips} pixels beyond {DISPLAY_MAX} steps")
    return max_err


def main():
    import numpy as np
    import torch

    from ptre_tpu_torch.utils.config import RenderConfig
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.models.scene import Scene
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import render_kernel as rk
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.device import require_cuda

    # ---- 1. environment ------------------------------------------------------
    t_run = time.perf_counter()
    dev = require_cuda()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(card, flush=True)
    print(f"torch {torch.__version__}, device {torch.cuda.get_device_name(dev)}, "
          f"torch.version.cuda {torch.version.cuda}", flush=True)
    print(sh([build.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
    # the first designs of the render, recording, fused backward and mask
    # kernels (csrc/baseline/), of the hard raster kernel and the culled
    # megakernel (csrc/baseline/raster_mega/) and of the replay pair
    # (csrc/baseline/replay_pair/), each against its own frozen headers:
    # phases 2-7, 9, 12, 15, 17 and 21 hold the shipped kernels to them and
    # time both in turns, compiled beside the library
    first = {u: start_baseline_build(u) for u in (
        "render_kernel.cu", "record_kernel.cu", "fused_grad_kernel.cu", "mask_kernel.cu")}
    first.update({u: start_baseline_build(u, "raster_mega")
                  for u in ("raster_kernel.cu", "mega_kernel.cu")})
    first["replay_kernel.cu"] = start_baseline_build("replay_kernel.cu", "replay_pair")
    # the mask unit as shipped before it took more than 1,024 leaves
    # (csrc/baseline/mask_static/, against the shipped headers): phases 9
    # and 24 time the shipped staged instantiation in turns with it
    first["mask_static"] = start_unit_build(
        "mask_kernel.cu", "mask_static", ("-I", build.CSRC_DIR),
        os.path.join(build.CSRC_DIR, "baseline", "mask_static"))
    # the bounce unit as shipped before the warp sweep (csrc/baseline/
    # wave_lane/): phases 10 and 24 hold the shipped unit to it and time both
    first["wave_lane"] = start_wave_lane_build()
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    # the fused backward built WITH FMA contraction, the variant not shipped
    # (phases 7, 17 and 21 read it beside the shipped one); compiles while
    # phases 1-6 run
    fused_fma = start_unit_build("fused_grad_kernel.cu", "fma")
    if build.last_build is not None:
        print(f"kernel build {build.last_build[0]:.2f} s (nvcc, sm_90a, "
              f"{len(build.KERNEL_UNITS)} units); " + "; ".join(
                  ptxas_summary(build.last_build[1])) + f" [{card}]", flush=True)
    else:
        print(f"kernel library already built; load {build_s:.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = []
    first = {u: finish_unit_build(b, report) for u, b in first.items()}
    print("first designs (csrc/baseline/, the shipped units' flags): " + "; ".join(report)
          + f" [{card}]", flush=True)
    first_render = baseline_render(first["render_kernel.cu"], rk)
    first_record = baseline_record(first["record_kernel.cu"], mk)

    def inputs(scene, W, H, max_depth=5, cam_kw=None):
        cfg = RenderConfig(width=W, height=H, max_depth=max_depth)
        packed = mk.pack_scene(scene.build_packet(device=dev))
        rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H, **(cam_kw or {})))
        return cfg, packed, rows

    def kernel_and_plain(prev, packed, rows, n, cfg, seed, urand):
        """The kernel's and the plain version's sample on ``prev``; the
        kernel's image also against the first design's, pixel for pixel (the
        same per-path arithmetic: a pixel may differ only where FMA
        contraction, placed otherwise by nvcc, flipped a path)."""
        want = rk.sample_accum_reference(prev, packed, rows, n, cfg, seed, urand)
        got, fst = prev.clone(), prev.clone()
        rk.sample_accum(got, packed, rows, n, cfg, seed, urand)
        first_render(fst, packed, rows, n, cfg, seed, urand)
        torch.cuda.synchronize()
        H, W = prev.shape[:2]
        differ, allowed = int((got != fst).any(dim=-1).sum()), math.ceil(FLIP_FRAC * W * H)
        print(f"  {W}x{H}: {differ} pixels differ from the first design's (allowed {allowed})",
              flush=True)
        check(differ <= allowed, f"{W}x{H}: {differ} pixels differ from the first design's")
        return got, want

    rs = np.random.default_rng(2024)
    demo_scene = demo.reference_demo_scene(32, 16)

    # ---- 2. kernel vs plain version, external uniforms -------------------------
    print("phase 2: 1920x1080, max_depth 5, n = 3, external uniforms", flush=True)
    cfg, packed, rows = inputs(demo_scene, W_MAIN, H_MAIN)
    prev = torch.from_numpy(rs.random((H_MAIN, W_MAIN, 3), dtype=np.float32)).to(dev)
    urand = torch.from_numpy(
        rs.random((2 + 2 * cfg.max_depth, H_MAIN, W_MAIN), dtype=np.float32)).to(dev)
    err_ext = compare(*kernel_and_plain(prev, packed, rows, 3, cfg, 0, urand), pt,
                      "external uniforms")

    # ---- 3. kernel vs plain version, in-kernel Philox ---------------------------
    print("phase 3: 1920x1080, in-kernel Philox vs torch Philox", flush=True)
    err_philox = compare(*kernel_and_plain(prev, packed, rows, 3, cfg, 0x5EED, None),
                         pt, "philox")

    # ---- 4. ragged and edge cases ----------------------------------------------
    print("phase 4: ragged image, empty scene, orthographic, reset", flush=True)
    cfg_r, packed_r, rows_r = inputs(demo_scene, 100, 37)
    prev_r = torch.from_numpy(rs.random((37, 100, 3), dtype=np.float32)).to(dev)
    got, want = kernel_and_plain(prev_r, packed_r, rows_r, 2, cfg_r, 11, None)
    compare(got, want, pt, "100x37 ragged")
    check(not torch.equal(got, prev_r), "100x37: kernel left the accumulator unchanged")

    cfg_e, packed_e, rows_e = inputs(Scene(), 320, 180)
    zero = torch.zeros((180, 320, 3), device=dev)
    got, want = kernel_and_plain(zero, packed_e, rows_e, 1, cfg_e, 5, None)
    e = float((got - want).abs().max())
    print(f"  empty scene (pure sky): max_abs_err {e:.3e}", flush=True)
    check(e == 0.0, f"empty scene: kernel differs from plain by {e}")

    cfg_o, packed_o, rows_o = inputs(demo_scene, 320, 180,
                                     cam_kw=dict(projection=cam_ops.ORTHOGRAPHIC))
    prev_o = torch.from_numpy(rs.random((180, 320, 3), dtype=np.float32)).to(dev)
    compare(*kernel_and_plain(prev_o, packed_o, rows_o, 4, cfg_o, 12, None), pt,
            "orthographic 320x180")

    pkt_small = demo_scene.build_packet(device=dev)
    cam_small = cam_ops.Camera.create(width=320, height=180)
    acc = pt.render_step(pkt_small, cam_small, pt.AccumState.create(180, 320, dev), 1,
                         cfg_o, spp=2)
    acc = pt.render_step(pkt_small, cam_small, acc.reset(),
                         torch.Generator().manual_seed(9), cfg_o, spp=1)
    fresh = pt.render_step(pkt_small, cam_small, pt.AccumState.create(180, 320, dev),
                           torch.Generator().manual_seed(9), cfg_o, spp=1)
    torch.cuda.synchronize()
    check(acc.frame == 1 and torch.equal(acc.linear, fresh.linear),
          "reset: the n = 1 sample did not overwrite history")
    print("  reset: n = 1 sample overwrote history exactly", flush=True)

    # ---- 5. the main path ---------------------------------------------------------
    def drive(W, H):
        """Demo scene → render_step (1 warm-up + STEPS timed steps, spp SPP)
        → to_display. Returns (launches, seconds of the timed steps, image)."""
        cfg = RenderConfig(width=W, height=H)
        pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
        cam = cam_ops.Camera.create(width=W, height=H)
        gen = torch.Generator().manual_seed(cfg.seed)
        rk.launches = 0
        acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, dev), gen, cfg, spp=SPP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            acc = pt.render_step(pkt, cam, acc, gen, cfg, spp=SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = rk.launches
        img = pt.to_display(acc.linear)
        torch.cuda.synchronize()
        lin = acc.linear
        check(launches == SPP * (STEPS + 1), f"{W}x{H}: {launches} kernel launches, "
              f"expected {SPP * (STEPS + 1)}")
        check(acc.frame == SPP * (STEPS + 1), f"{W}x{H}: frame {acc.frame}")
        check(bool(torch.isfinite(lin).all()), f"{W}x{H}: non-finite image")
        # clamped samples in [0, 1]; the running average c/n + lin*(n-1)/n
        # of values 1 can round an ulp above 1
        check(float(lin.min()) >= 0.0 and float(lin.max()) <= 1.0 + 1e-6,
              f"{W}x{H}: image outside [0, 1]: {float(lin.min())}, {float(lin.max())}")
        check(img.shape == (H, W, 3) and img.dtype == torch.uint8, f"{W}x{H}: display")
        # the top row looks into the sky: an average of gradient values
        # (1-a)*bottom + a*top, bottom (1,1,1), top (0.5,0.7,1), with a > 0.5
        top = lin[0]
        a_r = (1.0 - top[:, 0]) / 0.5
        a_g = (1.0 - top[:, 1]) / 0.3
        check(float((top[:, 2] - 1.0).abs().max()) < 1e-5, f"{W}x{H}: top row blue is not 1")
        check(float((a_r - a_g).abs().max()) < 1e-4 and float(a_r.min()) > 0.5,
              f"{W}x{H}: top row is not the sky gradient")
        device_share(lambda: pt.render_step(pkt, cam, acc, gen, cfg, spp=SPP), 4,
                     f"render_step {W}x{H} spp {SPP}", card)
        return launches, dt, img

    def time_kernel(W, H, reps=20):
        """Kernel ms per sample (CUDA events), in turns with the first design
        on one sample's inputs, and both designs' active-lane shares from the
        counting instantiation (every pixel's path started once, the same
        image as the first design's); returns (ms, first design ms, this
        design's counts)."""
        cfg, packed, rows = inputs(demo_scene, W, H)
        host_rows = rows.tolist()  # the first design's by-value camera, read before timing
        acc = torch.zeros((H, W, 3), device=dev)
        times = in_turns({"shipped": lambda: rk.sample_accum(acc, packed, rows, 4, cfg, 100),
                          "first design": lambda: first_render(acc, packed, host_rows, 4, cfg,
                                                               100)},
                         reps)
        print(f"  render kernel {W}x{H}, in turns: " + ", ".join(
            f"{label} {ms:.4f} ms" for label, ms in times.items()) + f" (CUDA events) [{card}]",
            flush=True)
        want = first_render(acc.clone(), packed, rows, 4, cfg, 100)
        st = torch.zeros(len(mk.DENSE_STATS), dtype=torch.int64, device=dev)
        lens = torch.zeros((H, W), dtype=torch.int32, device=dev)
        got = rk.sample_accum(acc.clone(), packed, rows, 4, cfg, 100, stats=st, lens=lens)
        torch.cuda.synchronize()
        st = st.tolist()
        differ = int((got != want).any(dim=-1).sum())
        check(st[0] == W * H, f"render: {st[0]} paths started, expected {W * H}")
        check(int(lens.sum()) == st[1], f"render: path lengths sum to {int(lens.sum())}, "
              f"{st[1]} live ray-bounces")
        check(differ <= math.ceil(FLIP_FRAC * W * H),
              f"render: {differ} pixels differ from the first design's")
        lane_share(st, first_design_warp_bounces(lens), f"render {W}x{H} ({differ} pixels "
                   "differ from the first design's)", card)
        return times["shipped"], times["first design"], st

    def time_plain(W, H):
        """Plain version on the card, one step of SPP samples: ms per sample."""
        cfg, packed, rows = inputs(demo_scene, W, H)
        acc = torch.zeros((H, W, 3), device=dev)
        acc = rk.sample_accum_reference(acc, packed, rows, 1, cfg, 1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(SPP):
            acc = rk.sample_accum_reference(acc, packed, rows, 2 + s, cfg, 2 + s)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SPP

    results = {}
    for W, H in ((W_MAIN, H_MAIN), (1280, 720)):
        print(f"phase 5: main path {W}x{H}, spp {SPP}, 1 + {STEPS} steps", flush=True)
        launches, dt, _ = drive(W, H)
        ms_step_sample = dt * 1e3 / (STEPS * SPP)
        mrays = W * H * SPP * STEPS * 5 / dt / 1e6
        k_ms, first_ms, counts = time_kernel(W, H)
        p_ms = time_plain(W, H)
        p_mrays = W * H * 5 / (p_ms / 1e3) / 1e6
        results[(W, H)] = (launches, k_ms, p_ms, first_ms, counts)
        print(f"  render_step: {ms_step_sample:.4f} ms/sample, {mrays:.2f} Mrays/s "
              f"(W*H*spp*steps*max_depth/s, host clock) [{card}]", flush=True)
        print(f"  kernel alone: {k_ms:.4f} ms/sample (CUDA events) [{card}]", flush=True)
        print(f"  plain PyTorch on the card: {p_ms:.3f} ms/sample, {p_mrays:.2f} "
              f"Mrays/s [{card}]", flush=True)

    launches, k_ms, p_ms, first_ms, counts = results[(W_MAIN, H_MAIN)]
    render = {
        "name": "render_sample",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/render_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/render_kernel.py:79",
        "launches": launches,
        "max_abs_err": max(err_ext, err_philox),
        "ms": k_ms,
        "plain_ms": p_ms,
        "first_design_ms": first_ms,
        "active_lane_share": counts[1] / (32 * counts[3]),
    }
    from ptre_tpu_torch.ops.cuda import fused_grad

    fma_bwd = lib_fused_bwd(finish_unit_build(fused_fma), fused_grad)
    first_bwd = baseline_fused_bwd(first["fused_grad_kernel.cu"], fused_grad, mk)
    grad_kernels = gradient_phases(dev, card, rs, fma_bwd, first_bwd, first_record)
    # one sample: the accumulator read and written; the render kernel's own
    # counts of its timed 1080p sample
    kernels = [with_bound(render, 2 * W_MAIN * H_MAIN * 12,
                          dense_ops(counts, demo_scene.build_packet(device=dev), "render"))]
    kernels += grad_kernels
    from ptre_tpu_torch.ops.cuda import wavefront

    static_mask = lean_wave_mask(first["mask_static"], wavefront, mk)
    lane_bounce = lib_wave_bounce(first["wave_lane"], wavefront)
    kernels += wavefront_phases(dev, card, rs,
                                baseline_wave_mask(first["mask_kernel.cu"], wavefront, mk),
                                static_mask, lane_bounce)
    from ptre_tpu_torch.ops.cuda import raster_kernel as rast

    kernels += raster_phases(dev, card, rs, baseline_raster_hard(first["raster_kernel.cu"], rast))
    kernels += triangle_training_phases(dev, card, rs, fma_bwd, first_bwd,
                                        baseline_trace_culled(first["mega_kernel.cu"], mk),
                                        dense_bwd_ms=grad_kernels[1]["ms"])
    kernels.append(staged_phases(dev, card, rs, build.last_build and build.last_build[1]))
    from ptre_tpu_torch.ops.cuda import replay_kernel as rpk

    kernels += replay_phases(dev, card, rs, fma_bwd,
                             lib_replay_pair(first["replay_kernel.cu"], rpk, mk))
    engine_phase(dev, card)
    sharding_phase(dev, card)
    kernels.append(past_cap_phase(dev, card, rs, static_mask, lane_bounce))
    materials_phase(dev, card, rs)
    remat_phase(dev, card)
    kernels.append(take_rows_phase(dev, card))

    # ---- result --------------------------------------------------------------------
    print(f"chip_smoke.py: every phase passed in {time.perf_counter() - t_run:.1f} s, the "
          f"kernels' builds included [{card}]", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


BWD_GEOMETRY = ("v0-v2", "n0-n2", "center", "radius")


def bwd_ops(sel, table, T):
    """(operations, the old count, {kind: bounces}) of the fused backward on
    recorded selections ``sel`` (B, R) over ``table`` (spheres from row T):
    every bounce of a path by its kind (a triangle or sphere hit that goes
    on, an emitter or a miss that ends it), at the OPS_BWD_* counts."""
    import torch

    emissive = table[:, 22] > 0.5
    live = torch.ones(sel.shape[1], dtype=torch.bool, device=sel.device)
    n = {"triangle": 0, "sphere": 0, "emitter": 0, "miss": 0}
    for b in range(sel.shape[0]):
        s = sel[b]
        hit = s >= 0
        emit = hit & emissive[s.clamp(min=0).long()]
        n["miss"] += int((live & ~hit).sum())
        n["emitter"] += int((live & emit).sum())
        n["triangle"] += int((live & hit & ~emit & (s < T)).sum())
        n["sphere"] += int((live & hit & ~emit & (s >= T)).sum())
        live = live & hit & ~emit
    ops = (n["triangle"] * OPS_BWD_TRI + n["sphere"] * OPS_BWD_SPH
           + n["emitter"] * OPS_BWD_EMIT + n["miss"] * OPS_BWD_MISS)
    return ops, int((sel >= 0).sum()) * OPS_BWD_BOUNCE_OLD, n


def hold_first_design(what, fn, first_fn, args, reps, extra, card):
    """The fused backward against its first design on one recorded trace:
    d(o), d(d) bit for bit (the same chain and adjoint, no operation
    reordered), d(table) and d(sky) summed in another order by atomics, their
    distance printed beside each design's run-to-run spread; then both, and
    ``extra`` ({label: function}), timed in turns. Returns {label: ms}."""
    import torch

    a, b = fn(*args), fn(*args)
    fa, fb = first_fn(*args), first_fn(*args)
    torch.cuda.synchronize()
    check(torch.equal(a[2], fa[2]) and torch.equal(a[3], fa[3]),
          f"{what}: d(o), d(d) differ from the first design's")
    check(torch.equal(a[2], b[2]) and torch.equal(a[3], b[3]), f"{what}: d(o), d(d) differ "
          "between two runs")

    def rel(x, y):
        return float((x - y).norm() / y.norm())

    print(f"  {what}: d(o), d(d) bit-equal to the first design's (csrc/baseline/); relative "
          f"L2 d(table) / d(sky): against the first design {rel(a[0], fa[0]):.3e} / "
          f"{rel(a[1], fa[1]):.3e}, two runs {rel(a[0], b[0]):.3e} / {rel(a[1], b[1]):.3e}, "
          f"two runs of the first design {rel(fa[0], fb[0]):.3e} / {rel(fa[1], fb[1]):.3e}",
          flush=True)
    del a, b, fa, fb
    times = in_turns({"shipped": lambda: fn(*args), "first design": lambda: first_fn(*args),
                      **{label: (lambda f=f: f(*args)) for label, f in extra.items()}}, reps)
    if times:
        print(f"  {what}, in turns: " + ", ".join(f"{label} {ms:.4f} ms"
                                                 for label, ms in times.items())
              + f" (CUDA events) [{card}]", flush=True)
    return times


def hold_deepest(what, fg, first_fn, record, rays, dcol, k, T, seed, card):
    """`hold_first_design` at the wrapper's deepest max_depth (8, `kMaxDepth`),
    where a block's saved states take 88 KB of shared memory and one block
    fits an SM, on the selections ``record(8)`` records, with ``rays``
    (table, sky6, o, d)."""
    from ptre_tpu_torch.ops.cuda.megakernel import MAX_DEPTH

    sel = record(MAX_DEPTH)
    n = int((sel[MAX_DEPTH - 1] >= 0).sum())
    print(f"  {what}, max_depth {MAX_DEPTH}: {int((sel >= 0).sum())} hits, {n} at the "
          "last bounce", flush=True)
    hold_first_design(f"{what} max_depth {MAX_DEPTH}", fg.fused_bwd, first_fn,
                      (*rays, sel, dcol, k, MAX_DEPTH, T, seed, 0), 10, {}, card)


def hold_backward(fg, mk, what, table, sky6, o, d, sel, dcol, k, B, T, seed, ur, groups,
                  kernel=None, plain=None, read=None):
    """A backward kernel against its plain version on one recorded trace,
    under the tolerances stated at RAY_TIGHT above; returns the largest
    absolute error outside the flipped rays. ``groups`` names column slices
    of the table. ``kernel``, ``plain``: functions of `fused_bwd`'s
    arguments that return (d table, d sky6, d o, d d); None: `fused_bwd`
    and `fused_bwd_reference`. ``read``: {label: (such a function, held)}
    whose geometry sums are printed against float64 beside the kernel's, on
    the same cotangent; those ``held`` are also held there as the kernel's,
    at GEOM_FACTOR times the plain float32's distance."""
    import torch

    f64 = torch.float64
    R = o.shape[0]
    ur64 = mk.trace_uniforms(o, B, seed, 0, ur).to(f64)
    kernel = kernel or fg.fused_bwd
    plain = plain or fg.fused_bwd_reference

    def three(cot):
        """kernel, plain float32, plain float64 — the same inputs."""
        out = (kernel(table, sky6, o, d, sel, cot, k, B, T, seed, 0, ur),
               plain(table, sky6, o, d, sel, cot, k, B, T, seed, 0, ur),
               plain(table.to(f64), sky6.to(f64), o.to(f64), d.to(f64), sel, cot.to(f64), k,
                     B, T, seed, 0, ur64))
        torch.cuda.synchronize()
        return out

    def flipped(a, b, mag):
        err = ((a[2].to(f64) - b[2].to(f64)).abs()
               + (a[3].to(f64) - b[3].to(f64)).abs()).amax(dim=1)
        return err > FLIP_REL * mag + RAY_ATOL

    bwd_err = 0.0
    got, want, exact = three(dcol)
    mag = (exact[2].abs() + exact[3].abs()).amax(dim=1)
    flip_k, flip_p = flipped(got, want, mag), flipped(want, exact, mag)
    for name, a, b in (("d(o)", got[2], want[2]), ("d(d)", got[3], want[3])):
        top = float(b.abs().max())
        err = (a - b).abs()
        frac = float((err <= RAY_TIGHT * top).float().mean())
        bwd_err = max(bwd_err, float(err[~flip_k].max()))
        print(f"  {what} {name}: max_abs_err {float(err.max()):.3e}, "
              f"{float(err[~flip_k].max()):.3e} outside flipped rays (largest "
              f"{top:.3e}); {100 * frac:.4f}% within {RAY_TIGHT:g} of the largest",
              flush=True)
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite {name}")
        check(frac >= TIGHT_FRAC, f"{what}: only {frac:.6f} of {name} within")
    allowed = math.ceil(BWD_FLIP_FRAC * R)
    print(f"  {what}: {int(flip_k.sum())} rays flipped between kernel and plain "
          f"(allowed {allowed}); {int(flip_p.sum())} between plain float32 and "
          f"float64", flush=True)
    check(int(flip_k.sum()) <= allowed, f"{what}: {int(flip_k.sum())} flipped")
    del got, want, exact
    # the summed gradients, without the flipped rays' cotangents
    cot = torch.where((flip_k | flip_p)[:, None], 0.0, dcol)
    got, want, exact = three(cot)
    others = {label: (fn(table, sky6, o, d, sel, cot, k, B, T, seed, 0, ur)[0].to(f64), held)
              for label, (fn, held) in (read or {}).items()}
    named = [(n, sl) for n, sl in groups.items()] + [("sky", None)]
    for name, sl in named:
        a, b, e = ((x[1] if sl is None else x[0][:, sl]).to(f64)
                   for x in (got, want, exact))
        if float(e.norm()) == 0.0:  # no gradient reaches it (emissive cube)
            check(float(a.norm()) == 0.0, f"{what}: d(table) {name} not zero")
            continue
        rel_p = float((a - b).norm() / b.norm())
        rel_k64 = float((a - e).norm() / e.norm())
        rel_p64 = float((b - e).norm() / e.norm())
        bwd_err = max(bwd_err, float((a - b).abs().max()))
        rel_read = {label: float((x[:, sl] - e).norm() / e.norm())
                    for label, (x, _) in others.items() if name in BWD_GEOMETRY}
        read_line = "".join(f", {label}-float64 {v:.3e}" for label, v in rel_read.items())
        print(f"  {what} d({'sky' if sl is None else 'table ' + name}): relative L2 "
              f"kernel-plain {rel_p:.3e}, kernel-float64 {rel_k64:.3e}, "
              f"plain-float64 {rel_p64:.3e}{read_line}", flush=True)
        if name in BWD_GEOMETRY:
            check(rel_k64 <= max(SUM_REL, GEOM_FACTOR * rel_p64),
                  f"{what}: d(table) {name} off float64 by {rel_k64}")
            for label, v in rel_read.items():
                check(not others[label][1] or v <= max(SUM_REL, GEOM_FACTOR * rel_p64),
                      f"{what}: {label} d(table) {name} off float64 by {v}")
        else:
            check(rel_p <= SUM_REL, f"{what}: d({name}) relative L2 {rel_p}")
    check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
          f"{what}: non-finite d(table) or d(sky)")
    return bwd_err


def gradient_phases(dev, card, rs, fma_bwd, first_bwd, first_record):
    """Phases 6-8: the recording and fused backward kernels against their
    plain versions, then the training step (`mse_step`) at 1920x1080.
    ``fma_bwd``: `fused_bwd` on the unit built with FMA contraction, read
    and timed beside the shipped one; ``first_bwd``: the fused backward's
    first design (`baseline_fused_bwd`), held bit for bit and timed beside
    it; ``first_record``: the recording kernel's first design
    (`baseline_record`), held ray for ray and timed beside it.
    Returns the two kernels' entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from ptre_tpu_torch.utils.config import RenderConfig
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import integrator, path_replay, rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import fused_grad as fg
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import train

    W, H, B = W_MAIN, H_MAIN, 5
    R = W * H
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    params = sh.differentiable_params(pkt, cam)
    _, cam_dev = sh.apply_params(params, pkt, cam)
    px, py = pt.pixel_grid(H, W, dev)
    jit = rng.ray_uniforms(GRAD_SEED, 0, R, 1, dev) - 0.5
    o, d = (t.contiguous() for t in cam_ops.get_rays(cam_dev, px, py, jit.T))
    scene = mk.pack_scene(pkt)
    k = mk.TraceConsts.from_config(cfg)
    table, T, sky6 = path_replay.build_table(pkt)
    urand_ext = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)).to(dev)

    # ---- 6. recording kernel vs its plain version --------------------------------
    print(f"phase 6: recording kernel vs plain, {W}x{H}, max_depth {B}", flush=True)
    rec_err, recorded = 0.0, {}
    for mode, ur in (("external uniforms", urand_ext), ("philox", None)):
        color, sel = mk.trace_fused_sel(o, d, scene, k, B, GRAD_SEED, 0, ur)
        want_c, want_s = mk.trace_record_reference(o, d, scene, k, B, GRAD_SEED, 0, ur)
        torch.cuda.synchronize()
        diff = (color - want_c).abs()
        scale = want_c.abs().clamp_min(1.0)
        tight = float((diff <= TIGHT * scale).float().mean())
        flip = (diff > 0.05 * scale).any(dim=1) | (sel != want_s).any(dim=0)
        flipped = int(flip.sum())
        sel_rays = int((sel != want_s).any(dim=0).sum())
        allowed = math.ceil(FLIP_FRAC * R)
        rec_err = max(rec_err, float(diff[~flip].max()))
        print(f"  {mode}: color max_abs_err {float(diff.max()):.3e}, "
              f"{100 * tight:.4f}% within {TIGHT:g} (relative above 1); "
              f"{sel_rays} rays with other selections, {flipped} flipped rays "
              f"(allowed {allowed}); {int((sel >= 0).sum())} hits recorded", flush=True)
        check(bool(torch.isfinite(color).all()), f"record {mode}: non-finite color")
        check(tight >= TIGHT_FRAC, f"record {mode}: only {tight:.6f} within {TIGHT}")
        check(flipped <= allowed, f"record {mode}: {flipped} flipped rays")
        check(bool(((sel >= -1) & (sel < table.shape[0])).all()), f"record {mode}: bad rows")
        # the first design: the same per-path arithmetic (a ray may differ
        # only where FMA contraction, placed otherwise by nvcc, flipped it)
        fc, fs = first_record(o, d, scene, k, B, GRAD_SEED, 0, ur)
        torch.cuda.synchronize()
        other_sel = int((sel != fs).any(dim=0).sum())
        other_col = int((color != fc).any(dim=1).sum())
        print(f"  {mode}: against the first design {other_sel} rays with other selections, "
              f"{other_col} with another colour (allowed {allowed})", flush=True)
        check(other_sel <= allowed and other_col <= allowed,
              f"record {mode}: {other_sel} / {other_col} rays differ from the first design")
        recorded[mode] = (sel, ur)

    # ---- 7. backward kernel vs its plain version ----------------------------------
    print(f"phase 7: fused backward kernel vs plain, {W}x{H}, same selections", flush=True)
    dcol = torch.from_numpy(rs.standard_normal((R, 3), dtype=np.float32)).to(dev)
    bwd_err = 0.0
    groups = {"v0-v2": slice(0, 9), "n0-n2": slice(9, 18), "center": slice(18, 21),
              "radius": slice(21, 22), "albedo": slice(23, 26), "param": slice(26, 27)}
    for mode, (sel, ur) in recorded.items():
        bwd_err = max(bwd_err, hold_backward(fg, mk, f"bwd {mode}", table, sky6, o, d, sel,
                                             dcol, k, B, T, GRAD_SEED, ur, groups,
                                             read={"with FMA": (fma_bwd, False)}))

    # kernel times at the main shape (CUDA events) and the plain versions'
    sel_p, _ = recorded["philox"]
    # this sample's work: a ray sweeps the scene at bounce 0 and after every
    # hit on a non-emissive surface; hits are the recorded rows
    kind = pkt.mat_kind.long()
    emissive = torch.cat([kind[pkt.tri_mat.long()] == 1, kind[pkt.sph_mat.long()] == 1])
    hit = sel_p >= 0
    go_on = hit & ~emissive[sel_p.clamp(min=0).long()]
    sweeps, hits = R + int(go_on[:-1].sum()), int(hit.sum())
    print(f"  philox sample: {sweeps} ray-bounce sweeps ({sweeps / R:.3f} a ray), {hits} hits",
          flush=True)
    rec_times = in_turns(
        {"shipped": lambda: mk.trace_fused_sel(o, d, scene, k, B, GRAD_SEED, 0),
         "first design": lambda: first_record(o, d, scene, k, B, GRAD_SEED, 0)}, 20)
    rec_ms = rec_times["shipped"]
    print("  record kernel, in turns: " + ", ".join(
        f"{label} {ms:.4f} ms" for label, ms in rec_times.items()) + f" (CUDA events) [{card}]",
        flush=True)
    fc, fs = first_record(o, d, scene, k, B, GRAD_SEED, 0)
    counts = torch.zeros(len(mk.DENSE_STATS), dtype=torch.int64, device=dev)
    lens = torch.zeros(R, dtype=torch.int32, device=dev)
    c, s = mk.trace_fused_sel(o, d, scene, k, B, GRAD_SEED, 0, stats=counts, lens=lens)
    torch.cuda.synchronize()
    differ = int(((s != fs).any(dim=0) | (c != fc).any(dim=1)).sum())
    check(differ <= math.ceil(FLIP_FRAC * R),
          f"record: {differ} rays differ from the first design's")
    counts = counts.tolist()
    # the counting instantiation traces the same paths (but where FMA
    # contraction, placed otherwise, flips one)
    off = max(abs(counts[1] - sweeps), abs(counts[2] - hits))
    check(counts[0] == R and off <= B * math.ceil(FLIP_FRAC * R),
          f"record: counts {counts[:3]}, expected {[R, sweeps, hits]} (paths, live "
          "ray-bounces, hits)")
    check(int(lens.sum()) == counts[1], f"record: path lengths sum to {int(lens.sum())}, "
          f"{counts[1]} live ray-bounces")
    rec_share = lane_share(counts, first_design_warp_bounces(lens), f"record {W}x{H} "
                           f"({differ} rays differ from the first design's)", card)
    print("  registers: " + "; ".join(
        e for e in (ptxas_summary(build.last_build[1]) if build.last_build else
                    ["library not built in this run"]) if e.startswith(("fused_bwd", "library"))),
        flush=True)
    sel_x, ur_x = recorded["external uniforms"]
    hold_first_design("bwd external uniforms", fg.fused_bwd, first_bwd,
                      (table, sky6, o, d, sel_x, dcol, k, B, T, GRAD_SEED, 0, ur_x), 0, {},
                      card)
    bwd = hold_first_design("bwd philox", fg.fused_bwd, first_bwd,
                            (table, sky6, o, d, sel_p, dcol, k, B, T, GRAD_SEED, 0), 10,
                            {"with FMA": fma_bwd}, card)
    bwd_ms = bwd["shipped"]
    rec_plain_ms = cuda_events(lambda: mk.trace_record_reference(o, d, scene, k, B,
                                                                 GRAD_SEED, 0), 2)
    bwd_plain_ms = cuda_events(lambda: fg.fused_bwd_reference(
        table, sky6, o, d, sel_p, dcol, k, B, T, GRAD_SEED, 0), 2)
    print("  dense kernels' registers: " + "; ".join(
        e for e in (ptxas_summary(build.last_build[1]) if build.last_build else
                    ["library not built in this run"]) if e.startswith(("dense", "library"))),
        flush=True)
    print(f"  record kernel {rec_ms:.4f} ms, plain {rec_plain_ms:.3f} ms; backward "
          f"kernel {bwd_ms:.4f} ms (built without FMA contraction; with it "
          f"{bwd['with FMA']:.4f} ms, the first design {bwd['first design']:.4f} ms, in "
          f"turns), plain {bwd_plain_ms:.3f} ms (CUDA events, {W}x{H}) [{card}]", flush=True)
    bwd_op, bwd_op_old, bwd_kinds = bwd_ops(sel_p, table, T)
    print(f"  backward's bounces by kind {bwd_kinds}: {bwd_op / 1e9:.3f} GFLOP counted from "
          f"replay.cuh (the old count, {OPS_BWD_BOUNCE_OLD} a hit, {bwd_op_old / 1e9:.3f})",
          flush=True)
    hold_deepest("bwd philox", fg, first_bwd, lambda b: mk.trace_fused_sel(
        o, d, scene, k, b, GRAD_SEED, 0)[1], (table, sky6, o, d), dcol, k, T, GRAD_SEED, card)
    del recorded, dcol, urand_ext

    # ---- 8. the training main path ---------------------------------------------------
    print(f"phase 8: training main path {W}x{H}: mse_step spp 1 (1 + {STEPS} steps), "
          f"spp {SPP_TRAIN} (1 + 1 steps), two_pass_mse_step spp {SPP_TRAIN}", flush=True)
    target = torch.zeros((R, 3), device=dev)

    def step(spp, seed):
        loss, grads = train.mse_step(params, pkt, cam, target, cfg, seed, spp=spp)
        torch.cuda.synchronize()
        check(math.isfinite(float(loss)), f"mse_step spp {spp}: loss {float(loss)}")
        for key, g in grads.items():
            check(bool(torch.isfinite(g).all()), f"mse_step spp {spp}: non-finite d{key}")
        return loss, grads

    mk.record_launches = fg.launches = 0
    step(1, 100)
    t0 = time.perf_counter()
    for i in range(STEPS):
        loss, grads = step(1, 101 + i)
    dt1 = (time.perf_counter() - t0) / STEPS
    launches = (mk.record_launches, fg.launches)
    check(launches == (STEPS + 1, STEPS + 1), f"spp-1 steps: launches {launches}, "
          f"expected {STEPS + 1} of each kernel")
    check(float(grads["mat_albedo"].abs().max()) > 0 and
          float(grads["sph_radius"].abs().max()) > 0 and
          float(grads["cam_position"].abs().max()) > 0, "spp-1 step: zero gradients")
    torch.cuda.reset_peak_memory_stats()
    step(1, 200)
    peak1 = torch.cuda.max_memory_allocated()
    print(f"  spp 1: {dt1 * 1e3:.3f} ms/step, {R * B / dt1 / 1e6:.2f} Mrays/s fwd+bwd "
          f"(W*H*max_depth/s, host clock), loss {float(loss):.6f}, peak "
          f"{peak1 / 2**20:.1f} MiB [{card}]", flush=True)

    # the first spp-64 step grows the caching allocator (before its samples
    # were rematerialised, by ~19 GiB: 1.9 s against ~1.0 s for the next
    # ones): one warm-up step first. Each sample's forward runs again in the
    # backward: two record launches a sample, one backward
    step(SPP_TRAIN, 299)
    mk.record_launches = fg.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss64, _ = step(SPP_TRAIN, 300)
    dt64 = time.perf_counter() - t0
    peak64 = torch.cuda.max_memory_allocated()
    check((mk.record_launches, fg.launches) == (2 * SPP_TRAIN, SPP_TRAIN),
          f"spp-{SPP_TRAIN} step: launches {(mk.record_launches, fg.launches)}")
    print(f"  spp {SPP_TRAIN}: {dt64 * 1e3:.1f} ms/step, "
          f"{R * SPP_TRAIN * B / dt64 / 1e6:.2f} Mrays/s (W*H*spp*max_depth/s), loss "
          f"{float(loss64):.6f}, peak {peak64 / 2**30:.2f} GiB [{card}]", flush=True)

    # the constant-memory schedule at the same shape
    mk.record_launches = fg.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss2p, grads2p = train.two_pass_mse_step(params, pkt, cam, target, cfg, 300,
                                              spp=SPP_TRAIN)
    torch.cuda.synchronize()
    dt2p = time.perf_counter() - t0
    peak2p = torch.cuda.max_memory_allocated()
    check((mk.record_launches, fg.launches) == (2 * SPP_TRAIN, SPP_TRAIN),
          f"two-pass spp {SPP_TRAIN}: launches {(mk.record_launches, fg.launches)}")
    check(abs(float(loss2p) - float(loss64)) <= 1e-6 * abs(float(loss64)),
          f"two-pass loss {float(loss2p)} vs {float(loss64)}")
    check(all(bool(torch.isfinite(g).all()) for g in grads2p.values()),
          "two-pass: non-finite gradient")
    print(f"  two_pass_mse_step spp {SPP_TRAIN}: {dt2p * 1e3:.1f} ms/step, peak "
          f"{peak2p / 2**30:.2f} GiB [{card}]", flush=True)
    del grads2p

    # one spp-1 step of the plain versions on the card, by name
    def plain_step():
        leaves = {key: v.detach().requires_grad_(True) for key, v in params.items()}
        pk, cm = sh.apply_params(leaves, pkt, cam)
        oo, dd = cam_ops.get_rays(cm, px, py, jit.T)
        with torch.no_grad():
            _, sel_ = mk.trace_record_reference(oo, dd, mk.pack_scene(pk), k, B,
                                                GRAD_SEED, 0)
        ur = mk.trace_uniforms(oo, B, GRAD_SEED, 0)
        color = path_replay.replay(oo, dd, sel_, ur, pk, cfg)
        loss = torch.mean((color - target) ** 2)
        return torch.autograd.grad(loss, list(leaves.values()))

    plain_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_step()
    torch.cuda.synchronize()
    dt_plain = time.perf_counter() - t0
    print(f"  plain PyTorch spp-1 step on the card: {dt_plain * 1e3:.1f} ms, "
          f"{R * B / dt_plain / 1e6:.2f} Mrays/s [{card}]", flush=True)

    # the two-pass schedule equals the monolithic step (smaller shape)
    Ws, Hs, spp_s = 320, 180, 8
    cfg_s = RenderConfig(width=Ws, height=Hs, max_depth=B)
    cam_s = cam_ops.Camera.create(width=Ws, height=Hs)
    par_s = sh.differentiable_params(pkt, cam_s)
    tgt_s = torch.from_numpy(rs.uniform(0.0, 0.5, (Ws * Hs, 3)).astype(np.float32)).to(dev)
    l1, g1 = train.mse_step(par_s, pkt, cam_s, tgt_s, cfg_s, 7, spp=spp_s)
    l2, g2 = train.two_pass_mse_step(par_s, pkt, cam_s, tgt_s, cfg_s, 7, spp=spp_s,
                                     samples_per_call=3)
    torch.cuda.synchronize()
    worst = 0.0
    for key in g1:
        a, b = g2[key], g1[key]
        excess = float(((a - b).abs() - TWO_PASS_RTOL * b.abs()).max())
        worst = max(worst, excess / max(float(b.abs().max()), 1e-30))
        check(bool(torch.allclose(a, b, rtol=TWO_PASS_RTOL,
                                  atol=TWO_PASS_ATOL * float(b.abs().max()))),
              f"two_pass d{key} differs from mse_step: {float((a - b).abs().max())}")
    check(abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1)), f"two_pass loss {l1} {l2}")
    print(f"  two_pass_mse_step == mse_step at {Ws}x{Hs}, spp {spp_s} (chunks of 3): "
          f"loss {float(l1):.6f} vs {float(l2):.6f}, worst excess over rtol "
          f"{worst:.2e} of the leaf's largest", flush=True)

    # past the kernels' depth cap (MAX_DEPTH bounces of saved state): the
    # staged route, through the sweep kernel, on any device
    cfg9 = dataclasses.replace(cfg, max_depth=mk.MAX_DEPTH + 1)
    check(integrator.grad_route(cfg9, pkt) == "staged", "max_depth 9 is not routed staged")
    sk.launches = mk.record_launches = fg.launches = 0
    t0 = time.perf_counter()
    loss9, grads9 = train.mse_step(params, pkt, cam, target, cfg9, 400, spp=1)
    torch.cuda.synchronize()
    dt9 = time.perf_counter() - t0
    launches9 = (sk.launches, mk.record_launches, fg.launches)
    check(launches9 == (cfg9.max_depth, 0, 0), f"max_depth 9 mse_step: sweep, record, backward "
          f"launches {launches9}, expected ({cfg9.max_depth}, 0, 0)")
    check(math.isfinite(float(loss9)) and all(bool(torch.isfinite(g).all())
                                              for g in grads9.values()),
          "max_depth 9 mse_step: non-finite loss or gradient")
    print(f"  mse_step max_depth {cfg9.max_depth} spp 1 (staged route): {dt9 * 1e3:.1f} ms "
          f"(host clock, first call), loss {float(loss9):.6f}, sweep launches {launches9[0]}, "
          f"record and backward launches 0 [{card}]", flush=True)
    del grads9

    # record: rays in (o, d), colour and B int32 selections out; backward:
    # rays, selections and d(colour) in, d(o) and d(d) out, a chain and its
    # adjoint per recorded hit (the small table and d(table) not counted)
    return [with_bound({
        "name": "trace_record",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/record_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/megakernel.py:734",
        "launches": launches[0],
        "max_abs_err": rec_err,
        "ms": rec_ms,
        "plain_ms": rec_plain_ms,
        "first_design_ms": rec_times["first design"],
        "active_lane_share": rec_share,
    }, R * (24 + 12 + 4 * B), dense_ops(counts, pkt, "record")), with_bound({
        "name": "fused_bwd",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/fused_grad_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/fused_grad.py:112",
        "launches": launches[1],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }, R * (24 + 4 * B + 12 + 24), bwd_op)]


# Wavefront kernels vs plain versions (phases 9-10). The slab test has no
# a*b+c: verdicts equal. The bounce kernel culls each ray by its own box
# test inside the block's shortlist; its plain version does not (every live
# ray of a block sweeps every leaf the block lists, as the TPU kernel does),
# so a cull that dropped a winning row would show as a flipped ray. The
# bounce kernel contracts FMAs: next-state values
# TIGHT_FRAC within TIGHT, a ray whose values differ beyond WAVE_FLIP (another
# primitive or path) on at most FLIP_FRAC of the rays, dead rays bit for bit.
WAVE_FLIP = 1e-2
WAVE_SEED = 0x7EA
TRI_CONFIGS = (  # (name, (scene function, kwargs), W, H): bench.py --tri-scene / --mixed-scene
    ("config 3", ("config3_scene", dict(segments=128, rings=64)), 512, 512),
    ("config 4", ("config4_mixed_scene", dict(segments=128, rings=64)), 1920, 1080),
)


def mask_states(dev, config, seed=WAVE_SEED, sample=1, pkt=None):
    """One Philox sample of ``config`` (a `TRI_CONFIGS` entry; ``pkt``, when
    given, in place of its scene) traced as `wavefront.trace` traces it, by
    the shipped kernels: (pkt, cam, scene, consts, o, d, bounce-0
    shortlists, [(bounce, state, ids)]) with the sorted state and ids that
    the mask gets at every live bounce after the first."""
    from ptre_tpu_torch.utils.config import RenderConfig
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.render import pathtracer as pt

    name, (fn, kw), W, H = config
    R, B = W * H, 5
    k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=B))
    if pkt is None:
        pkt = getattr(demo, fn)(**kw).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    scene = wf.prepare_scene(pkt, screen_cam=cam)
    px, py = pt.pixel_grid(H, W, dev)
    u = rng.ray_uniforms(seed, sample, R, 1, dev)
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, (u - 0.5).T))
    state, ids, short0 = wf.primary_state(o, d, scene, (H, W))
    states = []
    for b in range(B):
        if b > 0:
            n_live = int((state[9] > 0.5).sum())
            if n_live == 0:
                break
            if n_live >= max(int(wf.SORT_MIN_LIVE * state.shape[1]), 1):
                perm = wf.coherence_order(state, scene)
                state, ids = state[:, perm].contiguous(), ids[perm].contiguous()
            states.append((b, state, ids))
            short, cnt = wf.wave_mask_lists(state, scene.boxes, k.t_min,
                                            supers=scene.mask_supers)
        else:
            short, cnt = short0
        state = wf.wave_bounce(state, ids, short, cnt, scene, k, b, seed, sample)
    return pkt, cam, scene, k, o, d, short0, states


#: leaves up to which the mask kernel stages the boxes in shared memory and
#: forms the supertiles' boxes itself (csrc/mask_kernel.cu kMaxMaskLeaves);
#: past it the global instantiation reads the scene's supertile table
MASK_STAGED_LEAVES = 1024


def mask_work(state, scene, mask, stats):
    """(bytes, operations) of one mask call: o, d and active read, the
    verdicts written, the leaf boxes (and past MASK_STAGED_LEAVES the
    supertile boxes) read once; the slab tests the counting instantiation
    made (supertiles and leaves, each for every live ray of the warp that
    made it), OPS_SLAB each."""
    nbytes = state.shape[1] * 28 + mask.numel() + scene.boxes.numel() * 4
    if scene.n_leaf > MASK_STAGED_LEAVES:
        nbytes += scene.mask_supers.numel() * 4
    return nbytes, (stats["supertile_tests"] + stats["leaf_tests"]) * OPS_SLAB


def lists_equal(got, want):
    """Whether two (shortlists, counts) pairs have the same counts and the
    same entries in each row's [0, count), on ``want``'s device: the mask
    kernel writes nothing past a row's count."""
    import torch

    short, cnt = (x.to(want[0].device) for x in got)
    w_short, w_cnt = want
    if not torch.equal(cnt, w_cnt):
        return False
    on = torch.arange(short.shape[1], device=short.device)[None, :] < cnt[:, None].long()
    return torch.equal(short[on], w_short[on])


def hold_lists(what, state, scene, k, mask, card, reps=10):
    """The mask kernel writing the shortlists (`wave_mask_lists`) against
    the dense mask ``mask`` compacted by the standalone kernel and by
    `torch.sort` (`shortlists_reference`: the path before the kernel wrote
    the lists), list for list; then in turns the kernel writing lists, the
    kernel writing the dense mask, and the dense mask with the sort. Returns
    {label: ms}."""
    from ptre_tpu_torch.ops.cuda import wavefront as wf

    def lists():
        return wf.wave_mask_lists(state, scene.boxes, k.t_min, supers=scene.mask_supers)

    def dense():
        return wf.wave_mask(state, scene.boxes, k.t_min, supers=scene.mask_supers)

    want = wf.shortlists_reference(mask)
    check(lists_equal(lists(), want) and lists_equal(wf.shortlists_from_mask(mask), want),
          f"{what}: the shortlists differ from the sorted compaction's")
    turns = in_turns({"mask writing lists": lists, "mask writing bytes": dense,
                      "bytes + sort": lambda: wf.shortlists_reference(dense())}, reps)
    print(f"  {what}: shortlists equal to the sorted compaction's ({float(want[1].float().mean()):.1f}"
          f" leaves a block on average); in turns: " + ", ".join(
              f"{label} {ms:.4f} ms" for label, ms in turns.items())
          + f"; the sort path {turns['bytes + sort'] - turns['mask writing bytes']:.4f} ms past "
          f"its kernel [{card}]", flush=True)
    return turns


def wavefront_phases(dev, card, rs, first_mask, static_mask, lane_bounce):
    """Phases 9-11: the wavefront's mask and bounce kernels against their
    plain versions (the mask also against its first design, ``first_mask``,
    and the unit shipped before it took more than 1,024 leaves,
    ``static_mask``, at every live bounce of a sample; the bounce kernel at
    every bounce of that sample against the unit shipped before the warp
    sweep, ``lane_bounce``), then the triangle-scale render path. Returns
    the two kernels' entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from ptre_tpu_torch.utils.config import RenderConfig
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import render_kernel as rk
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.ops.integrator import postprocess_sample
    from ptre_tpu_torch.render import pathtracer as pt

    B = 5
    setups, times, lane_times = {}, {}, {}
    mask_err, bounce_err = 0.0, 0.0
    # the three units timed alike: through their C interfaces
    shipped_mask = lean_wave_mask(build.load_library(), wf, mk, shipped=True)
    for config in TRI_CONFIGS:
        name, _, W, H = config
        R = W * H
        t0 = time.perf_counter()
        pkt, cam, scene, k, o, d, short0, states = mask_states(dev, config)
        torch.cuda.synchronize()
        cfg = RenderConfig(width=W, height=H, max_depth=B)
        check(pt.route(pkt) == "wavefront", f"{name}: route {pt.route(pkt)}")
        check(short0 is not None, f"{name}: bounce 0 not screen-binned")
        _, state1, ids1 = states[0]
        print(f"phase 9: mask kernel vs plain and vs its first design, {name} "
              f"({pkt.num_triangles} triangles, {scene.n_leaf} leaves) at {W}x{H}, every live "
              f"bounce after the first of one sample ({len(states)}; traced in "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
        for b, state, _ in states:
            want = wf.wave_mask_reference(state, scene.boxes, k.t_min)
            got = wf.wave_mask(state, scene.boxes, k.t_min, supers=scene.mask_supers)
            first = first_mask(state, scene.boxes, k.t_min)
            parent = static_mask(state, scene.boxes, k.t_min)
            counts = torch.zeros(len(wf.MASK_STATS), dtype=torch.int64, device=dev)
            counted = wf.wave_mask(state, scene.boxes, k.t_min, stats=counts,
                                   supers=scene.mask_supers)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            mask_err = max(mask_err, float((got.float() - want.float()).abs().max()))
            check(n_diff == 0, f"{name} bounce {b}: {n_diff} mask verdicts differ from the "
                  "plain version")
            check(torch.equal(got, first) and torch.equal(got, parent)
                  and torch.equal(counted, got),
                  f"{name} bounce {b}: verdicts differ from the first design's, the parent "
                  "unit's or the counting instantiation's")
            counts = dict(zip(wf.MASK_STATS, counts.tolist()))
            n_live = int((state[9] > 0.5).sum())
            check(counts["live_rays"] == n_live, f"{name} bounce {b}: live rays {counts}")
            turns = in_turns({"shipped": lambda: shipped_mask(state, scene.boxes, k.t_min),
                              "parent's unit": lambda: static_mask(state, scene.boxes,
                                                                   k.t_min),
                              "first design": lambda: first_mask(state, scene.boxes,
                                                                 k.t_min)}, 20)
            nbytes, ops = mask_work(state, scene, got, counts)
            b_ms, b_by = bound(nbytes, ops)
            a_ms, a_by = bound(nbytes, n_live * scene.n_leaf * OPS_SLAB)
            parent_ms = turns["parent's unit"]
            print(f"  bounce {b}: {n_live} live rays of {state.shape[1]}; verdicts equal to the "
                  f"plain version's, the parent unit's and the first design's; "
                  f"{100 * float(got.float().mean()):.3f}"
                  f" % of (block, leaf) pairs pass; {counts['supertile_tests']} supertile and "
                  f"{counts['leaf_tests']} leaf tests (live rays x the tests their warps made) "
                  f"against {n_live * scene.n_leaf} (live ray, leaf) pairs; in turns, through "
                  f"their C interfaces: shipped "
                  f"{turns['shipped']:.4f} ms, parent's unit {parent_ms:.4f} "
                  f"ms, first design {turns['first design']:.4f} ms; "
                  f"bound {b_ms:.4f} ms by {b_by} (every pair: {a_ms:.4f} ms by {a_by}) "
                  f"[{card}]", flush=True)
            if b == 1:
                mask1, mask_ms, mask_work1 = got, turns["shipped"], (nbytes, ops)
                if name == "config 4":
                    hold_lists(f"{name} bounce 1", state, scene, k, got, card)
            del want, first, counted
        share0 = float(short0[1].float().sum()) / (short0[1].numel() * scene.n_leaf)
        print(f"  screen binning at bounce 0 lists {100 * share0:.3f} % of (block, leaf) "
              "pairs", flush=True)
        print(f"phase 10: bounce kernel vs the unit shipped before the warp sweep, {name} at "
              f"{W}x{H}, every bounce of the sample, same states and shortlists", flush=True)
        state0, ids0, _ = wf.primary_state(o, d, scene, (H, W))
        bounces = [(0, state0, ids0, *short0)] + [
            (b, state, ids, *wf.wave_mask_lists(state, scene.boxes, k.t_min,
                                                supers=scene.mask_supers))
            for b, state, ids in states]
        urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)).to(dev)
        lane_times[name] = hold_wave_lane(name, scene, k, bounces, lane_bounce, urand, card)
        del bounces, state0, urand
        mask_plain_ms = cuda_events(
            lambda: wf.wave_mask_reference(state1, scene.boxes, k.t_min), 1)
        got = mask1
        del states

        print(f"phase 10: bounce kernel vs plain, {name} at {W}x{H}, same state and "
              "shortlists", flush=True)
        short, cnt = wf.shortlists_from_mask(got)
        urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)).to(dev)
        dead = state1[9] < 0.5
        pairs = {}
        for mode, ur in (("philox", None), ("external uniforms", urand)):
            bk = wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1, WAVE_SEED, 1, ur)
            bp = wf.wave_bounce_reference(state1, ids1, short, cnt, scene, k, 1, WAVE_SEED,
                                          1, ur, stats=pairs)
            torch.cuda.synchronize()
            err = (bk - bp).abs()
            tight = float((err <= TIGHT).float().mean())
            flip = (err > WAVE_FLIP).any(dim=0)
            allowed = math.ceil(FLIP_FRAC * R)
            e = float(err[:, ~flip].max())
            bounce_err = max(bounce_err, e)
            print(f"  {mode}: max_abs_err {float(err.max()):.3e} ({e:.3e} outside flipped "
                  f"rays), {100 * tight:.4f}% within {TIGHT:g}, {int(flip.sum())} rays "
                  f"flipped (allowed {allowed}), {int((bk[9] > 0.5).sum())} live after",
                  flush=True)
            check(bool(torch.isfinite(bk).all()), f"{name} {mode}: non-finite state")
            check(tight >= TIGHT_FRAC, f"{name} {mode}: only {tight:.6f} within {TIGHT}")
            check(int(flip.sum()) <= allowed, f"{name} {mode}: {int(flip.sum())} flipped")
            check(torch.equal(bk[:, dead], state1[:, dead]), f"{name} {mode}: dead rays changed")
        hold_bounce_counts(f"{name} bounce 1", scene, k, 1, state1, ids1, short, cnt, pairs)
        bounce_ms = cuda_events(lambda: wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1,
                                                       WAVE_SEED, 1), 10)
        bounce_plain_ms = cuda_events(lambda: wf.wave_bounce_reference(
            state1, ids1, short, cnt, scene, k, 1, WAVE_SEED, 1), 1)
        print(f"  mask kernel {mask_ms:.4f} ms, plain {mask_plain_ms:.3f} ms; bounce kernel "
              f"{bounce_ms:.4f} ms, plain {bounce_plain_ms:.3f} ms (CUDA events, bounce 1, "
              f"{name} {W}x{H}) [{card}]", flush=True)
        # this state's work: live rays x leaves for the mask; for the bounce
        # a slab test per (live ray, listed leaf) pair and 64 row tests per
        # pair whose box the ray itself passes, then the spheres and the
        # shading per live ray
        live = state1[9] > 0.5
        n_live = int(live.sum())
        r_pad = state1.shape[1]
        print(f"  bounce 1's (live ray, leaf) pairs: {pairs['listed_tests']} listed by the "
              f"blocks' shortlists, {pairs['own_pairs']} of them "
              f"({100 * pairs['own_pairs'] / max(pairs['listed_tests'], 1):.2f} %) whose box "
              f"the ray itself passes, {n_live * scene.n_leaf} without culling", flush=True)
        work = {
            "mask": mask_work1,
            "bounce": (r_pad * (80 + 4) + short.numel() * 4 + cnt.numel() * 4,
                       pairs["listed_tests"] * OPS_SLAB
                       + pairs["own_pairs"] * wf.LEAF * OPS_TRI_TEST
                       + n_live * (int(pkt.num_spheres) * OPS_SPH_TEST + OPS_SHADE)),
        }
        times[name] = (mask_ms, mask_plain_ms, bounce_ms, bounce_plain_ms, work)

        # the whole trace, kernels vs plain versions, same Philox draws
        t0 = time.perf_counter()
        ck = wf.trace(o, d, scene, k, B, WAVE_SEED, 1, tile_hint=(H, W))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cp = wf.trace(o, d, scene, k, B, WAVE_SEED, 1, tile_hint=(H, W), plain=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"  whole trace: kernels {1e3 * (t1 - t0):.2f} ms, plain {1e3 * (t2 - t1):.1f} ms "
              f"(host clock) [{card}]", flush=True)
        img_k = postprocess_sample(ck, True).reshape(H, W, 3)
        img_p = postprocess_sample(cp, True).reshape(H, W, 3)
        compare(img_k, img_p, pt, f"{name} {W}x{H} trace, one sample")
        setups[name] = (pkt, cam, cfg)
        del state1, bk, bp, got, mask1, urand, ck, cp

    # ---- 11. the triangle-scale main path ------------------------------------------------
    launches = [0, 0]
    for name, _, W, H in TRI_CONFIGS:
        pkt, cam, cfg = setups[name]
        print(f"phase 11: triangle main path, {name} at {W}x{H}, spp {SPP}, 1 + {STEPS} "
              "steps", flush=True)
        gen = torch.Generator().manual_seed(cfg.seed)
        wf.mask_launches = wf.bounce_launches = wf.live_bounces = wf.binned_bounces = 0
        rk.launches = 0
        acc = pt.render_step(pkt, cam, pt.AccumState.create(H, W, dev), gen, cfg, spp=SPP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            acc = pt.render_step(pkt, cam, acc, gen, cfg, spp=SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (wf.mask_launches, wf.bounce_launches, wf.live_bounces, wf.binned_bounces,
                  rk.launches)
        samples = SPP * (STEPS + 1)
        print(f"  launches: mask {counts[0]}, bounce {counts[1]}; live bounces {counts[2]} "
              f"of {samples * B}, bounce 0 binned {counts[3]} times; render kernel "
              f"{counts[4]}", flush=True)
        check(counts[4] == 0, f"{name}: the dense render kernel ran")
        check(counts[3] == samples, f"{name}: bounce 0 binned {counts[3]} times")
        check(counts[1] == counts[2] and samples < counts[2] <= samples * B,
              f"{name}: {counts[1]} bounce launches for {counts[2]} live bounces")
        check(counts[0] == counts[2] - counts[3],
              f"{name}: {counts[0]} mask launches for {counts[2] - counts[3]} culled bounces")
        launches[0] += counts[0]
        launches[1] += counts[1]
        lin = acc.linear
        check(acc.frame == samples, f"{name}: frame {acc.frame}")
        check(bool(torch.isfinite(lin).all()), f"{name}: non-finite image")
        check(float(lin.min()) >= 0.0 and float(lin.max()) <= 1.0 + 1e-6,
              f"{name}: image outside [0, 1]")
        # a pixel whose primary ray missed averages sky-gradient values: blue 1,
        # (1 - r) / 0.5 == (1 - g) / 0.3; geometry breaks that
        sky_like = ((lin[..., 2] - 1.0).abs() < 1e-5) & (
            ((1.0 - lin[..., 0]) / 0.5 - (1.0 - lin[..., 1]) / 0.3).abs() < 1e-4)
        geo = 1.0 - float(sky_like.float().mean())
        check(geo > 0.05, f"{name}: {100 * geo:.2f} % of the pixels are not sky")
        ms_sample = dt * 1e3 / (STEPS * SPP)
        mrays = W * H * SPP * STEPS * B / dt / 1e6
        print(f"  render_step: {ms_sample:.3f} ms/sample, {mrays:.2f} Mrays/s "
              f"(W*H*spp*steps*max_depth/s, host clock); {100 * geo:.1f} % of the pixels "
              f"show geometry [{card}]", flush=True)

        # where a sample's time goes, by stage (CUDA events around each)
        timer = wf.StageTimer()
        n_live0 = wf.live_bounces
        pt.sample_image(wf.prepare_scene(pkt, screen_cam=cam), cam, cfg, 12345, 1,
                        timer=timer)
        split = timer.totals()
        bounces = wf.live_bounces - n_live0
        total = sum(ms for ms, _ in split.values())
        print(f"  one sample, {bounces} live bounces, {total:.3f} ms of stages: " + ", ".join(
            f"{stage} {ms:.3f} ms / {n} ({ms / n:.4f} ms each)"
            for stage, (ms, n) in sorted(split.items())) + f" [{card}]", flush=True)
        print("  per bounce: " + ", ".join(
            f"{stage} {ms / bounces:.3f} ms" for stage, (ms, _) in sorted(split.items()))
            + f" [{card}]", flush=True)

    # one plain sample at config 3 (host clock), against the kernels' sample
    pkt, cam, cfg = setups["config 3"]
    scene = wf.prepare_scene(pkt, screen_cam=cam)
    px, py = pt.pixel_grid(cam.height, cam.width, dev)
    u = rng.ray_uniforms(7, 1, cam.height * cam.width, 1, dev)
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, (u - 0.5).T))
    k = mk.TraceConsts.from_config(cfg)
    secs = {}
    for plain in (False, True):  # both warm from phase 10
        t0 = time.perf_counter()
        wf.trace(o, d, scene, k, B, 7, 1, tile_hint=(cam.height, cam.width), plain=plain)
        torch.cuda.synchronize()
        secs[plain] = time.perf_counter() - t0
    dt, dt_plain = secs[False], secs[True]
    print(f"  config 3 {cam.width}x{cam.height}, one sample's trace: kernels {1e3 * dt:.3f} ms, plain "
          f"{1e3 * dt_plain:.1f} ms (host clock) [{card}]", flush=True)

    mask_ms, mask_plain_ms, bounce_ms, bounce_plain_ms, work = times["config 4"]
    return [with_bound({
        "name": "wave_mask",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/mask_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/wavefront.py:102",
        "launches": launches[0],
        "max_abs_err": mask_err,
        "ms": mask_ms,
        "plain_ms": mask_plain_ms,
    }, *work["mask"]), with_bound({
        "name": "wave_bounce",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/wave_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/wavefront.py:209",
        "launches": launches[1],
        "max_abs_err": bounce_err,
        "ms": bounce_ms,
        "plain_ms": bounce_plain_ms,
        "parent_unit_ms": lane_times["config 4"][1]["parent's unit"],
    }, *work["bounce"])]


# Triangle-scale training (phases 15-18). The culled megakernel against its
# first design (block votes, csrc/baseline/raster_mega/): colours and
# selections EQUAL, both built with the same flags (the per-warp cull is
# conservative, so every ray's winners are the same). Against its
# plain version: as the record kernel (phase 6), per ray over the whole
# trace: >= TIGHT_FRAC of the rays' colours within TIGHT (relative above 1),
# a flipped ray (colour beyond 5 %, or another selection at some bounce) on at
# most FLIP_FRAC of the rays, selections equal outside them. Culling on,
# culling off and the wavefront run the same device functions on
# conservative candidate sets: a ray may differ only where rounding puts a
# hit on the edge of a box, on at most FLIP_FRAC of the rays. The recording
# bounce kernel's state must equal the non-recording one's bit for bit.
TRAIN_SEED = 0x7EA1
COUNT_REL = 1e-3  # the culled megakernel's counters against the plain version's
SPP_TWO_PASS = 64  # bench.py --mixed-scene's 64-spp two-pass step
OPS_MISS = 10  # a miss: the sky gradient


def triangle_training_phases(dev, card, rs, fma_bwd, first_bwd, first_culled, dense_bwd_ms):
    """Phases 15-18: the culled megakernel, the wavefront's record mode and
    the global-table backward against their plain versions on BASELINE
    configs 4 and 3 (the megakernel and the backward also against their
    first designs, ``first_culled`` and ``first_bwd``, bit for bit and in
    turns), then the triangle-scale training path. Returns the four kernels'
    entries of the ``kernels`` line (the culled megakernel's two
    instantiations)."""
    import numpy as np
    import torch

    from ptre_tpu_torch.utils.config import RenderConfig
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import path_replay, rng
    from ptre_tpu_torch.ops.cuda import fused_grad as fg
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import train

    B = 5
    setups, mega, rec = {}, {}, {}
    mega_err = 0.0
    for name, (fn, kw), W, H in reversed(TRI_CONFIGS):  # config 4 first
        R = W * H
        cfg = RenderConfig(width=W, height=H, max_depth=B)
        k = mk.TraceConsts.from_config(cfg)
        pkt = getattr(demo, fn)(**kw).build_packet(device=dev)
        cam = cam_ops.Camera.create(width=W, height=H)
        scene = wf.prepare_scene(pkt, screen_cam=cam)
        px, py = pt.pixel_grid(H, W, dev)
        u = rng.ray_uniforms(TRAIN_SEED, 0, R, 1, dev)
        o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, (u - 0.5).T))
        urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)).to(dev)
        n_rows = scene.tri_rows + scene.n_sph

        # ---- 15. the culled megakernel vs its plain version ---------------------------
        print(f"phase 15: culled megakernel vs plain, {name} ({pkt.num_triangles} triangles, "
              f"{scene.n_leaf} leaves, {scene.super_boxes.shape[0]} supertiles) at {W}x{H}, "
              f"max_depth {B}", flush=True)
        allowed = math.ceil(FLIP_FRAC * R)
        stats, kept = {}, {}
        for mode, ur in (("external uniforms", urand), ("philox", None)):
            color, sel = mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0, ur, record=True)
            want_c, want_s = mk.trace_culled_reference(
                o, d, scene, k, B, TRAIN_SEED, 0, ur, record=True,
                stats=stats if ur is None else None)
            torch.cuda.synchronize()
            diff = (color - want_c).abs()
            scale = want_c.abs().clamp_min(1.0)
            tight = float((diff <= TIGHT * scale).all(dim=1).float().mean())
            other = (sel != want_s).any(dim=0)
            flip = (diff > 0.05 * scale).any(dim=1) | other
            mega_err = max(mega_err, float(diff[~flip].max()))
            print(f"  {mode}: colour max_abs_err {float(diff.max()):.3e} "
                  f"({float(diff[~flip].max()):.3e} outside flipped rays), {100 * tight:.4f}% "
                  f"of the rays within {TIGHT:g} (relative above 1); {int(other.sum())} rays "
                  f"with other selections, {int(flip.sum())} flipped rays (allowed "
                  f"{allowed}); {int((sel >= 0).sum())} hits recorded", flush=True)
            check(bool(torch.isfinite(color).all()), f"culled {name} {mode}: non-finite")
            check(tight >= TIGHT_FRAC, f"culled {name} {mode}: only {tight:.6f} within {TIGHT}")
            check(int(flip.sum()) <= allowed, f"culled {name} {mode}: {int(flip.sum())} flipped")
            check(bool(((sel >= -1) & (sel < n_rows)).all()), f"culled {name} {mode}: bad rows")
            check(torch.equal(mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0, ur), color),
                  f"culled {name} {mode}: recording changed the colour")
            # the first design (block votes) on the same rays and draws: equal
            fc, fs = first_culled(o, d, scene, k, B, TRAIN_SEED, 0, ur, record=True)
            fc_n = first_culled(o, d, scene, k, B, TRAIN_SEED, 0, ur)
            torch.cuda.synchronize()
            n_first = int(((fc != color).any(dim=1) | (fs != sel).any(dim=0)).sum())
            print(f"  {mode}: {n_first} rays whose colour or selections differ from the first "
                  f"design's (recording); not recording, colour equal: "
                  f"{torch.equal(fc_n, color)}", flush=True)
            check(n_first == 0, f"culled {name} {mode}: {n_first} rays differ from the first "
                  "design's")
            check(torch.equal(fc_n, color), f"culled {name} {mode}: the non-recording colour "
                  "differs from the first design's")
            del fc, fs, fc_n
            kept[mode] = (color, sel, ur)
            del want_c, want_s, diff
        # culling on vs off vs the wavefront's kernels, same rays and draws
        for mode, (color, sel, ur) in kept.items():
            bc, bs = mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0, ur, cull=False,
                                     record=True)
            wc, ws, _ = wf.trace(o, d, scene, k, B, TRAIN_SEED, 0, ur, tile_hint=(H, W),
                                 record=True)
            torch.cuda.synchronize()
            n_brute = int(((bc != color).any(dim=1) | (bs != sel).any(dim=0)).sum())
            n_wave = int(((wc != color).any(dim=1) | (ws != sel).any(dim=0)).sum())
            print(f"  {mode}: rays whose colour or selections differ from cull on: cull off "
                  f"{n_brute}, wavefront {n_wave} of {R} (allowed {allowed} each)", flush=True)
            check(n_brute <= allowed, f"{name} {mode}: cull off differs on {n_brute} rays")
            check(n_wave <= allowed, f"{name} {mode}: the wavefront differs on {n_wave} rays")
            if ur is None:
                rec[name] = (wc, ws)
            del bc, bs
        # the counting instantiation: the same colour; the warps' visits
        # against the pairs the rays pass themselves and the blocks' votes
        c_stats = torch.zeros(len(mk.CULLED_STATS), dtype=torch.int64, device=dev)
        counted = mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0, stats=c_stats)
        c_stats = dict(zip(mk.CULLED_STATS, c_stats.tolist()))
        check(torch.equal(counted, kept["philox"][0]),
              f"culled {name}: the counting instantiation's colour differs")
        # the unit contracts a*b+c in the row tests, so a closest hit may sit
        # an ulp from the plain version's and a box test bounded by it go the
        # other way: live ray-bounces and pairs passed within COUNT_REL of the
        # plain version's; the warps visit at least the pairs passed and at
        # most what the first design's blocks swept (nearly, by COUNT_REL)
        near = lambda a, b: abs(a - b) <= COUNT_REL * b  # noqa: E731
        check(near(c_stats["ray_bounces"], stats["ray_bounces"])
              and near(c_stats["own_pairs"], stats["own_pairs"])
              and c_stats["own_pairs"] <= c_stats["warp_slots"]
              <= (1 + COUNT_REL) * stats["swept_pairs"],
              f"culled {name}: counters {c_stats} against the plain version's {stats}")
        print(f"  philox sample, the kernel's counters: {c_stats['ray_bounces']} live "
              f"ray-bounces, {c_stats['super_tests']} supertile and {c_stats['leaf_tests']} leaf "
              f"box tests; (ray, leaf) pairs {c_stats['own_pairs']} passed by the ray itself, "
              f"{c_stats['warp_slots']} (live lane, leaf) slots of the warps' visits "
              f"({c_stats['warp_slots'] / max(c_stats['own_pairs'], 1):.2f}x), the first "
              f"design's blocks {stats['swept_pairs']} "
              f"({stats['swept_pairs'] / max(c_stats['own_pairs'], 1):.2f}x)", flush=True)
        del counted
        turns = in_turns({
            "shipped": lambda: mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0, record=True),
            "first design": lambda: first_culled(o, d, scene, k, B, TRAIN_SEED, 0, record=True),
        }, 5)
        turns_n = in_turns({
            "shipped": lambda: mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0),
            "first design": lambda: first_culled(o, d, scene, k, B, TRAIN_SEED, 0)}, 5)
        m_rec_ms, m_ms = turns["shipped"], turns_n["shipped"]
        print(f"  in turns (CUDA events, {name} {W}x{H}): recording {m_rec_ms:.4f} ms, the first "
              f"design {turns['first design']:.4f} ms; not recording {m_ms:.4f} ms, the first "
              f"design {turns_n['first design']:.4f} ms [{card}]", flush=True)
        m_brute_ms = cuda_events(lambda: mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0,
                                                         cull=False), 1)
        m_plain_ms = cuda_events(lambda: mk.trace_culled_reference(o, d, scene, k, B,
                                                                   TRAIN_SEED, 0), 1)
        t0 = time.perf_counter()
        wf.trace(o, d, scene, k, B, TRAIN_SEED, 0, tile_hint=(H, W))
        torch.cuda.synchronize()
        wave_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mk.trace_culled(o, d, scene, k, B, TRAIN_SEED, 0)
        torch.cuda.synchronize()
        mega_host_ms = (time.perf_counter() - t0) * 1e3
        sel_p = kept["philox"][1]
        hits = int((sel_p >= 0).sum())
        print(f"  philox sample: {stats['ray_bounces']} live ray-bounces "
              f"({stats['ray_bounces'] / R:.3f} a ray), {hits} hits; (ray, leaf) pairs: "
              f"{stats['own_pairs']} whose box the ray itself passes, {stats['swept_pairs']} "
              f"swept after the blocks' votes, {stats['ray_bounces'] * scene.n_leaf} without "
              "culling", flush=True)
        print(f"  culled megakernel {m_ms:.4f} ms ({m_rec_ms:.4f} ms recording, {m_brute_ms:.3f} "
              f"ms with culling off), plain {m_plain_ms:.1f} ms (CUDA events); one sample as "
              f"a forward, host clock: culled megakernel {mega_host_ms:.3f} ms, wavefront "
              f"trace {wave_ms:.3f} ms ({name} {W}x{H}) [{card}]", flush=True)
        # rays in, colour and B selections out; every live ray-bounce tests the
        # supertile boxes, the leaf boxes of the supertiles it needs (counted
        # as its own leaf pairs' supertiles, at least one box a pair), 64 rows
        # per own pair, the spheres, and shades or takes the sky
        mega[name] = (m_rec_ms, m_ms, m_plain_ms, R * (24 + 12 + 4 * B), (
            c_stats["ray_bounces"] * (scene.super_boxes.shape[0] * OPS_SLAB
                                      + scene.n_sph * OPS_SPH_TEST + OPS_MISS)
            + c_stats["own_pairs"] * (OPS_SLAB + wf.LEAF * OPS_TRI_TEST) + hits * OPS_SHADE),
            turns["first design"], turns_n["first design"])
        setups[name] = (pkt, cam, cfg, scene, k, o, d)
        del kept, urand

    # ---- 16. the wavefront's record mode ---------------------------------------------------
    rec_err = 0.0
    for name, _, W, H in reversed(TRI_CONFIGS):
        pkt, cam, cfg, scene, k, o, d = setups[name]
        R = W * H
        print(f"phase 16: the wavefront's record mode, {name} at {W}x{H}", flush=True)
        wc, ws = rec[name]
        plain_c = wf.trace(o, d, scene, k, B, TRAIN_SEED, 0, tile_hint=(H, W))
        pc, ps, _ = wf.trace(o, d, scene, k, B, TRAIN_SEED, 0, tile_hint=(H, W), plain=True,
                             record=True)
        torch.cuda.synchronize()
        check(torch.equal(wc, plain_c), f"{name}: trace(record=True) changed the colour")
        other = (ws != ps).any(dim=0)
        flip = ((wc - pc).abs() > 0.05 * pc.abs().clamp_min(1.0)).any(dim=1) | other
        allowed = math.ceil(FLIP_FRAC * R)
        print(f"  colour bit-equal to record=False; against the plain versions: "
              f"{int(other.sum())} rays with other selections, {int(flip.sum())} flipped "
              f"(allowed {allowed}); {int((ws >= 0).sum())} hits recorded, "
              f"{int((ws[B - 1] >= 0).sum())} at the last bounce", flush=True)
        check(int(flip.sum()) <= allowed, f"{name}: record mode flipped {int(flip.sum())} rays")
        check(bool(((ws >= -1) & (ws < scene.tri_rows + scene.n_sph)).all()),
              f"{name}: bad selection rows")
        del pc, ps, plain_c
        if name != "config 4":
            continue
        # the recording bounce kernel beside the non-recording one: bounce 1
        state0, ids0, short0 = wf.primary_state(o, d, scene, (H, W))
        state1 = wf.wave_bounce(state0, ids0, *short0, scene, k, 0, TRAIN_SEED, 0)
        perm = wf.coherence_order(state1, scene)
        state1, ids1 = state1[:, perm].contiguous(), ids0[perm].contiguous()
        short, cnt = wf.wave_mask_lists(state1, scene.boxes, k.t_min)
        sel_k = torch.full((B, R), -1, dtype=torch.int32, device=dev)
        sel_r = sel_k.clone()
        got = wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1, TRAIN_SEED, 0, sel=sel_k)
        same = wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1, TRAIN_SEED, 0)
        pairs = {}
        want = wf.wave_bounce_reference(state1, ids1, short, cnt, scene, k, 1, TRAIN_SEED, 0,
                                        sel=sel_r, stats=pairs)
        torch.cuda.synchronize()
        check(torch.equal(got, same), "the recording bounce kernel's state differs")
        err = (got - want).abs()
        flip = (err > WAVE_FLIP).any(dim=0)
        flip_ids = ids1[flip].long()
        ok = sel_k == sel_r
        ok[:, flip_ids] = True
        rec_err = float(err[:, ~flip].max())
        print(f"  bounce 1, recording kernel: state bit-equal to the non-recording kernel's; "
              f"against plain max_abs_err {rec_err:.3e} outside {int(flip.sum())} flipped rays; "
              f"{int((~ok).any(dim=0).sum())} rays with another winner outside them; "
              f"{int((sel_k[1] >= 0).sum())} winners written", flush=True)
        check(int(flip.sum()) <= allowed and int((~ok).any(dim=0).sum()) <= allowed,
              "the recording bounce kernel disagrees with its plain version")
        check(bool((sel_k[[0, 2, 3, 4]] == -1).all()), "recording wrote another bounce's row")
        b_ms = cuda_events(lambda: wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1,
                                                  TRAIN_SEED, 0), 10)
        b_rec_ms = cuda_events(lambda: wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1,
                                                      TRAIN_SEED, 0, sel=sel_k), 10)
        b_ms2 = cuda_events(lambda: wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1,
                                                   TRAIN_SEED, 0), 10)
        b_plain_ms = cuda_events(lambda: wf.wave_bounce_reference(
            state1, ids1, short, cnt, scene, k, 1, TRAIN_SEED, 0, sel=sel_r), 1)
        print(f"  bounce kernel {b_ms:.4f} / {b_ms2:.4f} ms, recording {b_rec_ms:.4f} ms, plain "
              f"recording {b_plain_ms:.3f} ms (CUDA events, bounce 1, {name} {W}x{H}) "
              f"[{card}]", flush=True)
        live = state1[9] > 0.5
        n_live = int(live.sum())
        r_pad = state1.shape[1]
        print(f"  bounce 1's (live ray, leaf) pairs: {pairs['listed_tests']} listed, "
              f"{pairs['own_pairs']} whose box the ray itself passes", flush=True)
        rec_work = (r_pad * (80 + 4) + short.numel() * 4 + cnt.numel() * 4 + n_live * 4,
                    pairs["listed_tests"] * OPS_SLAB + pairs["own_pairs"] * wf.LEAF * OPS_TRI_TEST
                    + n_live * (int(pkt.num_spheres) * OPS_SPH_TEST + OPS_SHADE))
        rec_times = (b_rec_ms, b_plain_ms)
        del state0, state1, got, same, want, sel_k, sel_r, err

    # ---- 17. the global-table backward vs its plain version ------------------------------------
    pkt, cam, cfg, scene, k, o, d = setups["config 4"]
    W, H = cfg.width, cfg.height
    R = W * H
    print(f"phase 17: global-table backward vs plain, config 4 at {W}x{H}, the wavefront's "
          "recorded selections", flush=True)
    sel = rec["config 4"][1]
    table, T, sky6 = path_replay.build_table(pkt)
    table = torch.cat([table[:T][scene.perm_tri], table[T:]]).contiguous()
    check(table.shape[0] > fg.MAX_ROWS, "config 4's table fits the staged instantiation")
    dcol = torch.from_numpy(rs.standard_normal((R, 3), dtype=np.float32)).to(dev)
    groups = {"v0-v2": slice(0, 9), "n0-n2": slice(9, 18), "center": slice(18, 21),
              "radius": slice(21, 22), "albedo": slice(23, 26), "param": slice(26, 27)}
    fg.launches = 0
    gbwd_err = hold_backward(fg, mk, "global bwd philox", table, sky6, o, d, sel, dcol, k, B, T,
                             TRAIN_SEED, None, groups, read={"with FMA": (fma_bwd, False)})
    check(fg.launches == 2, f"the backward kernel was launched {fg.launches} times")
    run_a = fg.fused_bwd(table, sky6, o, d, sel, dcol, k, B, T, TRAIN_SEED, 0)
    run_b = fg.fused_bwd(table, sky6, o, d, sel, dcol, k, B, T, TRAIN_SEED, 0)
    torch.cuda.synchronize()
    rr_tab = float((run_a[0] - run_b[0]).norm() / run_a[0].norm())
    rr_sky = float((run_a[1] - run_b[1]).norm() / run_a[1].norm())
    check(torch.equal(run_a[2], run_b[2]) and torch.equal(run_a[3], run_b[3]),
          "d(o), d(d) differ between two runs")
    hits = int((sel >= 0).sum())
    rows_hit = int(torch.unique(sel[sel >= 0]).numel())
    sph_share = float((sel >= T).sum()) / max(hits, 1)
    print(f"  two runs of the kernel: d(table) relative L2 {rr_tab:.3e}, d(sky) {rr_sky:.3e} "
          f"apart (atomics in no fixed order); d(o), d(d) bit-equal; {hits} hits on "
          f"{rows_hit} of {table.shape[0]} rows, {100 * sph_share:.1f} % of them on the "
          f"{scene.n_sph} sphere rows", flush=True)
    g_turns = hold_first_design("global bwd philox", fg.fused_bwd, first_bwd,
                                (table, sky6, o, d, sel, dcol, k, B, T, TRAIN_SEED, 0), 10,
                                {"with FMA": fma_bwd}, card)
    g_ms = g_turns["shipped"]
    ur_x = torch.rand((2 + 2 * B, R), device=dev,
                      generator=torch.Generator(dev).manual_seed(TRAIN_SEED))
    sel_x = wf.trace(o, d, scene, k, B, TRAIN_SEED, 0, ur_x, tile_hint=(H, W), record=True)[1]
    hold_first_design("global bwd external uniforms", fg.fused_bwd, first_bwd,
                      (table, sky6, o, d, sel_x, dcol, k, B, T, TRAIN_SEED, 0, ur_x), 0, {},
                      card)
    del ur_x, sel_x
    g_plain_ms = cuda_events(lambda: fg.fused_bwd_reference(table, sky6, o, d, sel, dcol, k, B,
                                                            T, TRAIN_SEED, 0), 1)
    print(f"  global-table backward {g_ms:.4f} ms (with FMA contraction "
          f"{g_turns['with FMA']:.4f} ms, the first design {g_turns['first design']:.4f} ms, "
          f"in turns), plain {g_plain_ms:.1f} ms; the staged (dense) instantiation on the "
          f"demo scene in this run (phase 7) {dense_bwd_ms:.4f} ms (CUDA events, {W}x{H}) "
          f"[{card}]", flush=True)
    # rays, selections and d(colour) in, d(o), d(d) out, the table read and
    # d(table) written once (the per-hit row reads and atomics stay in L2),
    # each bounce's chain, recompute and adjoint by its kind
    g_ops, g_ops_old, g_kinds = bwd_ops(sel, table, T)
    print(f"  backward's bounces by kind {g_kinds}: {g_ops / 1e9:.3f} GFLOP counted from "
          f"replay.cuh (the old count, {OPS_BWD_BOUNCE_OLD} a hit, {g_ops_old / 1e9:.3f})",
          flush=True)
    gbwd_work = (R * (24 + 4 * B + 12 + 24) + 2 * table.numel() * 4, g_ops)
    hold_deepest("global bwd philox", fg, first_bwd, lambda b: wf.trace(
        o, d, scene, k, b, TRAIN_SEED, 0, tile_hint=(H, W), record=True)[1],
        (table, sky6, o, d), dcol, k, T, TRAIN_SEED, card)
    del run_a, run_b, dcol, table, rec

    # ---- 18. the triangle-scale training path ---------------------------------------------------
    def counters():
        return (wf.mask_launches, wf.bounce_launches, wf.live_bounces, wf.binned_bounces,
                fg.launches, mk.record_launches, mk.culled_launches)

    def reset():
        wf.mask_launches = wf.bounce_launches = wf.live_bounces = wf.binned_bounces = 0
        fg.launches = mk.record_launches = mk.culled_launches = 0

    def check_counts(what, samples, backwards, binned=True):
        masks, bounces, live, bins, bwd, recs, culled = counters()
        print(f"  {what}: launches: mask {masks}, bounce {bounces} (live bounces {live} of "
              f"{samples * B}, bounce 0 binned {bins} times), backward {bwd}; dense record "
              f"kernel {recs}, culled megakernel {culled}", flush=True)
        check(bounces == live and samples < live <= samples * B,
              f"{what}: {bounces} bounce launches for {live} live bounces")
        check(bins == (samples if binned else 0) and masks == live - bins,
              f"{what}: {masks} mask launches, {bins} binned bounces")
        check(bwd == backwards and recs == 0 and culled == 0,
              f"{what}: backward {bwd}, record {recs}, culled {culled}")
        return masks, bounces, bwd

    path_launches = [0, 0, 0, 0]  # mask, bounce, backward, culled
    for name, _, W, H in reversed(TRI_CONFIGS):
        pkt, cam, cfg, scene, k, o, d = setups[name]
        R = W * H
        print(f"phase 18: triangle training path, {name} at {W}x{H}: mse_step spp 1 (1 + "
              f"{STEPS} steps)", flush=True)
        params = sh.differentiable_params(pkt, cam)
        target = torch.zeros((R, 3), device=dev)

        def step(seed, spp=1):
            loss, grads = train.mse_step(params, pkt, cam, target, cfg, seed, spp=spp)
            torch.cuda.synchronize()
            check(math.isfinite(float(loss)), f"{name} mse_step: loss {float(loss)}")
            for key, g in grads.items():
                check(bool(torch.isfinite(g).all()), f"{name} mse_step: non-finite d{key}")
            return loss, grads

        reset()  # every count to 0 just before the main path
        step(100)
        t0 = time.perf_counter()
        for i in range(STEPS):
            loss, grads = step(101 + i)
        dt = (time.perf_counter() - t0) / STEPS
        got = check_counts(f"{name} spp 1", STEPS + 1, STEPS + 1)
        for i in range(3):
            path_launches[i] += got[i]
        if name == "config 4":  # config 3's triangles are emissive: no geometry gradient
            check(float(grads["transforms"].abs().max()) > 0, "config 4: d(transforms) is zero")
        check(float(grads["mat_albedo"].abs().max()) > 0
              and float(grads["cam_position"].abs().max()) > 0, f"{name}: zero gradients")
        torch.cuda.reset_peak_memory_stats()
        step(200)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {name} spp 1: {dt * 1e3:.3f} ms/step, {R * B / dt / 1e6:.2f} Mrays/s fwd+bwd "
              f"(W*H*max_depth/s, host clock), loss {float(loss):.6f}, |d(transforms)| max "
              f"{float(grads['transforms'].abs().max()):.3e}, peak {peak / 2**20:.1f} MiB "
              f"[{card}]", flush=True)
        device_share(lambda: train.mse_step(params, pkt, cam, target, cfg, 300), 2,
                     f"{name} mse_step spp 1", card)
        reset()
        if name != "config 4":
            continue

        # the reference's bench_py_mixed shape: 64-spp two-pass, constant memory
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss2, grads2 = train.two_pass_mse_step(params, pkt, cam, target, cfg, 400,
                                                spp=SPP_TWO_PASS)
        torch.cuda.synchronize()
        dt2 = time.perf_counter() - t0
        peak2 = torch.cuda.max_memory_allocated()
        got = check_counts(f"two_pass_mse_step spp {SPP_TWO_PASS}", 2 * SPP_TWO_PASS,
                           SPP_TWO_PASS)
        for i in range(3):
            path_launches[i] += got[i]
        check(math.isfinite(float(loss2)) and all(
            bool(torch.isfinite(g).all()) for g in grads2.values()), "two-pass: non-finite")
        print(f"  two_pass_mse_step spp {SPP_TWO_PASS}: {dt2 * 1e3:.1f} ms/step, "
              f"{R * SPP_TWO_PASS * B / dt2 / 1e6:.2f} Mrays/s (W*H*spp*max_depth/s), loss "
              f"{float(loss2):.6f}, peak {peak2 / 2**30:.2f} GiB [{card}]", flush=True)
        del grads2
        reset()

        # one step through the culled megakernel (force="culled"), by hand:
        # the A/B partner of the production forward
        def culled_step(force):
            leaves = {key: v.detach().requires_grad_(True) for key, v in params.items()}
            pk, cm = sh.apply_params(leaves, pkt, cam)
            jit = rng.ray_uniforms(500, 0, R, 1, dev)
            oo, dd = cam_ops.get_rays(cm, *pt.pixel_grid(H, W, dev), (jit - 0.5).T)
            color = fg.trace_grad(oo, dd, pk, cfg, 500, 0, force=force, screen_cam=cm)
            loss = torch.mean((color - target) ** 2)
            out = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            torch.cuda.synchronize()
            return loss.detach(), dict(zip(leaves, out))

        culled_step("culled")  # warm
        reset()
        t0 = time.perf_counter()
        loss_c, grads_c = culled_step("culled")
        dt_c = time.perf_counter() - t0
        check(counters() == (0, 0, 0, 0, 1, 0, 1), f"culled step: counts {counters()}")
        path_launches[2] += 1
        path_launches[3] += 1
        reset()
        t0 = time.perf_counter()
        loss_w, grads_w = culled_step("wavefront")
        dt_w = time.perf_counter() - t0
        worst = max(float((grads_c[key] - grads_w[key]).abs().max()
                          / grads_w[key].abs().max().clamp_min(1e-30))
                    for key in grads_w if grads_w[key] is not None)
        print(f"  one step with force='culled': {dt_c * 1e3:.3f} ms, with force='wavefront' "
              f"{dt_w * 1e3:.3f} ms (host clock); loss {float(loss_c):.6f} vs "
              f"{float(loss_w):.6f}; largest gradient difference {worst:.2e} of the leaf's "
              f"largest [{card}]", flush=True)
        check(abs(float(loss_c) - float(loss_w)) <= 1e-5 * abs(float(loss_w)),
              "culled and wavefront steps disagree on the loss")
        check(worst <= 1e-3, f"culled and wavefront gradients differ by {worst}")
        reset()

    # the two-pass schedule equals the monolithic step on a triangle packet
    Ws, Hs, spp_s = 320, 180, 4
    cfg_s = RenderConfig(width=Ws, height=Hs, max_depth=B)
    cam_s = cam_ops.Camera.create(width=Ws, height=Hs)
    pkt_s = demo.config4_mixed_scene(32, 16).build_packet(device=dev)
    par_s = sh.differentiable_params(pkt_s, cam_s)
    tgt_s = torch.from_numpy(rs.uniform(0.0, 0.5, (Ws * Hs, 3)).astype(np.float32)).to(dev)
    l1, g1 = train.mse_step(par_s, pkt_s, cam_s, tgt_s, cfg_s, 7, spp=spp_s)
    l2, g2 = train.two_pass_mse_step(par_s, pkt_s, cam_s, tgt_s, cfg_s, 7, spp=spp_s,
                                     samples_per_call=3)
    torch.cuda.synchronize()
    worst = 0.0
    for key in g1:
        a, b = g2[key], g1[key]
        excess = float(((a - b).abs() - TWO_PASS_RTOL * b.abs()).max())
        worst = max(worst, excess / max(float(b.abs().max()), 1e-30))
        check(bool(torch.allclose(a, b, rtol=TWO_PASS_RTOL,
                                  atol=TWO_PASS_ATOL * float(b.abs().max()))),
              f"two_pass d{key} differs from mse_step: {float((a - b).abs().max())}")
    check(abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1)), f"two_pass loss {l1} {l2}")
    print(f"  two_pass_mse_step == mse_step on a {pkt_s.num_triangles}-triangle packet at "
          f"{Ws}x{Hs}, spp {spp_s} (chunks of 3): loss {float(l1):.6f} vs {float(l2):.6f}, "
          f"worst excess over rtol {worst:.2e} of the leaf's largest", flush=True)
    print(f"  main path launches: mask {path_launches[0]}, bounce (recording) "
          f"{path_launches[1]}, global-table backward {path_launches[2]}, culled megakernel "
          f"{path_launches[3]}", flush=True)
    check(all(n > 0 for n in path_launches), f"a kernel never ran: {path_launches}")

    m_ms, m_norec_ms, m_plain_ms, m_bytes, m_ops, m_first_ms, m_first_norec_ms = mega["config 4"]
    return [with_bound({
        "name": "trace_culled",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/mega_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/megakernel.py:237",
        "launches": path_launches[3],
        "max_abs_err": mega_err,
        "ms": m_ms,
        "plain_ms": m_plain_ms,
        "first_design_ms": m_first_ms,
    }, m_bytes, m_ops), with_bound({
        # the instantiation that records no selection (mega_kernel<false>):
        # bit-equal colour; no route launches it (the forced training step
        # records), so 0 launches on the main path
        "name": "trace_culled_norecord",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/mega_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/megakernel.py:237",
        "launches": 0,
        "max_abs_err": mega_err,
        "ms": m_norec_ms,
        "plain_ms": m_plain_ms,
        "first_design_ms": m_first_norec_ms,
    }, m_bytes - R * 4 * B, m_ops), with_bound({
        "name": "wave_bounce_record",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/wave_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/wavefront.py:209",
        "launches": path_launches[1],
        "max_abs_err": rec_err,
        "ms": rec_times[0],
        "plain_ms": rec_times[1],
    }, *rec_work), with_bound({
        "name": "fused_bwd_global",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/fused_grad_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/fused_grad.py:112",
        "launches": path_launches[2],
        "max_abs_err": gbwd_err,
        "ms": g_ms,
        "plain_ms": g_plain_ms,
    }, *gbwd_work)]


# The staged route (phases 19-20). The sweep kernel is built without FMA
# contraction (build.UNIT_FLAGS) and its selections are integers: they must
# EQUAL the plain sweep's on every ray compared. The plain sweep is the brute
# force, O(R * T) in memory, so it runs over chunks of at most PLAIN_PAIRS
# (ray, row) pairs (512 MB a float32 temporary); on config 4 and the
# 65,024-row mesh it is compared on SWEEP_SUBSET of the live rays (every
# ray's selection is independent of the others), on all rays of the main
# path's primary set, which also times it. The kernel culls per ray over
# boxes, so its bound counts what these rays need (OPS_SLAB a box test the
# walk must make: every supertile, the leaves of the supertiles the ray
# passes; 64 row tests a leaf the ray passes; the spheres), from the
# kernel's own counters; the brute force's count is printed beside it.
# Staged against fused gradients (demo scene, 1920x1080, spp 1, the same
# Philox draws): both are float32 evaluations of the same estimator in other
# operation orders (geometry gradients of a float32 evaluation sit 8e-4 to
# 9.5e-4 relative L2 from float64). The staged gathers sum d(table) in
# float64, the fused backward by float32 atomics; with embedding's float32
# sums the material gradients sat 2.6e-4 to 2.8e-4 apart, with float64 sums
# below 1e-6, the geometry and camera gradients 2.4e-4 to 3.7e-4 (NVIDIA
# H100 80GB HBM3, 700.00 W). Hence every gradient group within STAGED_REL
# relative L2, about five times the largest reading.
OPS_SWEEP_TRI = 46    # wave.cuh row_accepts as written
OPS_SWEEP_SPH = 20    # sweep.cuh test_sphere as written
PLAIN_PAIRS = 2 ** 27
SWEEP_SUBSET = 262144
STAGED_SCENE = ("config3_scene", dict(flat=False, segments=256, rings=128, diffuse=True))
STAGED_STEPS = 2
STAGED_REL = 2e-3


def start_unit_build(unit, tag, flags=(), src_dir=None):
    """Start nvcc on one unit of ``src_dir`` (None: the shipped sources) with
    NVCC_FLAGS and ``flags`` in place of the unit's UNIT_FLAGS (so with FMA
    contraction unless ``flags`` say otherwise), against the headers of
    ``src_dir``, into a library of its own: (process, library path). A
    variant that is not shipped, built while other phases run."""
    from ptre_tpu_torch.ops.cuda import build

    out_dir = os.path.join(build.BUILD_DIR, f"{tag}.{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"lib{unit.replace('.cu', '')}_{tag}.so")
    proc = subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-shared", "-I", src_dir or build.CSRC_DIR,
         "-o", path, os.path.join(src_dir or build.CSRC_DIR, unit)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, path


def start_baseline_build(unit, subdir=""):
    """`start_unit_build` of the yardstick copy of ``unit`` (the kernel's
    first design, ``csrc/baseline/`` or its ``subdir``, against the frozen
    headers there) with the shipped unit's flags."""
    from ptre_tpu_torch.ops.cuda import build

    return start_unit_build(unit, "baseline", build.UNIT_FLAGS.get(unit, ()),
                            os.path.join(build.CSRC_DIR, "baseline", subdir))


def finish_unit_build(unit_build, report=None):
    """Wait for `start_unit_build`'s nvcc and load its library; with
    ``report`` (a list) append its `ptxas_summary`."""
    import ctypes

    proc, path = unit_build
    out, err = proc.communicate()
    check(proc.returncode == 0, f"nvcc (build of {path}) failed:\n{out}\n{err}")
    if report is not None:
        report.extend(ptxas_summary(err))
    return ctypes.CDLL(path)


def lib_fused_bwd(lib, fg):
    """`fused_bwd` launching another build of the shipped fused backward
    unit (`start_unit_build`: with FMA contraction, or a timing variant)
    from ``lib``, both instantiations; it counts nothing."""
    import ctypes

    shipped = fg.build.load_library()
    for name in ("ptre_fused_bwd_blocks", "ptre_fused_bwd", "ptre_fused_bwd_global"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = getattr(shipped, name).argtypes

    def fn(*args):
        load, count = fg.build.load_library, fg.launches
        fg.build.load_library = lambda: lib
        try:
            return fg.fused_bwd(*args)
        finally:
            fg.build.load_library, fg.launches = load, count

    return fn



def baseline_fused_bwd(lib, fg, mk):
    """The fused backward's first design (``csrc/baseline/
    fused_grad_kernel.cu``, built by `start_baseline_build`) through its own C
    interface — (P, 27) table and d(table), the grid sized without the
    depth — as a function of `fused_bwd`'s arguments; it counts nothing."""
    import ctypes

    import torch

    ptr = ctypes.c_void_p
    lib.ptre_fused_bwd_blocks.restype = ctypes.c_int
    lib.ptre_fused_bwd_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ptre_fused_bwd.restype = ctypes.c_int
    lib.ptre_fused_bwd.argtypes = [ptr] * 12 + [ctypes.c_int, ptr]
    lib.ptre_fused_bwd_global.restype = ctypes.c_int
    lib.ptre_fused_bwd_global.argtypes = [ptr] * 13 + [ctypes.c_int, ctypes.c_int, ptr]

    def fn(table, sky6, o, d, sel, dcol, consts, max_depth, sph_offset, seed=0, sample=0,
           urand=None):
        R, P = o.shape[0], table.shape[0]
        staged = P <= fg.MAX_ROWS
        params = mk.trace_params(R, consts, max_depth, seed, sample, urand is not None,
                                 sph_offset=sph_offset, n_rows=P)
        d_o, d_d = torch.empty_like(o), torch.empty_like(d)
        n_blocks = lib.ptre_fused_bwd_blocks(R, int(not staged))
        check(n_blocks >= 1, "baseline fused backward: no grid")
        dsky_part = torch.empty((n_blocks, 8), dtype=torch.float32, device=o.device)
        stream = torch.cuda.current_stream(o.device).cuda_stream
        common = (ctypes.addressof(params), table.data_ptr(), sky6.data_ptr(), o.data_ptr(),
                  d.data_ptr(), sel.data_ptr(), None if urand is None else urand.data_ptr(),
                  dcol.data_ptr(), d_o.data_ptr(), d_d.data_ptr())
        if staged:
            part = torch.empty((n_blocks, P, 27), dtype=torch.float32, device=o.device)
            rc = lib.ptre_fused_bwd(*common, part.data_ptr(), dsky_part.data_ptr(), n_blocks,
                                    stream)
            dtable = part.sum(dim=0)
        else:
            n_sph = P - sph_offset
            n_acc = n_sph if n_sph <= fg.MAX_SPH_ACC else 0
            dtable = torch.zeros((P, 27), dtype=torch.float32, device=o.device)
            part = torch.empty((n_blocks, n_acc, 27), dtype=torch.float32, device=o.device)
            rc = lib.ptre_fused_bwd_global(*common, dtable.data_ptr(), part.data_ptr(),
                                           dsky_part.data_ptr(), n_blocks, n_acc, stream)
            if n_acc:
                dtable[sph_offset:sph_offset + n_acc] += part.sum(dim=0)
        check(rc == 0, f"baseline fused backward launch failed ({rc})")
        return dtable, dsky_part[:, :6].sum(dim=0), d_o, d_d

    return fn


def baseline_wave_mask(lib, wf, mk):
    """The mask kernel's first design (``csrc/baseline/mask_kernel.cu``)
    through its own C interface, as a function of `wave_mask`'s arguments;
    it counts nothing."""
    import ctypes

    import torch

    ptr = ctypes.c_void_p
    lib.ptre_wave_mask.restype = ctypes.c_int
    lib.ptre_wave_mask.argtypes = [ptr] * 4 + [ctypes.c_int, ptr]

    def fn(state, boxes, t_min, lanes=wf.LANES):
        r_pad, n_leaf = state.shape[1], boxes.shape[0]
        mask = torch.empty((r_pad // lanes, n_leaf), dtype=torch.bool, device=state.device)
        p = wf.MaskParams(t_min=mk.f32(t_min), r_pad=r_pad, n_leaf=n_leaf)
        rc = lib.ptre_wave_mask(ctypes.addressof(p), state.data_ptr(), boxes.data_ptr(),
                                mask.data_ptr(), lanes,
                                torch.cuda.current_stream(state.device).cuda_stream)
        check(rc == 0, f"baseline mask launch failed ({rc})")
        return mask

    return fn


def lean_wave_mask(lib, wf, mk, shipped=False):
    """The mask unit of ``lib`` through its own C interface, as a function of
    `wave_mask`'s (state, boxes, t_min, lanes), with none of the wrapper's
    checks: the unit shipped before it took more than 1,024 leaves
    (``csrc/baseline/mask_static/``), or with ``shipped`` the shipped unit
    (its staged instantiation: no supertile table). It counts nothing."""
    import ctypes

    import torch

    ptr = ctypes.c_void_p
    lib.ptre_wave_mask.restype = ctypes.c_int
    lib.ptre_wave_mask.argtypes = [ptr] * (6 if shipped else 5) + [ctypes.c_int, ptr]

    def fn(state, boxes, t_min, lanes=wf.LANES):
        r_pad, n_leaf = state.shape[1], boxes.shape[0]
        mask = torch.empty((r_pad // lanes, n_leaf), dtype=torch.bool, device=state.device)
        p = wf.MaskParams(t_min=mk.f32(t_min), r_pad=r_pad, n_leaf=n_leaf)
        args = (state.data_ptr(), boxes.data_ptr()) + ((None,) if shipped else ())
        rc = lib.ptre_wave_mask(ctypes.addressof(p), *args, mask.data_ptr(), None, lanes,
                                torch.cuda.current_stream(state.device).cuda_stream)
        check(rc == 0, f"mask unit: launch failed ({rc})")
        return mask

    return fn


def start_wave_lane_build():
    """`start_unit_build` of the bounce unit as shipped before the warp sweep
    (``csrc/baseline/wave_lane/``, each passing ray swept on its own lane
    from rows staged in shared memory), against the shipped headers."""
    from ptre_tpu_torch.ops.cuda import build

    return start_unit_build("wave_kernel.cu", "wave_lane", ("-I", build.CSRC_DIR),
                            os.path.join(build.CSRC_DIR, "baseline", "wave_lane"))


def lib_wave_bounce(lib, wf):
    """`wave_bounce` launching another build of the bounce unit from ``lib``
    (the parent's, `start_wave_lane_build`, or a variant), both
    instantiations, through the shipped C interface; it counts nothing and
    takes no ``stats``."""
    import ctypes

    shipped = wf.build.load_library()
    lib.ptre_wave_bounce.restype = ctypes.c_int
    lib.ptre_wave_bounce.argtypes = shipped.ptre_wave_bounce.argtypes

    def fn(*args, **kw):
        check(kw.get("stats") is None, "another bounce unit counts nothing")
        load, count = wf.build.load_library, wf.bounce_launches
        wf.build.load_library = lambda: lib
        try:
            return wf.wave_bounce(*args, **kw)
        finally:
            wf.build.load_library, wf.bounce_launches = load, count

    return fn


#: relative gap allowed between the counting bounce kernel's ray_bounces and
#: own_pairs and the plain version's: the unit contracts a*b+c in the row
#: tests, so a closest hit may sit an ulp from the plain version's and a box
#: test bounded by it go the other way
COUNT_REL = 1e-3
#: labels of `hold_wave_lane`'s timings
LANE_TURNS = ("shipped", "parent's unit", "shipped recording", "parent's recording")


def hold_wave_lane(what, scene, k, bounces, lane_bounce, urand, card, reps=10):
    """The shipped bounce kernel against the unit shipped before the warp
    sweep (``lane_bounce``, `lib_wave_bounce`) at each bounce of ``bounces``
    ([(bounce, state, ids, short, cnt)], seed WAVE_SEED, sample 1): next
    states and selections bit-equal, with Philox and the external
    ``urand``, recording and not; both instantiations of both timed in
    turns (CUDA events, Philox). Returns {bounce: {label: ms}}."""
    import torch

    from ptre_tpu_torch.ops.cuda import wavefront as wf

    B, R = (urand.shape[0] - 2) // 2, urand.shape[1]
    out = {}
    for b, state, ids, short, cnt in bounces:
        for ur in (None, urand):
            sels = [torch.full((B, R), -1, dtype=torch.int32, device=state.device)
                    for _ in range(2)]
            got = [fn(state, ids, short, cnt, scene, k, b, WAVE_SEED, 1, ur, sel=sel)
                   for fn, sel in ((wf.wave_bounce, sels[0]), (lane_bounce, sels[1]))]
            plain = [fn(state, ids, short, cnt, scene, k, b, WAVE_SEED, 1, ur)
                     for fn in (wf.wave_bounce, lane_bounce)]
            torch.cuda.synchronize()
            check(torch.equal(got[0], got[1]) and torch.equal(sels[0], sels[1])
                  and torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1]),
                  f"{what} bounce {b} ({'external' if ur is not None else 'Philox'}): the "
                  "state or selections differ from the parent unit's")
        sel = torch.full((B, R), -1, dtype=torch.int32, device=state.device)

        def call(fn, rec, state=state, ids=ids, short=short, cnt=cnt, b=b):
            return lambda: fn(state, ids, short, cnt, scene, k, b, WAVE_SEED, 1,
                              sel=sel if rec else None)

        out[b] = in_turns(dict(zip(LANE_TURNS, (
            call(wf.wave_bounce, False), call(lane_bounce, False),
            call(wf.wave_bounce, True), call(lane_bounce, True)))), reps)
        print(f"  {what} bounce {b} ({int((state[9] > 0.5).sum())} live rays, "
              f"{float(cnt.float().mean()):.1f} leaves a block listed): states and selections "
              "bit-equal to the parent unit's (Philox and external, recording and not); in "
              "turns: " + ", ".join(f"{label} {ms:.4f} ms" for label, ms in out[b].items())
              + f" [{card}]", flush=True)
    total = [sum(t[label] for t in out.values()) for label in LANE_TURNS]
    print(f"  {what} bounces {min(out)}-{max(out)} summed: " + ", ".join(
        f"{label} {ms:.4f} ms" for label, ms in zip(LANE_TURNS, total))
        + f"; shipped / parent's unit {total[0] / total[1]:.4f}, recording "
        f"{total[2] / total[3]:.4f} [{card}]", flush=True)
    return out


def hold_bounce_counts(what, scene, k, b, state, ids, short, cnt, pairs):
    """The counting instantiation at bounce ``b``: the same next state as
    the shipped one, and its ``ray_bounces`` and ``own_pairs`` within
    COUNT_REL of the plain version's (``pairs``, `wave_bounce_reference`'s
    ``stats``). Returns its counters."""
    import torch

    from ptre_tpu_torch.ops.cuda import wavefront as wf

    stats = torch.zeros(len(wf.BOUNCE_STATS), dtype=torch.int64, device=state.device)
    counted = wf.wave_bounce(state, ids, short, cnt, scene, k, b, WAVE_SEED, 1, stats=stats)
    check(torch.equal(counted, wf.wave_bounce(state, ids, short, cnt, scene, k, b, WAVE_SEED,
                                              1)),
          f"{what}: the counting instantiation's state differs")
    st = dict(zip(wf.BOUNCE_STATS, stats.tolist()))
    for key in ("ray_bounces", "own_pairs"):
        check(abs(st[key] - pairs[key]) <= COUNT_REL * pairs[key],
              f"{what}: {key} {st[key]} against the plain version's {pairs[key]}")
    print(f"  {what}: counting instantiation {st} (plain version {pairs}); rays a warp visit "
          f"{st['own_pairs'] / max(st['warp_visits'], 1):.2f}, lane occupancy of a per-lane "
          f"sweep {100 * st['own_pairs'] / max(st['lane_slots'], 1):.2f} %", flush=True)
    return st


@functools.lru_cache(maxsize=None)
def _first_render_params_type():
    """The first designs' by-value render arguments (``csrc/baseline/
    trace.cuh`` RenderParams): the 18 camera rows, then the shipped
    kernel's fields (`render_kernel.RenderParams`)."""
    import ctypes

    from ptre_tpu_torch.ops.cuda import render_kernel as rk

    class FirstRenderParams(ctypes.Structure):
        _fields_ = [("cam", ctypes.c_float * 18)] + rk.RenderParams._fields_

    return FirstRenderParams


def first_render_params(params, cam_rows):
    """The first designs' by-value render arguments from the shipped
    arguments ``params`` and ``cam_rows``: host floats, or a tensor read
    here."""
    rows = cam_rows.tolist() if hasattr(cam_rows, "tolist") else list(cam_rows)
    p = _first_render_params_type()()
    p.cam[:] = rows[:18]
    for name, _ in type(params)._fields_:
        setattr(p, name, getattr(params, name))
    return p


def baseline_render(lib, rk):
    """The render kernel's first design (``csrc/baseline/render_kernel.cu``)
    through its own C interface, as a function of `sample_accum`'s
    arguments (``accum`` updated in place); it counts nothing. The first
    design takes the camera by value: ``cam_rows`` are host floats (a
    list), or a tensor read on the host at every call, so a timed caller
    gives it a list made before the timing."""
    import ctypes

    import torch

    lib.ptre_render_sample.restype = ctypes.c_int
    lib.ptre_render_sample.argtypes = [ctypes.c_void_p] * 8

    def fn(accum, scene, cam_rows, n, config, seed=0, urand=None):
        H, W = accum.shape[:2]
        p = first_render_params(rk.render_params(H, W, scene, n, config, seed,
                                                 external_rng=urand is not None), cam_rows)
        rc = lib.ptre_render_sample(
            ctypes.addressof(p), accum.data_ptr(), None if urand is None else urand.data_ptr(),
            scene.tris.data_ptr(), scene.sphs.data_ptr(), scene.mats.data_ptr(),
            scene.sky.data_ptr(), torch.cuda.current_stream(accum.device).cuda_stream)
        check(rc == 0, f"baseline render launch failed ({rc})")
        return accum

    return fn


def baseline_record(lib, mk):
    """The recording kernel's first design (``csrc/baseline/
    record_kernel.cu``) through its own C interface, as a function of
    `trace_fused_sel`'s arguments; it counts nothing."""
    import ctypes

    import torch

    lib.ptre_trace_record.restype = ctypes.c_int
    lib.ptre_trace_record.argtypes = [ctypes.c_void_p] * 11

    def fn(o, d, scene, consts, max_depth, seed=0, sample=0, urand=None):
        R = o.shape[0]
        color = torch.empty((R, 3), dtype=torch.float32, device=o.device)
        sel = torch.empty((max_depth, R), dtype=torch.int32, device=o.device)
        p = mk.trace_params(R, consts, max_depth, seed, sample, urand is not None, scene=scene)
        rc = lib.ptre_trace_record(
            ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
            None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
            scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr(),
            color.data_ptr(), sel.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
        check(rc == 0, f"baseline record launch failed ({rc})")
        return color, sel

    return fn


def baseline_raster_hard(lib, rast):
    """The hard raster kernel's first design (``csrc/baseline/raster_mega/
    raster_kernel.cu``) through its own C interface, as a function of
    `raster_tiles`' arguments; it counts nothing."""
    import ctypes

    import torch

    lib.ptre_raster_hard.restype = ctypes.c_int
    lib.ptre_raster_hard.argtypes = [ctypes.c_void_p] * 5

    def fn(tris, cbox, scal, rows_ss, width_ss, ss):
        out = torch.empty((3, rows_ss, width_ss), dtype=torch.float32, device=tris.device)
        p = rast.raster_params(scal, rows_ss, width_ss, ss, cbox.shape[0])
        stream = torch.cuda.current_stream(tris.device).cuda_stream
        rc = lib.ptre_raster_hard(ctypes.addressof(p), tris.data_ptr(), cbox.data_ptr(),
                                  out.data_ptr(), stream)
        check(rc == 0, f"baseline raster launch failed ({rc})")
        return out

    return fn


def baseline_trace_culled(lib, mk):
    """The culled megakernel's first design (``csrc/baseline/raster_mega/
    mega_kernel.cu``) through its own C interface, as a function of
    `trace_culled`'s arguments; it counts nothing."""
    import ctypes

    import torch

    lib.ptre_trace_culled.restype = ctypes.c_int
    lib.ptre_trace_culled.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p]

    def fn(o, d, scene, consts, max_depth, seed=0, sample=0, urand=None, cull=True,
           record=False, lanes=mk.CULLED_LANES):
        R = o.shape[0]
        color = torch.empty((R, 3), dtype=torch.float32, device=o.device)
        sel = torch.empty((max_depth, R), dtype=torch.int32, device=o.device) if record else None
        p = mk.MegaParams(
            w=mk.wave_params(consts, seed, sample, scene, n_rays=R, n_sel=R,
                             external_rng=int(urand is not None)),
            max_depth=max_depth, n_super=scene.super_boxes.shape[0], cull=int(cull))
        rc = lib.ptre_trace_culled(
            ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
            None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
            scene.rows.data_ptr(), scene.cull_boxes.data_ptr(), scene.super_boxes.data_ptr(),
            scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr(),
            color.data_ptr(), None if sel is None else sel.data_ptr(), lanes,
            torch.cuda.current_stream(o.device).cuda_stream)
        check(rc == 0, f"baseline culled megakernel launch failed ({rc})")
        return (color, sel) if record else color

    return fn


def first_design_warp_bounces(lens):
    """The warp-bounces the first design of the render or recording kernel
    issues for paths of these lengths (``lens``, (H, W) pixels or (R,) rays,
    as the counting instantiation writes them): one thread a path, each
    warp (two rows of a 16x16 block, or 32 consecutive rays) running as
    long as its longest path."""
    import torch.nn.functional as F

    if lens.dim() == 2:
        H, W = lens.shape
        tiles = F.pad(lens, (0, -W % 16, 0, -H % 2)).reshape((H + 1) // 2, 2, -1, 16)
        return int(tiles.amax(dim=(1, 3)).sum())
    return int(F.pad(lens, (0, -lens.shape[0] % 32)).reshape(-1, 32).amax(dim=1).sum())


def warp_slabs(g, sel, max_depth: int) -> dict:
    """What the replay kernels' warps (``csrc/replay_kernel.cu``, 32
    consecutive rays each) do on the gathered rows ``g`` (B, R, 27) and
    selections ``sel`` (B, R): the warp-bounces (``warps`` x
    ``max_depth``), those ``skipped`` past a warp's dead tail (no lane's
    path alive entering the bounce: neither kernel runs it), and the
    backward's d(g) slabs written as zeros without staging (``zero_slabs``,
    the skipped ones included: no lane hit) against those ``staged`` in
    shared memory; and the ``ray_bounces`` the paths enter, the lanes doing
    work in the warp-bounces that are run (each reads its selection). A
    path is alive entering bounce b + 1 if it was entering b, hit (``sel >=
    0``) and its row is not an emitter (kind > 0.5)."""
    import torch

    R = sel.shape[1]
    n_warps = -(-R // 32)

    def by_warp(flags):
        padded = torch.zeros(n_warps * 32, dtype=torch.bool, device=flags.device)
        padded[:R] = flags
        return padded.view(n_warps, 32).any(dim=1)

    alive = torch.ones(R, dtype=torch.bool, device=sel.device)
    entered, hit_any, ray_bounces = [], [], 0
    for b in range(max_depth):
        hit = sel[b] >= 0
        ray_bounces += int(alive.sum())
        entered.append(by_warp(alive))
        hit_any.append(by_warp(hit))
        alive = alive & hit & ~(g[b, :, 22] > 0.5)
    entered, hit_any = torch.stack(entered), torch.stack(hit_any)
    staged = int((entered & hit_any).sum())
    return {"warps": n_warps, "warp_bounces": n_warps * max_depth,
            "skipped": int((~entered).sum()), "zero_slabs": n_warps * max_depth - staged,
            "staged": staged, "ray_bounces": ray_bounces}


def lane_share(stats, issued_first, what, card):
    """Print the active-lane shares of a dense kernel's counts
    (`megakernel.DENSE_STATS`), live ray-bounces over 32 x the warp-bounces
    issued, by this design and by the first design for the same paths
    (``issued_first``, `first_design_warp_bounces`); return this design's."""
    started, live, hits, issued, tested = (int(x) for x in stats)
    share, share_first = live / (32 * issued), live / (32 * issued_first)
    print(f"  {what}: {started} paths, {live} live ray-bounces, {hits} hits, {tested} "
          f"triangle rows tested; warp-bounces {issued} (active lanes {100 * share:.2f} %), "
          f"first design {issued_first} ({100 * share_first:.2f} %) [{card}]", flush=True)
    return share


def dense_ops(stats, pkt, what):
    """Float32 operations a dense kernel's sample needs on this run's data,
    from its counts (`megakernel.DENSE_STATS`): per live ray-bounce the
    group boxes' slab tests and every sphere, a Moller-Trumbore test per
    triangle row tested, a shading per hit. Prints it beside the count of a
    sweep over every row."""
    _, live, hits, _, tested = (int(x) for x in stats)
    n_tri, n_sph = int(pkt.num_triangles), int(pkt.num_spheres)
    groups = -(-n_tri // 8)  # trace.cuh kGroupRows
    ops = live * (groups * OPS_SLAB + n_sph * OPS_SPH_TEST) + tested * OPS_TRI_TEST \
        + hits * OPS_SHADE
    every_row = live * (n_tri * OPS_TRI_TEST + n_sph * OPS_SPH_TEST) + hits * OPS_SHADE
    print(f"  {what}: {ops / 1e9:.3f} GFLOP counted on the rows tested ({tested} of "
          f"{live * n_tri} (live ray-bounce, row) pairs), {every_row / 1e9:.3f} on every row",
          flush=True)
    return ops


def in_turns(fns, reps):
    """{label: ms per call} of each function of ``fns`` ({label: function})
    by CUDA events, timed in turns a, b, b, a: each label's mean of two;
    {} for ``reps`` 0."""
    if reps == 0:
        return {}
    order = list(fns) + list(reversed(fns))
    times = {}
    for label in order:
        times.setdefault(label, []).append(cuda_events(fns[label], reps))
    return {label: sum(v) / len(v) for label, v in times.items()}


def variant_sweep(lib, sk, k):
    """The sweep of a separately built sweep unit (`start_unit_build`), as a
    function of (o, d, scene, active); it counts nothing."""
    import ctypes

    import torch

    lib.ptre_sweep.restype = ctypes.c_int
    lib.ptre_sweep.argtypes = [ctypes.c_void_p] * 11

    def fn(o, d, scene, active=None):
        out = torch.empty((4, o.shape[0]), dtype=torch.int32, device=o.device)
        p = sk.sweep_params(scene, o.shape[0], k.t_min, k.t_max, k.det_eps)
        rc = lib.ptre_sweep(ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
                            None if active is None else active.data_ptr(),
                            scene.rows.data_ptr(), scene.cull_boxes.data_ptr(),
                            scene.super_boxes.data_ptr(), scene.sphs.data_ptr(),
                            out.data_ptr(), None, torch.cuda.current_stream(o.device).cuda_stream)
        check(rc == 0, f"variant sweep launch failed ({rc})")
        return out[0], out[1].bool(), out[2], out[3].bool()

    return fn


def staged_phases(dev, card, rs, report):
    """Phases 19-20: the sweep kernel against the plain sweep on three
    scenes at 1920x1080 (on the 65,024-row mesh the primary rays and every
    bounce of one staged sample), beside its unit built with FMA
    contraction (not shipped); then the staged
    main path (render_step and mse_step on that mesh, the staged route
    forced: the mesh's default route is phase 24's) and the staged route's
    gradients against the fused route's.
    ``report``: the build's ptxas report. Returns the sweep's entry of the
    ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from ptre_tpu_torch.utils.config import RenderConfig
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import integrator, intersect, materials, rng
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import train

    W, H, B = W_MAIN, H_MAIN, 5
    R = W * H
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    k = mk.TraceConsts.from_config(cfg)
    cam = cam_ops.Camera.create(width=W, height=H)
    px, py = pt.pixel_grid(H, W, dev)

    # the shipped design with FMA contraction compiles while the plain sweeps run
    fma_build = start_unit_build("sweep_kernel.cu", "fma")
    regs = [x for x in ptxas_summary(report) if x.startswith("sweep_kernel")] if report else []
    print(f"phase 19: sweep kernel vs plain sweep at {W}x{H}; "
          f"{'; '.join(regs) or 'library built earlier: registers not reported'} [{card}]",
          flush=True)

    def plain(o, d, scene):
        T = max(scene.tri_rows, 1)
        step = max(1, PLAIN_PAIRS // T)
        parts = [sk.sweep_packed_reference(o[i:i + step], d[i:i + step], scene, k.t_min,
                                           k.t_max, k.det_eps)
                 for i in range(0, o.shape[0], step)]
        return tuple(torch.cat(x) for x in zip(*parts))

    def bounce1(o, d, pkt, scene):
        """The rays that hit and scatter at bounce 0 (kernel sweep, Philox
        draws), leaving their surfaces: t_min self-hits are exercised."""
        def fn(oo, dd, *args):
            return sk.sweep_packed(oo.contiguous(), dd.contiguous(), scene, k.t_min, k.t_max,
                                   k.det_eps)
        with torch.no_grad():
            hit = intersect.closest_hit(o, d, pkt, pkt.world_triangles(), k.t_min, k.t_max,
                                        k.det_eps, sweep_fn=fn)
            u = rng.ray_uniforms(19, 1, o.shape[0], 2, dev)
            sc = materials.scatter(u[2], u[3], d, hit.position, hit.normal,
                                   pkt.mat_kind.long()[hit.mat_id], pkt.mat_albedo[hit.mat_id],
                                   pkt.mat_param[hit.mat_id], k.shadow_eps, k.pdf_eps)
            live = hit.hit & ~sc.terminated
        return sc.next_origin[live].contiguous(), sc.next_dir[live].contiguous(), None

    def staged_sample(pkt, o, d):
        """(o, d, active) of every bounce of one staged sample of the main
        path (`integrator.trace_staged`, Philox draws), as its sweep sees
        them."""
        seen, make = [], integrator._sweep_fn

        def spy(scene, consts, active):
            fn = make(scene, consts, active)

            def run(oo, dd, *args):
                seen.append((oo.contiguous().clone(), dd.contiguous().clone(), active.clone()))
                return fn(oo, dd, *args)
            return run

        integrator._sweep_fn = spy
        try:
            with torch.no_grad():
                integrator.trace_staged(o, d, pkt, cfg, seed=19, sample=1)
        finally:
            integrator._sweep_fn = make
        return seen

    def hold(name, what, o, d, scene, active, t_valid, s_valid, compare_all=False):
        """The kernel against the plain sweep on the live rays compared
        (all with ``compare_all``, else at most SWEEP_SUBSET), its time, this
        run's counts and bounds; returns its numbers."""
        stats = torch.zeros(len(sk.STATS), dtype=torch.int64, device=dev)
        got = sk.sweep_packed(o, d, scene, k.t_min, k.t_max, k.det_eps, active, stats)
        live = (torch.arange(o.shape[0], device=dev) if active is None
                else active.nonzero().squeeze(1))
        idx = live
        if not compare_all and live.numel() > SWEEP_SUBSET:
            pick = torch.randperm(live.numel(), device=dev,
                                  generator=torch.Generator(dev).manual_seed(5))
            idx = live[pick[:SWEEP_SUBSET]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(o[idx], d[idx], scene)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = sum(int((g[idx].long() != w.long()).sum()) for g, w in zip(got, want))
        dead_ok = active is None or all(not bool(g[~active].any()) for g in got)
        hits = (int(got[1].sum()), int(got[3].sum()))
        ms = cuda_events(lambda: sk.sweep_packed(o, d, scene, k.t_min, k.t_max, k.det_eps,
                                                 active), 3 if t_valid > 1000 else 20)
        c = dict(zip(sk.STATS, stats.tolist()))
        n_live, n_super = c["live_rays"], scene.super_boxes.shape[0]
        ops = ((n_live * n_super + mk.SUPER * c["supers_passed"]) * OPS_SLAB
               + c["pairs_passed"] * mk.LEAF * OPS_SWEEP_TRI + n_live * s_valid * OPS_SWEEP_SPH)
        brute_ops = n_live * (t_valid * OPS_SWEEP_TRI + s_valid * OPS_SWEEP_SPH)
        nbytes = (o.shape[0] * (24 + 16 + (active is not None))
                  + (scene.rows.numel() + scene.cull_boxes.numel() + scene.super_boxes.numel()
                     + scene.sphs.numel()) * 4)
        b_ms, b_by = bound(nbytes, ops)
        brute_ms, _ = bound(nbytes, brute_ops)
        print(f"  {name}, {what}: {n_live} live rays of {o.shape[0]}, {idx.numel()} compared, "
              f"{diff} selections differ; triangle hits {hits[0]}, sphere hits {hits[1]}; "
              f"(ray, leaf) pairs: {c['pairs_passed']} whose box the ray itself passes, "
              f"{c['pairs_swept']} swept by the warps, {n_live * scene.n_leaf} without culling; "
              f"{c['box_tests']} box tests; kernel {ms:.4f} ms (CUDA events), plain "
              f"{plain_ms:.1f} ms on the compared rays; bound {b_ms:.4f} ms by {b_by} "
              f"({ops / 1e9:.2f} GFLOP), brute force's {brute_ms:.4f} ms "
              f"({brute_ops / 1e9:.1f} GFLOP) [{card}]", flush=True)
        check(diff == 0, f"sweep {name} {what}: {diff} selections differ from the plain sweep")
        check(dead_ok, f"sweep {name} {what}: a dead ray selected something")
        check(hits[0] > 0 and (hits[1] > 0 or what != "primary"), f"sweep {name} {what}: no hits")
        return dict(ms=ms, plain_ms=plain_ms, nbytes=nbytes, ops=ops, stats=c)

    scenes = (("demo", demo.reference_demo_scene(32, 16)),
              ("config 4", demo.config4_mixed_scene(128, 64)),
              ("65,024-row mesh", getattr(demo, STAGED_SCENE[0])(**STAGED_SCENE[1])))
    jit = rng.ray_uniforms(0x5EE9, 0, R, 1, dev)
    o0, d0 = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, (jit - 0.5).T))
    for name, scn in scenes:
        pkt = scn.build_packet(device=dev)
        scene = sk.prepare(pkt)
        t_valid, s_valid = int(pkt.tri_valid.sum()), int(pkt.sph_valid.sum())
        if name != scenes[-1][0]:
            for what, (o, d, act) in (("primary", (o0, d0, None)),
                                      ("bounce 1", bounce1(o0, d0, pkt, scene))):
                hold(name, what, o, d, scene, act, t_valid, s_valid, compare_all=name == "demo")
            continue
        main = hold(name, "primary", o0, d0, scene, None, t_valid, s_valid, compare_all=True)
        sample = staged_sample(pkt, o0, d0)
        check(len(sample) == B, f"the staged sample swept {len(sample)} bounces")
        per_bounce = [hold(name, f"staged sample, bounce {b}", o, d, scene, act, t_valid,
                           s_valid) for b, (o, d, act) in enumerate(sample)]
        print(f"  {name}, one staged sample: sweep {sum(x['ms'] for x in per_bounce):.4f} ms "
              f"over {B} bounces, (ray, leaf) pairs passed "
              f"{sum(x['stats']['pairs_passed'] for x in per_bounce)}, swept "
              f"{sum(x['stats']['pairs_swept'] for x in per_bounce)} [{card}]", flush=True)
        # the unit built with FMA contraction, not shipped, read in turns
        fma = variant_sweep(finish_unit_build(fma_build), sk, k)
        for what, (o, d, act) in (("primary", (o0, d0, None)), ("bounce 1", sample[1])):
            fns = {"shipped": lambda o=o, d=d, act=act: sk.sweep_packed(
                       o, d, scene, k.t_min, k.t_max, k.det_eps, act),
                   "with FMA": lambda o=o, d=d, act=act: fma(o, d, scene, act)}
            flips = int(sum((g != w) for g, w in zip(fns["with FMA"](), fns["shipped"]()))
                        .bool().sum())
            times = in_turns(fns, 3)
            print(f"  {name}, {what}: shipped {times['shipped']:.4f} ms; with FMA "
                  f"{times['with FMA']:.4f} ms ({flips} rays select otherwise) (CUDA events, "
                  f"in turns) [{card}]", flush=True)
        del sample, per_bounce

    # ---- 20. the staged main path at full width --------------------------------------
    # the mesh's default route is the wavefront and the fused route (phase
    # 24); the staged route is forced, as a user forces it
    pkt = getattr(demo, STAGED_SCENE[0])(**STAGED_SCENE[1]).build_packet(device=dev)
    check(pt.route(pkt, cfg) == "wavefront", f"default route {pt.route(pkt, cfg)}")
    cfg = dataclasses.replace(cfg, intersect_backend="pallas", grad_sweep="staged")
    check(pt.route(pkt, cfg) == "staged" and integrator.grad_route(cfg, pkt) == "staged",
          f"forced route {pt.route(pkt, cfg)}, {integrator.grad_route(cfg, pkt)}")
    print(f"phase 20: staged main path, forced (intersect_backend 'pallas', grad_sweep "
          f"'staged'), {STAGED_SCENE[0]}({STAGED_SCENE[1]}) ({pkt.num_triangles} "
          f"triangles in {pkt.tri_valid.shape[0]} rows) at {W}x{H}, "
          f"max_depth {B}: render_step and mse_step spp 1, 1 + {STAGED_STEPS} steps", flush=True)
    sk.launches = 0  # every count to 0 just before the main path
    acc = pt.AccumState.create(H, W, dev)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(cfg.seed)
    acc = pt.render_step(pkt, cam, acc, gen, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STAGED_STEPS):
        acc = pt.render_step(pkt, cam, acc, gen, cfg)
    torch.cuda.synchronize()
    r_ms = (time.perf_counter() - t0) * 1e3 / STAGED_STEPS
    r_peak = torch.cuda.max_memory_allocated()
    r_launches = sk.launches
    lin = acc.linear
    check(r_launches == B * (STAGED_STEPS + 1), f"render_step: {r_launches} sweep launches")
    check(bool(torch.isfinite(lin).all()) and float(lin.min()) >= 0.0
          and float(lin.max()) <= 1.0 + 1e-6 and float(lin.mean()) > 0.0, "render_step: image")
    print(f"  render_step: {r_ms:.1f} ms/step (host clock), peak {r_peak / 2**30:.2f} GiB, "
          f"sweep launches {r_launches} = max_depth x {STAGED_STEPS + 1} samples, image mean "
          f"{float(lin.mean()):.4f} [{card}]", flush=True)
    device_share(lambda: pt.render_step(pkt, cam, acc, gen, cfg), 1, "staged render_step",
                 card)

    params = sh.differentiable_params(pkt, cam)
    target = torch.zeros((R, 3), device=dev)
    sk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    train.mse_step(params, pkt, cam, target, cfg, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STAGED_STEPS):
        loss, grads = train.mse_step(params, pkt, cam, target, cfg, 2 + i)
    torch.cuda.synchronize()
    m_ms = (time.perf_counter() - t0) * 1e3 / STAGED_STEPS
    m_peak = torch.cuda.max_memory_allocated()
    m_launches = sk.launches
    check(m_launches == B * (STAGED_STEPS + 1), f"mse_step: {m_launches} sweep launches")
    check(math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all())
                                             for g in grads.values()), "mse_step: non-finite")
    check(float(grads["transforms"].abs().max()) > 0 and float(grads["cam_position"].abs().max())
          > 0, "mse_step: zero geometry gradients")
    print(f"  mse_step: {m_ms:.1f} ms/step (host clock), {R * B / (m_ms / 1e3) / 1e6:.2f} Mrays/s "
          f"fwd+bwd (W*H*max_depth/s), peak {m_peak / 2**30:.2f} GiB, sweep launches "
          f"{m_launches}, loss {float(loss):.6f}, |d(transforms)| max "
          f"{float(grads['transforms'].abs().max()):.3e} [{card}]", flush=True)
    launches = r_launches + m_launches
    del grads, acc, lin
    device_share(lambda: train.mse_step(params, pkt, cam, target, cfg, 9), 1,
                 "staged mse_step", card)

    # staged against fused, demo scene, same Philox seed: the staged route's
    # gathers (`take_rows` in intersect and integrator) sum their backward
    # in float64; beside them, embedding's own float32 sums, in turns
    dpkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
    dparams = sh.differentiable_params(dpkt, cam)
    c = RenderConfig(width=W, height=H, max_depth=B, grad_sweep="fused")
    lf, gf = train.mse_step(dparams, dpkt, cam, target, c, GRAD_SEED)
    c = RenderConfig(width=W, height=H, max_depth=B, grad_sweep="staged")
    shipped = intersect.take_rows
    gathers = {"float64 sums": shipped,
               "embedding's float32 sums": lambda t, i, pad_row=-1: F.embedding(i.long(), t)}
    res, step_ms = {}, {}
    try:
        for name in ("float64 sums", "embedding's float32 sums", "float64 sums"):
            intersect.take_rows = integrator.take_rows = gathers[name]
            train.mse_step(dparams, dpkt, cam, target, c, GRAD_SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = train.mse_step(dparams, dpkt, cam, target, c, GRAD_SEED)
            torch.cuda.synchronize()
            step_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        # the device time the float64 sums cost: one profiled step of each
        for name in ("embedding's float32 sums", "float64 sums"):
            intersect.take_rows = integrator.take_rows = gathers[name]
            device_share(lambda: train.mse_step(dparams, dpkt, cam, target, c, GRAD_SEED), 1,
                         f"staged mse_step, demo scene, {name} in its gathers", card)
    finally:
        intersect.take_rows = integrator.take_rows = shipped
    for name, (ls, gs) in res.items():
        rels = {}
        for key in gf:
            nf = float(gf[key].norm())
            if nf == 0.0:
                check(float(gs[key].abs().max()) <= 1e-6, f"staged d{key} should be zero")
                continue
            rels[key] = float((gs[key] - gf[key]).norm()) / nf
        print(f"  grad_sweep 'staged' ({name} in its gathers) vs 'fused', demo scene at "
              f"{W}x{H}, spp 1: loss {float(ls):.7f} vs {float(lf):.7f}; gradient relative L2: "
              + ", ".join(f"{key} {v:.2e}" for key, v in rels.items())
              + f"; {', '.join(f'{x:.1f}' for x in step_ms[name])} ms/step (host clock, in "
              f"turns) [{card}]", flush=True)
        if name == "float64 sums":
            for key, v in rels.items():
                check(v <= STAGED_REL, f"staged vs fused d{key}: relative L2 {v:.3e} > "
                      f"{STAGED_REL}")
            check(abs(float(ls) - float(lf)) <= 1e-4 * abs(float(lf)), "staged vs fused loss")
    return with_bound({
        "name": "sweep",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/sweep_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/intersect_kernel.py:95",
        "launches": launches,
        "max_abs_err": 0.0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
    }, main["nbytes"], main["ops"])


# Past the reference's row cap (phase 24). The port's routes take packets
# by its own kernels' limits (wavefront.supports), so the 65,024-row mesh
# of phases 19-20 and a 261,120-row one (4,080 leaves, the mask's global
# instantiation) take the wavefront and the fused route. Every stage is
# held against its plain version on the card: the packing (prepare_scene
# on the card against the CPU: the Morton permutation equal but where a
# float32 rounding of the world-space triangles moves a code, at most
# PACK_PERM_FRAC of the rows, and the rows and leaf boxes that do not move
# within PACK_REL of the scene's scale), the screen binning (the bounce-0
# state equal bit for bit to the one with every leaf listed), the mask at
# every live bounce (verdicts equal), the shortlists (equal to the CPU's
# compaction in each row's [0, count)),
# the bounce kernel plain and recording (as phase 10), the whole trace on
# PAST_CAP_ROWS rows of pixels (as the card test: TIGHT_FRAC of the
# channels within TIGHT, rays beyond it on at most 1e-4 of them), the table
# and its Morton gather (against the CPU's build), the global backward (as
# phase 17) and B11 on those rows (as phase 15). Then the default route,
# the forced staged route and a force="culled" step at 1920x1080, timed in
# turns.
PAST_CAP_MESHES = (
    ("65,024-row mesh", STAGED_SCENE),
    ("4,080-leaf mesh", ("config3_scene", dict(flat=False, segments=512, rings=256,
                                              diffuse=True))),
)
PAST_CAP_ROWS = 8
PAST_CAP_STEPS = 2
PACK_PERM_FRAC = 1e-3
PACK_REL = 1e-5


def past_cap_phase(dev, card, rs, static_mask, lane_bounce):
    """Phase 24: the default route on meshes past the reference's 49,152-row
    cap, every stage held against its plain version, the mask's global
    instantiation against the plain version with its counted bound, the
    staged instantiation in turns with the parent's unit (``static_mask``),
    bounce 1 of the bounce kernel in turns with the unit shipped before the
    warp sweep (``lane_bounce``), and the before/after table: the forced staged route against the default
    route and force="culled" at 1920x1080, spp 1, in turns. Returns the
    global instantiation's entry of the ``kernels`` line."""
    import numpy as np
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import integrator, path_replay, rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import fused_grad as fg
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import train
    from ptre_tpu_torch.utils.config import RenderConfig

    W, H, B = W_MAIN, H_MAIN, 5
    shipped_mask = lean_wave_mask(build.load_library(), wf, mk, shipped=True)
    R = W * H
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    forced = dataclasses.replace(cfg, intersect_backend="pallas", grad_sweep="staged")
    k = mk.TraceConsts.from_config(cfg)
    cam = cam_ops.Camera.create(width=W, height=H)
    px, py = pt.pixel_grid(H, W, dev)
    seed = 0x24
    u = rng.ray_uniforms(seed, 1, R, 1, dev)
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, (u - 0.5).T))
    rows = slice((H // 2) * W, (H // 2 + PAST_CAP_ROWS) * W)
    o8, d8 = o[rows].contiguous(), d[rows].contiguous()
    table_lines, mask_rows, global_launches = [], [], 0
    for name, (fn, kw) in PAST_CAP_MESHES:
        pkt = getattr(demo, fn)(**kw).build_packet(device=dev)
        check(wf.supports(pkt) and pt.route(pkt, cfg) == "wavefront"
              and integrator.grad_route(cfg, pkt) == "fused", f"{name}: default route")
        fg.check_supported(pkt, "culled")
        check(pt.route(pkt, forced) == "staged" and integrator.grad_route(forced, pkt) == "staged",
              f"{name}: forced route")

        # ---- the packing: prepare_scene on the card against the CPU ----------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene = wf.prepare_scene(pkt, screen_cam=cam)
        torch.cuda.synchronize()
        pack_ms = (time.perf_counter() - t0) * 1e3
        cpu = wf.prepare_scene(pkt.to("cpu"), screen_cam=cam.to("cpu"))
        T, n_leaf = scene.tri_rows, scene.n_leaf
        print(f"phase 24: past the reference's row cap, {name}: {pkt.num_triangles} triangles "
              f"in {T} rows, {n_leaf} leaves ({'global' if n_leaf > MASK_STAGED_LEAVES else 'staged'}"
              f" mask instantiation), {pkt.num_spheres} spheres; route {pt.route(pkt, cfg)} / "
              f"{integrator.grad_route(cfg, pkt)}; prepare_scene {pack_ms:.1f} ms on the card "
              f"(host clock) [{card}]", flush=True)
        same = scene.perm_tri.cpu() == cpu.perm_tri
        scale = float(torch.maximum(cpu.scene_lo.abs().amax(), cpu.scene_hi.abs().amax()))
        tri_err = float((scene.tris[:T].cpu()[same] - cpu.tris[:T][same]).abs().max())
        leaf_same = torch.nn.functional.pad(same, (0, n_leaf * wf.LEAF - T),
                                            value=True).view(n_leaf, wf.LEAF).all(dim=1)
        box_err = float((scene.boxes.cpu()[leaf_same] - cpu.boxes[leaf_same]).abs()
                        .nan_to_num(0.0).max())
        print(f"  packing against the CPU's: {int((~same).sum())} of {T} Morton positions "
              f"differ, rows elsewhere within {tri_err:.3e}, the boxes of the {int(leaf_same.sum())}"
              f" leaves they leave alone within {box_err:.3e} (scale {scale:.3f}); supertile "
              f"table {tuple(scene.mask_supers.shape)}", flush=True)
        check(cpu.n_leaf == n_leaf and int((~same).sum()) <= PACK_PERM_FRAC * T,
              f"{name}: the packing differs from the CPU's")
        check(tri_err <= PACK_REL * scale and box_err <= PACK_REL * scale,
              f"{name}: packed rows or boxes differ from the CPU's")
        check(torch.equal(scene.mask_supers, mk.pack_super_boxes(scene.boxes)),
              f"{name}: the mask's supertile table")
        del cpu

        # ---- bounce 0: the screen binning is conservative --------------------------
        state, ids, short0 = wf.primary_state(o, d, scene, (H, W))
        check(short0 is not None, f"{name}: bounce 0 not screen-binned")
        nb = state.shape[1] // wf.LANES
        nxt = wf.wave_bounce(state, ids, *short0, scene, k, 0, seed, 1)
        every = wf.wave_bounce(state, ids, *wf.all_leaves(nb, n_leaf, device=dev), scene, k, 0,
                               seed, 1)
        torch.cuda.synchronize()
        share0 = float(short0[1].float().sum()) / (nb * n_leaf)
        print(f"  bounce 0: screen binning lists {100 * share0:.3f} % of ({nb} blocks x "
              f"{n_leaf} leaves); the next state bit-equal to every leaf listed", flush=True)
        check(torch.equal(nxt, every), f"{name}: screen binning dropped a hit")
        del every

        # ---- later bounces: mask, compaction, bounce kernel -------------------------
        state, bounce1 = nxt, None
        for b in range(1, B):
            n_live = int((state[9] > 0.5).sum())
            if n_live == 0:
                break
            if n_live >= max(int(wf.SORT_MIN_LIVE * state.shape[1]), 1):
                perm = wf.coherence_order(state, scene)
                state, ids = state[:, perm].contiguous(), ids[perm].contiguous()
            got = wf.wave_mask(state, scene.boxes, k.t_min, supers=scene.mask_supers)
            want = wf.wave_mask_reference(state, scene.boxes, k.t_min)
            counts = torch.zeros(len(wf.MASK_STATS), dtype=torch.int64, device=dev)
            counted = wf.wave_mask(state, scene.boxes, k.t_min, stats=counts,
                                   supers=scene.mask_supers)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(counted, want),
                  f"{name} bounce {b}: mask verdicts differ from the plain version's")
            counts = dict(zip(wf.MASK_STATS, counts.tolist()))
            check(counts["live_rays"] == n_live, f"{name} bounce {b}: live rays {counts}")
            if n_leaf <= MASK_STAGED_LEAVES:  # both units through their C interfaces
                check(torch.equal(static_mask(state, scene.boxes, k.t_min), got),
                      f"{name} bounce {b}: verdicts differ from the parent unit's")
                fns = {"shipped": lambda: shipped_mask(state, scene.boxes, k.t_min),
                       "parent's unit": lambda: static_mask(state, scene.boxes, k.t_min)}
            else:
                fns = {"shipped": lambda: wf.wave_mask(state, scene.boxes, k.t_min,
                                                       supers=scene.mask_supers)}
            turns = in_turns(fns, 10)
            nbytes, ops = mask_work(state, scene, got, counts)
            b_ms, b_by = bound(nbytes, ops)
            print(f"  bounce {b}: mask on {n_live} live rays, verdicts equal to the plain "
                  f"version's and the counting instantiation's; {counts['supertile_tests']} "
                  f"supertile and {counts['leaf_tests']} leaf tests against "
                  f"{n_live * n_leaf} (live ray, leaf) pairs; in turns: " + ", ".join(
                      f"{label} {ms:.4f} ms" for label, ms in turns.items())
                  + f"; bound {b_ms:.4f} ms by {b_by} [{card}]", flush=True)
            if n_leaf > MASK_STAGED_LEAVES:
                hold_lists(f"{name} bounce {b}", state, scene, k, got, card)
            short, cnt = wf.wave_mask_lists(state, scene.boxes, k.t_min,
                                            supers=scene.mask_supers)
            if b == 1:
                plain_ms = cuda_events(lambda: wf.wave_mask_reference(state, scene.boxes,
                                                                      k.t_min), 1)
                mask_rows.append((n_leaf, turns["shipped"], plain_ms, nbytes, ops))
                s_cpu, c_cpu = wf.shortlists_from_mask(got.cpu())
                check(lists_equal((short, cnt), (s_cpu, c_cpu)),
                      f"{name}: the shortlists differ from the CPU's compaction")
                compact_ms = cuda_events(lambda: wf.shortlists_from_mask(got), 3)
                print(f"  bounce 1: the mask kernel's shortlists equal the CPU's compaction of "
                      f"the ({nb}, {n_leaf}) mask; the standalone kernel compacts that mask in "
                      f"{compact_ms:.3f} ms on the card; shortlists of "
                      f"{float(cnt.float().mean()):.1f} leaves a block on average, "
                      f"{int(cnt.max())} at most [{card}]", flush=True)
                bounce1 = (state, ids, short, cnt)
            state = wf.wave_bounce(state, ids, short, cnt, scene, k, b, seed, 1)
        del got, want, counted

        # the bounce kernel, plain and recording, against its plain version
        state1, ids1, short, cnt = bounce1
        pairs = {}
        sel_k = torch.full((B, R), -1, dtype=torch.int32, device=dev)
        sel_r = sel_k.clone()
        bk = wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1, seed, 1)
        bk_rec = wf.wave_bounce(state1, ids1, short, cnt, scene, k, 1, seed, 1, sel=sel_k)
        bp = wf.wave_bounce_reference(state1, ids1, short, cnt, scene, k, 1, seed, 1,
                                      sel=sel_r, stats=pairs)
        torch.cuda.synchronize()
        err = (bk - bp).abs()
        flip = (err > WAVE_FLIP).any(dim=0)
        tight = float((err <= TIGHT).float().mean())
        other = (sel_k != sel_r).any(dim=0)
        other[ids1[flip].long()] = False
        print(f"  bounce 1: bounce kernel against plain max_abs_err {float(err[:, ~flip].max()):.3e}"
              f" outside {int(flip.sum())} flipped rays, {100 * tight:.4f} % within {TIGHT:g}; "
              f"recording state bit-equal, {int(other.sum())} other winners outside flipped "
              f"rays (allowed {math.ceil(FLIP_FRAC * R)}); (live ray, leaf) pairs {pairs['listed_tests']} listed, "
              f"{pairs['own_pairs']} whose box the ray passes", flush=True)
        check(torch.equal(bk, bk_rec), f"{name}: the recording bounce kernel's state differs")
        allowed = math.ceil(FLIP_FRAC * R)
        check(tight >= TIGHT_FRAC and int(flip.sum()) <= allowed and int(other.sum()) <= allowed,
              f"{name}: the bounce kernel disagrees with its plain version")
        hold_bounce_counts(f"{name} bounce 1", scene, k, 1, state1, ids1, short, cnt, pairs)
        urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)).to(dev)
        hold_wave_lane(name, scene, k, [(1, state1, ids1, short, cnt)], lane_bounce, urand, card,
                       reps=5)
        del state, state1, bk, bk_rec, bp, sel_k, sel_r, err, short, cnt, bounce1, urand

        # the whole trace on PAST_CAP_ROWS rows, kernels against plain versions
        t0 = time.perf_counter()
        ck = wf.trace(o8, d8, scene, k, B, seed, 1)
        cp = wf.trace(o8, d8, scene, k, B, seed, 1, plain=True)
        torch.cuda.synchronize()
        err = (ck - cp).abs()
        tight = float((err <= TIGHT).float().mean())
        n_flip = int((err > TIGHT).any(dim=1).sum())
        print(f"  whole trace, {PAST_CAP_ROWS} rows ({o8.shape[0]} rays): {100 * tight:.4f} % "
              f"of the channels within {TIGHT:g}, {n_flip} rays beyond ({time.perf_counter() - t0:.1f}"
              f" s, mostly the plain version)", flush=True)
        check(bool(torch.isfinite(ck).all()) and tight >= TIGHT_FRAC
              and n_flip <= math.ceil(1e-4 * o8.shape[0]), f"{name}: the trace disagrees")

        # ---- training: the table, its Morton gather, the global backward, B11 -------------
        col, sel, perm = wf.trace(o, d, scene, k, B, seed, 1, tile_hint=(H, W), record=True)
        table, T_, sky6 = path_replay.build_table(pkt)
        table_c, _, _ = path_replay.build_table(pkt.to("cpu"))
        tab_err = float((table.cpu() - table_c).abs().max())
        table = torch.cat([table[:T][perm], table[T:]]).contiguous()
        gathered = torch.cat([table_c[:T][perm.cpu()], table_c[T:]])
        check(T_ == T and tab_err <= PACK_REL * scale
              and float((table.cpu() - gathered).abs().max()) <= tab_err,
              f"{name}: the table or its Morton gather differs from the CPU's")
        del table_c, gathered
        dcol = torch.from_numpy(rs.standard_normal((R, 3), dtype=np.float32)).to(dev)
        groups = {"v0-v2": slice(0, 9), "n0-n2": slice(9, 18), "center": slice(18, 21),
                  "radius": slice(21, 22), "albedo": slice(23, 26), "param": slice(26, 27)}
        print(f"  the table ({table.shape[0]} rows) within {tab_err:.3e} of the CPU's, its "
              f"Morton gather equal; global backward on the recorded selections "
              f"({int((sel >= 0).sum())} hits):", flush=True)
        hold_backward(fg, mk, f"{name} global bwd", table, sky6, o, d, sel, dcol, k, B, T, seed,
                      None, groups)
        bwd_ms = cuda_events(lambda: fg.fused_bwd(table, sky6, o, d, sel, dcol, k, B, T, seed,
                                                  1), 5)
        cc, cs = mk.trace_culled(o8, d8, scene, k, B, seed, 1, record=True)
        pc, ps = mk.trace_culled_reference(o8, d8, scene, k, B, seed, 1, record=True)
        torch.cuda.synchronize()
        flip = ((cc - pc).abs() > 0.05 * pc.abs().clamp_min(1.0)).any(dim=1) | (cs != ps).any(dim=0)
        tight = float(((cc - pc).abs() <= TIGHT * pc.abs().clamp_min(1.0)).float().mean())
        check(tight >= TIGHT_FRAC and int(flip.sum()) <= math.ceil(1e-4 * o8.shape[0]),
              f"{name}: the culled megakernel disagrees with its plain version")
        culled_ms = cuda_events(lambda: mk.trace_culled(o, d, scene, k, B, seed, 1, record=True),
                                3)
        print(f"  culled megakernel on {PAST_CAP_ROWS} rows: {100 * tight:.4f} % of the channels "
              f"within {TIGHT:g}, {int(flip.sum())} rays flipped; global backward "
              f"{bwd_ms:.4f} ms, culled megakernel {culled_ms:.4f} ms a recording sample at "
              f"{W}x{H} (CUDA events) [{card}]", flush=True)
        del col, sel, perm, table, dcol, cc, cs, pc, ps

        # ---- the default route against the forced staged route, in turns --------------
        params = sh.differentiable_params(pkt, cam)
        target = torch.zeros((R, 3), device=dev)
        acc = pt.AccumState.create(H, W, dev)

        def render(c):
            return lambda i: pt.render_step(pkt, cam, acc, 700 + i, c)

        def mse(c):
            return lambda i: train.mse_step(params, pkt, cam, target, c, 800 + i)

        def culled(i):
            leaves = {key: v.detach().requires_grad_(True) for key, v in params.items()}
            pk, cm = sh.apply_params(leaves, pkt, cam)
            jit = rng.ray_uniforms(900 + i, 0, R, 1, dev)
            oo, dd = cam_ops.get_rays(cm, px, py, (jit - 0.5).T)
            color = fg.trace_grad(oo, dd, pk, cfg, 900 + i, 0, force="culled", screen_cam=cm)
            loss = torch.mean((color - target) ** 2)
            return loss.detach(), torch.autograd.grad(loss, list(leaves.values()),
                                                      allow_unused=True)

        def steps(fn):
            fn(0)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(PAST_CAP_STEPS):
                out = fn(1 + i)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / PAST_CAP_STEPS, out

        def launches():
            return (wf.mask_launches, wf.bounce_launches, fg.launches, mk.culled_launches,
                    sk.launches)

        times = {}
        for label, fn, c in (("render_step staged", render, forced),
                             ("render_step default", render, cfg),
                             ("render_step default", render, cfg),
                             ("render_step staged", render, forced),
                             ("mse_step staged", mse, forced),
                             ("mse_step default", mse, cfg),
                             ("mse_step default", mse, cfg),
                             ("mse_step staged", mse, forced),
                             ("mse_step force='culled'", None, None)):
            # every count to 0 just before a route is driven, read just after
            wf.mask_launches = wf.bounce_launches = fg.launches = mk.culled_launches = 0
            sk.launches = 0
            ms, out = steps(culled if fn is None else fn(c))
            n = launches()
            samples = PAST_CAP_STEPS + 1
            if label.endswith("staged"):
                ok = n[:4] == (0, 0, 0, 0) and n[4] == B * samples
            elif fn is None:
                ok = n == (0, 0, samples, samples, 0)
            else:
                ok = n[3:] == (0, 0) and n[0] > 0 and samples < n[1] <= B * samples and (
                    n[2] == (samples if fn is mse else 0))
            check(ok, f"{name} {label}: launches (mask, bounce, backward, culled, sweep) {n}")
            if isinstance(out, pt.AccumState):
                check(bool(torch.isfinite(out.linear).all()), f"{name} {label}: image")
            else:
                check(math.isfinite(float(out[0])), f"{name} {label}: loss {float(out[0])}")
            times.setdefault(label, []).append(ms)
            if n_leaf > MASK_STAGED_LEAVES:
                global_launches += n[0]
            print(f"  {label}: {ms:.1f} ms/step (host clock, spp 1, {PAST_CAP_STEPS} steps "
                  f"after one); launches mask {n[0]}, bounce {n[1]}, backward {n[2]}, culled "
                  f"{n[3]}, sweep {n[4]} over {samples} steps [{card}]", flush=True)
        device_share(lambda: pt.render_step(pkt, cam, acc, 1, cfg), 1,
                     f"{name} default render_step", card)
        device_share(lambda: train.mse_step(params, pkt, cam, target, cfg, 1), 1,
                     f"{name} default mse_step", card)
        table_lines.append((name, times))
        del params, target, acc, scene, pkt
        torch.cuda.empty_cache()

    print(f"phase 24: before (the forced staged route) and after (the default route), "
          f"1920x1080, spp 1, max_depth {B}, host clock ms/step, in turns [{card}]:", flush=True)
    print("  | mesh | step | staged (before) | default (after) | force='culled' |", flush=True)
    for name, times in table_lines:
        for step in ("render_step", "mse_step"):
            culled_ms = (", ".join(f"{x:.1f}" for x in times["mse_step force='culled'"])
                         if step == "mse_step" else "-")
            print(f"  | {name} | {step} | " + ", ".join(
                f"{x:.1f}" for x in times[f"{step} staged"]) + " | " + ", ".join(
                f"{x:.1f}" for x in times[f"{step} default"]) + f" | {culled_ms} |", flush=True)
    # the global instantiation: bounce 1 of the 4,080-leaf mesh
    _, ms, plain_ms, nbytes, ops = max(mask_rows)
    return with_bound({
        "name": "wave_mask_global",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/mask_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/wavefront.py:102",
        "launches": global_launches,
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
    }, nbytes, ops)


# Phase 25: material tables past the reference's 8 rows. Scene A is the demo
# (`reference_demo_scene(32, 16)`) or config 4 (`config4_mixed_scene(128,
# 64)`) with 8 materials, every model on an id of its own; scene B the same
# geometry with MATS_DECOYS decoy rows (emissive, bright, odd albedo) before
# A's 8 and every model on its id + MATS_DECOYS, 24 materials: the parent
# sent B to the staged route. The wave kernel stages A's table in shared
# memory and reads B's in place (the other kernels read both in place), with
# the same arithmetic on the same rows, so B's
# images, colours and selections equal A's bit for bit, and each kernel
# holds to its plain version on B as the earlier phases hold it on A. A
# 300-material config-4 scene (MATS_MANY distinct rows, models on ids past
# 40) is held to the plain version on PAST_CAP_ROWS rows of pixels.
MATS_DECOYS = 16
MATS_MANY = 300
MATS_SCENES = (("demo", "reference_demo_scene", (32, 16), {"ground": 2, "sph": 4, "wall": 3}),
               ("config 4", "config4_mixed_scene", (128, 64),
                {"b": 5, "c": 6, "s": 4, "g": 7}))
MATS_EXTRA = ((False, (0.8, 0.35, 0.2), 0.6), (True, (1.0, 0.85, 0.6), 3.0),
              (False, (0.2, 0.6, 0.9), 0.2), (False, (0.9, 0.9, 0.3), 1.0),
              (True, (0.5, 0.7, 1.0), 6.0), (False, (0.4, 0.45, 0.5), 0.0))


def decoy_pair(fn, args, ids, dev):
    """(A, B) packets on ``dev``: demo.``fn(*args)`` with MATS_EXTRA added (8
    materials) and its models on ``ids``, and the same packet with
    MATS_DECOYS decoy rows before A's and every id shifted past them."""
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.models.scene import Material, MaterialKind

    scn = getattr(demo, fn)(*args)
    for em, albedo, param in MATS_EXTRA:
        scn.add_material(Material(MaterialKind.EMISSIVE if em else MaterialKind.OREN_NAYAR,
                                  albedo, param))
    for model, mid in ids.items():
        scn.set_model_material(model, mid)
    a = scn.build_packet(device=dev)
    i = torch.arange(MATS_DECOYS, dtype=torch.float32, device=dev)
    decoy_albedo = torch.stack([3.0 + i, torch.full_like(i, 0.01), 7.0 - 0.25 * i], dim=1)
    b = dataclasses.replace(
        a, mat_kind=torch.cat([(i.long() % 2 == 0).to(a.mat_kind.dtype), a.mat_kind]),
        mat_albedo=torch.cat([decoy_albedo, a.mat_albedo]),
        mat_param=torch.cat([25.0 + i, a.mat_param]),
        tri_mat=a.tri_mat + MATS_DECOYS, sph_mat=a.sph_mat + MATS_DECOYS,
        num_materials=a.num_materials + MATS_DECOYS)
    return a, b


def many_materials_scene(dev, rs):
    """Config 4 at (128, 64) with MATS_MANY distinct materials (a seventh of
    them emissive), its models on ids 40, 123, 206 and 289."""
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.models.scene import Material, MaterialKind

    scn = demo.config4_mixed_scene(128, 64)
    for i in range(MATS_MANY - 2):
        scn.add_material(Material(
            MaterialKind.EMISSIVE if i % 7 == 0 else MaterialKind.OREN_NAYAR,
            tuple(float(x) for x in rs.uniform(0.1, 0.9, 3)), float(rs.uniform(0.0, 1.5))))
    for j, (model, _) in enumerate(scn.sorted_models()):
        scn.set_model_material(model, 40 + 83 * j)
    return scn.build_packet(device=dev)


def materials_phase(dev, card, rs):
    """Phase 25: the decoy pairs and the 300-material scene through the
    render, record, wave and culled kernels (see MATS_SCENES above) at
    1920x1080, max_depth 5: each kernel against its plain version and B's
    output against A's, bit for bit; `render_step` (spp 4), `mse_step`
    (spp 1) and a force="culled" step with their launches (no sweep
    launch); the default route in turns with the forced staged route (the
    parent's route for B) and with A's, as a table."""
    import numpy as np
    import torch

    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import integrator, rng
    from ptre_tpu_torch.ops.cuda import fused_grad as fg
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import render_kernel as rk
    from ptre_tpu_torch.ops.cuda import sweep_kernel as sk
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import train
    from ptre_tpu_torch.utils.config import RenderConfig

    W, H, B = W_MAIN, H_MAIN, 5
    R = W * H
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    forced = dataclasses.replace(cfg, intersect_backend="pallas", grad_sweep="staged")
    k = mk.TraceConsts.from_config(cfg)
    cam = cam_ops.Camera.create(width=W, height=H)
    rows = rk.camera_rows(cam)
    px, py = pt.pixel_grid(H, W, dev)
    seed = 0x25
    o, d = (x.contiguous() for x in cam_ops.get_rays(
        cam, px, py, (rng.ray_uniforms(seed, 1, R, 1, dev) - 0.5).T))
    band = slice((H // 2) * W, (H // 2 + PAST_CAP_ROWS) * W)
    o8, d8 = o[band].contiguous(), d[band].contiguous()
    urand = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)).to(dev)

    def counts():
        return (rk.launches, mk.record_launches, wf.mask_launches, wf.bounce_launches,
                fg.launches, mk.culled_launches, sk.launches)

    def reset():
        rk.launches = mk.record_launches = wf.mask_launches = wf.bounce_launches = 0
        fg.launches = mk.culled_launches = sk.launches = 0

    def hold_traced(what, got, want, got_sel=None, want_sel=None, n=R, flip_frac=1e-4):
        """A trace's colour (and selections) against its plain version, as
        phases 6 and 24 hold them: TIGHT (relative above 1) on TIGHT_FRAC of
        the channels, at most ceil(flip_frac n) rays flipped."""
        diff = (got - want).abs()
        scale = want.abs().clamp_min(1.0)
        tight = float((diff <= TIGHT * scale).float().mean())
        flip = (diff > 0.05 * scale).any(dim=1)
        if got_sel is not None:
            flip |= (got_sel != want_sel).any(dim=0)
        print(f"  {what}: {100 * tight:.4f} % of the channels within {TIGHT:g}, "
              f"{int(flip.sum())} rays flipped of {n}", flush=True)
        check(bool(torch.isfinite(got).all()) and tight >= TIGHT_FRAC
              and int(flip.sum()) <= math.ceil(flip_frac * n), f"{what}: disagrees with plain")

    def culled_step(pkt, i):
        params = sh.differentiable_params(pkt, cam)
        leaves = {key: v.detach().requires_grad_(True) for key, v in params.items()}
        pk, cm = sh.apply_params(leaves, pkt, cam)
        jit = rng.ray_uniforms(900 + i, 0, R, 1, dev)
        oo, dd = cam_ops.get_rays(cm, px, py, (jit - 0.5).T)
        color = fg.trace_grad(oo, dd, pk, cfg, 900 + i, 0, force="culled", screen_cam=cm)
        loss = torch.mean(color ** 2)
        return loss.detach(), torch.autograd.grad(loss, list(leaves.values()),
                                                  allow_unused=True)

    def steps(fn, n=PAST_CAP_STEPS):
        fn(0)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            out = fn(1 + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, out

    table_lines = []
    for name, fn, args, ids in MATS_SCENES:
        a, b = decoy_pair(fn, args, ids, dev)
        route = "dense" if name == "demo" else "wavefront"
        check(pt.route(b, cfg) == route and integrator.grad_route(cfg, b) == "fused"
              and pt.route(b, forced) == "staged" and integrator.grad_route(forced, b) == "staged",
              f"phase 25 {name}: routes")
        print(f"phase 25: {name}, {b.num_materials} materials (A's 8 at rows {MATS_DECOYS}-"
              f"{MATS_DECOYS + 7}, decoys before them), {b.num_triangles} triangles, "
              f"{b.num_spheres} spheres; routes {pt.route(b, cfg)} / "
              f"{integrator.grad_route(cfg, b)}, forced {pt.route(b, forced)}", flush=True)

        # ---- each kernel on B: against its plain version, and equal to A's ----------
        if name == "demo":
            sa, sb = mk.pack_scene(a), mk.pack_scene(b)
            check(tuple(sb.mats.shape) == (24, 8), "phase 25: B's table")
            prev = torch.from_numpy(rs.random((H, W, 3), dtype=np.float32)).to(dev)
            for mode, ur in (("external uniforms", urand.view(2 + 2 * B, H, W)),
                             ("philox", None)):
                got_a = rk.sample_accum(prev.clone(), sa, rows, 3, cfg, seed, ur)
                got_b = rk.sample_accum(prev.clone(), sb, rows, 3, cfg, seed, ur)
                want = rk.sample_accum_reference(prev, sb, rows, 3, cfg, seed, ur)
                torch.cuda.synchronize()
                check(torch.equal(got_a, got_b), f"phase 25 render {mode}: B differs from A")
                compare(got_b, want, pt, f"render kernel on B, {mode} (B equal to A)")
                ur2 = None if ur is None else urand
                ca, sla = mk.trace_fused_sel(o, d, sa, k, B, seed, 0, ur2)
                cb, slb = mk.trace_fused_sel(o, d, sb, k, B, seed, 0, ur2)
                wc, ws = mk.trace_record_reference(o, d, sb, k, B, seed, 0, ur2)
                torch.cuda.synchronize()
                check(torch.equal(ca, cb) and torch.equal(sla, slb),
                      f"phase 25 record {mode}: B differs from A")
                hold_traced(f"record kernel on B, {mode} (B equal to A)", cb, wc, slb, ws,
                            flip_frac=FLIP_FRAC)
        else:
            sa, sb = (wf.prepare_scene(p, screen_cam=cam) for p in (a, b))
            check(tuple(sb.mats.shape) == (24, 8), "phase 25: B's table")
            for mode, ur in (("external uniforms", urand), ("philox", None)):
                ta = wf.trace(o, d, sa, k, B, seed, 1, ur, tile_hint=(H, W), record=True)
                tb = wf.trace(o, d, sb, k, B, seed, 1, ur, tile_hint=(H, W), record=True)
                ma = mk.trace_culled(o, d, sa, k, B, seed, 1, ur, record=True)
                mb = mk.trace_culled(o, d, sb, k, B, seed, 1, ur, record=True)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(ta[:2] + ma, tb[:2] + mb)),
                      f"phase 25 wave / culled {mode}: B differs from A")
                ur8 = None if ur is None else ur[:, band].contiguous()
                ck8 = wf.trace(o8, d8, sb, k, B, seed, 1, ur8, record=True)
                cp8 = wf.trace(o8, d8, sb, k, B, seed, 1, ur8, record=True, plain=True)
                mk8 = mk.trace_culled(o8, d8, sb, k, B, seed, 1, ur8, record=True)
                mp8 = mk.trace_culled_reference(o8, d8, sb, k, B, seed, 1, ur8, record=True)
                torch.cuda.synchronize()
                hold_traced(f"wave kernels on B, {mode}, {PAST_CAP_ROWS} rows (B equal to A "
                            f"at {W}x{H})", ck8[0], cp8[0], ck8[1], cp8[1], o8.shape[0])
                hold_traced(f"culled megakernel on B, {mode}, {PAST_CAP_ROWS} rows (B equal "
                            f"to A at {W}x{H})", mk8[0], mp8[0], mk8[1], mp8[1], o8.shape[0])
            del ta, tb, ma, mb

        # ---- the main path on B: launches, and B's image equal to A's -----------------
        samples = PAST_CAP_STEPS + 1
        target = torch.zeros((R, 3), device=dev)
        reset()
        acc_b = pt.render_step(b, cam, pt.AccumState.create(H, W, dev), seed, cfg, spp=SPP)
        torch.cuda.synchronize()
        n_render = counts()
        acc_a = pt.render_step(a, cam, pt.AccumState.create(H, W, dev), seed, cfg, spp=SPP)
        torch.cuda.synchronize()
        check(torch.equal(acc_a.linear, acc_b.linear), f"phase 25 {name}: B's image differs")
        reset()
        loss_b, grads_b = train.mse_step(sh.differentiable_params(b, cam), b, cam, target, cfg,
                                         seed, spp=1)
        torch.cuda.synchronize()
        n_mse = counts()
        loss_a, grads_a = train.mse_step(sh.differentiable_params(a, cam), a, cam, target, cfg,
                                         seed, spp=1)
        reset()
        culled = culled_step(b, 0)
        torch.cuda.synchronize()
        n_culled = counts()
        # (render, record, mask, bounce, backward, culled, sweep)
        if name == "demo":
            ok = (n_render == (SPP, 0, 0, 0, 0, 0, 0) and n_mse == (0, 1, 0, 0, 1, 0, 0))
        else:
            ok = (n_render[:2] == (0, 0) and n_render[3] > SPP and n_render[4:] == (0, 0, 0)
                  and n_mse[:2] == (0, 0) and n_mse[3] > 1 and n_mse[4:] == (1, 0, 0))
        ok = ok and n_culled == (0, 0, 0, 0, 1, 1, 0)
        print(f"  launches (render, record, mask, bounce, backward, culled, sweep): "
              f"render_step spp {SPP} {n_render}, mse_step spp 1 {n_mse}, force='culled' "
              f"{n_culled}; B's render_step image equal to A's; mse_step loss B {float(loss_b):.9g}"
              f", A {float(loss_a):.9g}", flush=True)
        check(ok, f"phase 25 {name}: launches")
        check(float(loss_a) == float(loss_b), f"phase 25 {name}: B's loss differs from A's")
        check(math.isfinite(float(culled[0])), f"phase 25 {name}: culled loss")
        for key in grads_a:
            ga, gb = grads_a[key], grads_b[key]
            if key in ("mat_albedo", "mat_param"):
                check(float(gb[:MATS_DECOYS].abs().max()) == 0.0,
                      f"phase 25 {name}: a decoy row has a gradient")
                gb = gb[MATS_DECOYS:]
            err = float((gb - ga).norm() / ga.norm().clamp_min(1e-30))
            check(err <= SUM_REL, f"phase 25 {name}: d({key}) of B {err:.3e} from A's")
        print(f"  mse_step gradients of B within {SUM_REL:g} (relative L2, the backward's "
              f"atomics) of A's, material rows {MATS_DECOYS}-{MATS_DECOYS + 7} carrying A's "
              f"0-7, the decoys none", flush=True)
        del acc_a, acc_b, grads_a, grads_b, culled

        # ---- ms/step in turns: B default, B forced staged, A default ------------------
        pa, pb = sh.differentiable_params(a, cam), sh.differentiable_params(b, cam)
        acc = pt.AccumState.create(H, W, dev)
        runs = {
            "render_step B staged": lambda i: pt.render_step(b, cam, acc, 700 + i, forced),
            "render_step B default": lambda i: pt.render_step(b, cam, acc, 700 + i, cfg),
            "render_step A default": lambda i: pt.render_step(a, cam, acc, 700 + i, cfg),
            "mse_step B staged": lambda i: train.mse_step(pb, b, cam, target, forced, 800 + i),
            "mse_step B default": lambda i: train.mse_step(pb, b, cam, target, cfg, 800 + i),
            "mse_step A default": lambda i: train.mse_step(pa, a, cam, target, cfg, 800 + i),
        }
        times = {}
        for step in ("render_step", "mse_step"):
            order = [f"{step} B staged", f"{step} B default", f"{step} A default"]
            for label in order + order[::-1]:
                reset()
                ms, _ = steps(runs[label])
                n = counts()
                staged = label.endswith("staged")
                check((n[6] > 0) == staged and (sum(n[:6]) == 0) == staged,
                      f"phase 25 {name} {label}: launches {n}")
                times.setdefault(label, []).append(ms)
        table_lines.append((name, times))
        print(f"  in turns, host clock ms/step (spp 1, {PAST_CAP_STEPS} steps after one): "
              + "; ".join(f"{label} " + ", ".join(f"{x:.1f}" for x in v)
                          for label, v in times.items()) + f" [{card}]", flush=True)
        del pa, pb, acc, runs, a, b, sa, sb
        torch.cuda.empty_cache()

    # ---- 300 distinct materials: config 4 against the plain version ------------------
    many = many_materials_scene(dev, rs)
    scene = wf.prepare_scene(many, screen_cam=cam)
    check(many.num_materials == MATS_MANY and tuple(scene.mats.shape) == (MATS_MANY, 8),
          "phase 25: the 300-material table")
    ur8 = urand[:, band].contiguous()
    ck8 = wf.trace(o8, d8, scene, k, B, seed, 1, ur8, record=True)
    cp8 = wf.trace(o8, d8, scene, k, B, seed, 1, ur8, record=True, plain=True)
    mk8 = mk.trace_culled(o8, d8, scene, k, B, seed, 1, ur8, record=True)
    mp8 = mk.trace_culled_reference(o8, d8, scene, k, B, seed, 1, ur8, record=True)
    torch.cuda.synchronize()
    print(f"phase 25: config 4 with {MATS_MANY} distinct materials, models on ids 40-289",
          flush=True)
    hold_traced(f"wave kernels, {PAST_CAP_ROWS} rows", ck8[0], cp8[0], ck8[1], cp8[1],
                o8.shape[0])
    hold_traced(f"culled megakernel, {PAST_CAP_ROWS} rows", mk8[0], mp8[0], mk8[1], mp8[1],
                o8.shape[0])
    reset()
    acc = pt.render_step(many, cam, pt.AccumState.create(H, W, dev), seed, cfg, spp=SPP)
    loss, grads = train.mse_step(sh.differentiable_params(many, cam), many, cam,
                                 torch.zeros((R, 3), device=dev), cfg, seed, spp=1)
    torch.cuda.synchronize()
    n = counts()
    print(f"  render_step spp {SPP} and mse_step spp 1: launches (render, record, mask, bounce, "
          f"backward, culled, sweep) {n}; d(mat_albedo) non-zero on rows "
          f"{sorted(set((grads['mat_albedo'].abs().sum(dim=1) > 0).nonzero().flatten().tolist()))}",
          flush=True)
    check(n[:2] == (0, 0) and n[3] > SPP and n[4:] == (1, 0, 0), "phase 25: 300 materials, launches")
    check(bool(torch.isfinite(acc.linear).all()) and math.isfinite(float(loss)),
          "phase 25: 300 materials, image or loss")
    check(float(grads["mat_albedo"][:40].abs().max()) == 0.0
          and float(grads["mat_albedo"][40:].abs().max()) > 0, "phase 25: 300 materials, grads")

    print(f"phase 25: B (24 materials) on the default route against the forced staged route "
          f"(the parent's route for it) and against A (8 materials), 1920x1080, max_depth {B}, "
          f"host clock ms/step, in turns [{card}]:", flush=True)
    print("  | scene | step | B staged (before) | B default (after) | A default |", flush=True)
    for name, times in table_lines:
        for step in ("render_step", "mse_step"):
            print(f"  | {name} | {step} | " + " | ".join(
                ", ".join(f"{x:.1f}" for x in times[f"{step} {which}"])
                for which in ("B staged", "B default", "A default")) + " |", flush=True)


# The replay route (phase 21): grad_sweep="replay", the reference's A/B
# partner of the fused route. The replay kernels run the chain over rows
# gathered outside them, on the recording kernel's selections, and the unit
# is built without FMA contraction, so they round as the plain version
# does: the forward's colour within REPLAY_FWD_ATOL of it on every ray
# (measured bit-equal); the backward held by column group against float32
# and float64 as phase 7 holds the fused backward (`hold_backward`), d(g)
# summed to d(table) through the gather's backward. The fused backward,
# also built without contraction, is held there beside it (its geometry
# sums no further from float64 than GEOM_FACTOR times the plain float32's);
# the fused unit built WITH contraction (the variant not shipped) is read
# beside them, and not held (the replay unit built so is read by
# chip_ablations.py). Against their first designs (csrc/baseline/
# replay_pair/, the same chain and adjoint in the same order, built with
# the same flags): colour, d(o), d(d) and d(g) EQUAL; d(sky), whose blocks
# sum 4 warps instead of 8, within REPLAY_SKY_REL relative L2. Replay
# against fused on the same seed: the same selections and adjoint, but
# d(table) summed in another
# order (the gather's float64 backward against shared-memory atomics) and
# the primal from another chain (the replay chain against the recording
# kernel's formulas): loss within REPLAY_LOSS_REL, material and sky gradients within
# REPLAY_GRAD_REL relative L2. The geometry and camera gradients are sums
# dominated by rays grazing the ground sphere's horizon, where two float32
# evaluations in other operation orders part (ROADMAP C2): measured
# 4.79e-4 to 1.459e-3 (relative L2) while the fused backward contracted
# FMAs, 4.5e-5 to 1.1e-4 since it does not (NVIDIA H100 80GB HBM3, 700.00 W);
# within REPLAY_GEOM_REL, about four times the largest reading.
REPLAY_SEED = 0x2E91A
REPLAY_FWD_ATOL = 1e-4
REPLAY_LOSS_REL, REPLAY_GRAD_REL, REPLAY_GEOM_REL = 1e-5, 1e-4, 5e-4
REPLAY_SKY_REL = 1e-6
REPLAY_GEOMETRY = ("transforms", "sph_center", "sph_radius", "cam_position", "cam_forward",
                   "cam_fov")
OPS_REPLAY_FWD = 250  # replay.cuh: one hit bounce's chain forward (rough count)
ROW_BYTES = 27 * 4    # a unified-table row (d(g) is written whole)
# the columns chain_bounce reads of a hit's row (replay.cuh): an emitter's
# kind, albedo and param; a sphere's centre, radius and those five; a
# triangle's vertices, normals and those five
EMITTER_ROW_BYTES, SPHERE_ROW_BYTES, TRIANGLE_ROW_BYTES = 5 * 4, 9 * 4, 23 * 4


def rel_l2(a, b):
    """Relative L2 distance of ``a`` from ``b``, a float."""
    return float((a - b).norm() / b.norm())


def lib_replay_pair(lib, rpk, mk):
    """The replay forward and backward of another build of the replay unit
    (its first design, `start_baseline_build`; the unit built WITH FMA
    contraction or an ablation's variant, `start_unit_build`), as functions
    of `replay_fwd`'s and `replay_bwd`'s arguments (the backward also takes
    ``d_g``, where to write d(g): by default a new tensor shaped as g); they
    launch straight from ``lib`` through the shipped C interface and count
    nothing."""
    import ctypes

    import torch

    ptr = ctypes.c_void_p
    lib.ptre_replay_blocks.restype = ctypes.c_int
    lib.ptre_replay_blocks.argtypes = [ctypes.c_int]
    for fn, n in ((lib.ptre_replay_fwd, 9), (lib.ptre_replay_bwd, 13)):
        fn.restype, fn.argtypes = ctypes.c_int, [ptr] * n

    def params(o, k, B, T, seed, sample, ur):
        return mk.trace_params(o.shape[0], k, B, seed, sample, ur is not None, sph_offset=T,
                               n_rows=rpk._ANY_ROW)

    def stream(o):
        return torch.cuda.current_stream(o.device).cuda_stream

    def fwd(o, d, g, sel, sky6, T, k, B, seed=0, sample=0, ur=None):
        p = params(o, k, B, T, seed, sample, ur)
        color = torch.empty_like(o)
        rc = lib.ptre_replay_fwd(ctypes.addressof(p), g.data_ptr(), sky6.data_ptr(),
                                 o.data_ptr(), d.data_ptr(), sel.data_ptr(),
                                 None if ur is None else ur.data_ptr(), color.data_ptr(),
                                 stream(o))
        check(rc == 0, f"replay forward ({lib._name}) launch failed ({rc})")
        return color

    def bwd(o, d, g, sel, sky6, dcol, T, k, B, seed=0, sample=0, ur=None, d_g=None):
        p = params(o, k, B, T, seed, sample, ur)
        d_o, d_d = torch.empty_like(o), torch.empty_like(d)
        d_g = torch.empty_like(g) if d_g is None else d_g
        part = torch.empty((lib.ptre_replay_blocks(o.shape[0]), 8), device=o.device)
        rc = lib.ptre_replay_bwd(ctypes.addressof(p), g.data_ptr(), sky6.data_ptr(),
                                 o.data_ptr(), d.data_ptr(), sel.data_ptr(),
                                 None if ur is None else ur.data_ptr(), dcol.data_ptr(),
                                 d_o.data_ptr(), d_d.data_ptr(), d_g.data_ptr(),
                                 part.data_ptr(), stream(o))
        check(rc == 0, f"replay backward ({lib._name}) launch failed ({rc})")
        return d_o, d_d, d_g, part[:, :6].sum(dim=0)

    return fwd, bwd


def replay_work(sel, table, T):
    """The bytes and operations of the replay forward and backward on
    recorded selections ``sel`` (B, R) over ``table`` (spheres from row T):
    each ray's o, d read and its colour written; the selection of every
    bounce a live path enters (an ended path needs no later one); the
    columns chain_bounce reads of each hit's row (*_ROW_BYTES); the
    backward also d(colour) read and d(o), d(d) and the whole of d(g)
    written, its operations `bwd_ops`'. Returns ((forward bytes, ops),
    (backward bytes, ops), {kind: bounces entered})."""
    B, R = sel.shape
    ops, _, n = bwd_ops(sel, table, T)
    rows = (n["emitter"] * EMITTER_ROW_BYTES + n["sphere"] * SPHERE_ROW_BYTES
            + n["triangle"] * TRIANGLE_ROW_BYTES)
    read = R * 24 + 4 * sum(n.values()) + rows
    return ((read + R * 12, (n["triangle"] + n["sphere"]) * OPS_REPLAY_FWD),
            (read + R * (12 + 24 + ROW_BYTES * B), ops), n)


def hold_replay_first(what, shipped, first, args):
    """The replay pair against its first design on one input (``args``:
    `replay_fwd`'s, and for the backward the same with dcol after sky6):
    ``shipped`` and ``first`` are (fwd, bwd) pairs. The colour, d(o), d(d)
    and d(g) EQUAL; d(sky) within REPLAY_SKY_REL relative L2."""
    import torch

    o, d, g, sel, sky6, dcol, *rest = args
    col, fcol = shipped[0](o, d, g, sel, sky6, *rest), first[0](o, d, g, sel, sky6, *rest)
    got, want = shipped[1](*args), first[1](*args)
    torch.cuda.synchronize()
    sky = rel_l2(got[3], want[3])
    equal = {name: torch.equal(a, b) for name, a, b in
             (("colour", col, fcol), ("d(o)", got[0], want[0]), ("d(d)", got[1], want[1]),
              ("d(g)", got[2], want[2]))}
    print(f"  {what}: " + ", ".join(f"{name} {'bit-equal' if ok else 'DIFFERS'}"
                                    for name, ok in equal.items())
          + f" to the first design's (csrc/baseline/replay_pair/); d(sky) relative L2 {sky:.3e}",
          flush=True)
    check(all(equal.values()), f"{what}: differs from the first design: {equal}")
    check(sky <= REPLAY_SKY_REL, f"{what}: d(sky) {sky:.3e} from the first design's")
    check(bool((got[2][sel < 0] == 0).all()), f"{what}: d(g) not zero on misses")


def replay_as_table(bwd, path_replay):
    """A replay backward (`replay_bwd` or `replay_bwd_reference`) as a
    function of `fused_bwd`'s arguments: the rows gathered from ``table``
    (`gather_rows`), d(g) summed into d(table) by the gather's backward.
    Returns (d table, d sky6, d o, d d). The card's gather takes float32
    tables: a float64 table (the plain float64 reference) is gathered by
    ``embedding`` from the table padded with a zero row, its backward
    ``embedding``'s float64 segment sums, the pad row's cotangents dropped."""
    import torch
    import torch.nn.functional as F

    def fn(table, sky6, o, d, sel, dcol, k, B, T, seed, sample, ur):
        leaf = table.detach().requires_grad_(True)
        with torch.enable_grad():
            if table.dtype == torch.float32:
                g = path_replay.gather_rows(leaf, sel)
            else:
                P = table.shape[0]
                padded = torch.cat([leaf, leaf.new_zeros((1, leaf.shape[1]))])
                g = F.embedding(torch.where(sel >= 0, sel, P).long(), padded, padding_idx=P)
        d_o, d_d, d_g, dsky = bwd(o, d, g.detach(), sel, sky6, dcol, T, k, B, seed, sample, ur)
        (dtable,) = torch.autograd.grad(g, leaf, d_g)
        return dtable, dsky, d_o, d_d

    return fn


def replay_build_report(build, card):
    """The shipped replay kernels' registers, spills and static shared
    memory (`-Xptxas=-v` of this run's build), and at max_depth 5 and 8 the
    backward's dynamic shared memory a block and both kernels' resident
    blocks an SM (`ptre_replay_occupancy`)."""
    import ctypes

    print("  replay kernels: " + "; ".join(
        e for e in (ptxas_summary(build.last_build[1]) if build.last_build else
                    ["library not built in this run"]) if e.startswith(("replay", "library"))),
        flush=True)
    lib = build.load_library()
    for depth in (5, 8):
        fwd, bwd, dyn = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.ptre_replay_occupancy(depth, ctypes.byref(fwd), ctypes.byref(bwd),
                                       ctypes.byref(dyn))
        check(rc == 0, f"ptre_replay_occupancy({depth}) failed ({rc})")
        print(f"  max_depth {depth}: backward {dyn.value} B of dynamic shared memory a block, "
              f"{bwd.value} blocks of 128 threads an SM ({4 * bwd.value} warps); forward "
              f"{fwd.value} blocks an SM [{card}]", flush=True)


def replay_phases(dev, card, rs, fma_bwd, first_pair):
    """Phase 21: the replay forward and backward kernels against their
    plain versions at 1920x1080 on the recording kernel's selections and
    against their first designs (``first_pair``: `lib_replay_pair` of the
    frozen unit) at max_depth 5 and 8, the
    replay route against the fused route on the same seed, and the replay
    route's main path (`mse_step` spp 1, 1 + STEPS steps; one
    `two_pass_mse_step` at spp SPP_TRAIN) with its launches, times, peak
    memory and a device profile. Returns the two kernels' entries of the
    ``kernels`` line."""
    import numpy as np
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import integrator, path_replay, rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import fused_grad as fg
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.config import RenderConfig

    W, H, B = W_MAIN, H_MAIN, 5
    R = W * H
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    params = sh.differentiable_params(pkt, cam)
    _, cam_dev = sh.apply_params(params, pkt, cam)
    px, py = pt.pixel_grid(H, W, dev)
    jit = rng.ray_uniforms(REPLAY_SEED, 0, R, 1, dev) - 0.5
    o, d = (t.contiguous() for t in cam_ops.get_rays(cam_dev, px, py, jit.T))
    scene = mk.pack_scene(pkt)
    k = mk.TraceConsts.from_config(cfg)
    table, T, sky6 = path_replay.build_table(pkt)
    P = table.shape[0]
    urand_ext = torch.from_numpy(rs.random((2 + 2 * B, R), dtype=np.float32)).to(dev)
    shipped = (rpk.replay_fwd, rpk.replay_bwd)
    print(f"phase 21: the replay route at {W}x{H}, max_depth {B}: replay kernels vs plain on "
          "the recording kernel's selections and vs their first designs, replay vs fused, "
          "mse_step spp 1 (1 + "
          f"{STEPS} steps), two_pass_mse_step spp {SPP_TRAIN}", flush=True)

    # (a) the forward on the same gathered rows
    fwd_err, recorded = 0.0, {}
    for mode, ur in (("external uniforms", urand_ext), ("philox", None)):
        _, sel = mk.trace_fused_sel(o, d, scene, k, B, REPLAY_SEED, 0, ur)
        g = path_replay.gather_rows(table, sel)
        got = rpk.replay_fwd(o, d, g, sel, sky6, T, k, B, REPLAY_SEED, 0, ur)
        want = rpk.replay_fwd_reference(o, d, g, sel, sky6, T, k, B, REPLAY_SEED, 0, ur)
        torch.cuda.synchronize()
        err = (got - want).abs().amax(dim=1)
        worst = int(err.argmax())
        print(f"  replay forward, {mode}: colour max_abs_err {float(err.max()):.3e} over {R} "
              f"rays, {int((err > REPLAY_FWD_ATOL).sum())} beyond {REPLAY_FWD_ATOL:g}, "
              f"{int((err == 0).sum())} bit-equal (worst ray {worst}: selections "
              f"{sel[:, worst].tolist()})", flush=True)
        check(bool(torch.isfinite(got).all()), f"replay forward {mode}: non-finite colour")
        check(float(err.max()) <= REPLAY_FWD_ATOL, f"replay forward {mode}: colour off by "
              f"{float(err.max())}")
        fwd_err = max(fwd_err, float(err.max()))
        recorded[mode] = (sel, ur)
        del g, got, want

    # (b) the backward, by column group, against float32 and float64
    dcol = torch.from_numpy(rs.standard_normal((R, 3), dtype=np.float32)).to(dev)
    groups = {"v0-v2": slice(0, 9), "n0-n2": slice(9, 18), "center": slice(18, 21),
              "radius": slice(21, 22), "albedo": slice(23, 26), "param": slice(26, 27)}
    kernel = replay_as_table(rpk.replay_bwd, path_replay)
    plain = replay_as_table(rpk.replay_bwd_reference, path_replay)
    read = {"fused": (fg.fused_bwd, True), "fused with FMA": (fma_bwd, False)}
    bwd_err = 0.0
    for mode, (sel, ur) in recorded.items():
        bwd_err = max(bwd_err, hold_backward(fg, mk, f"replay bwd {mode}", table, sky6, o, d,
                                             sel, dcol, k, B, T, REPLAY_SEED, ur, groups,
                                             kernel=kernel, plain=plain, read=read))
        # bit for bit against the first design; d(g) of a bounce that was
        # not live or did not hit exactly zero
        g = path_replay.gather_rows(table, sel)
        hold_replay_first(f"replay pair {mode}", shipped, first_pair,
                          (o, d, g, sel, sky6, dcol, T, k, B, REPLAY_SEED, 0, ur))
        # the gather's backward on a training step's cotangent (the MSE's
        # against a zero target: one sign, so a hot row's sum never cancels):
        # embedding's own float32 sums against take_rows' float64 ones,
        # each against a float64 sum of the same terms
        col = rpk.replay_fwd(o, d, g, sel, sky6, T, k, B, REPLAY_SEED, 0, ur)
        d_g = rpk.replay_bwd(o, d, g, sel, sky6, (2.0 * col / col.numel()).contiguous(), T, k,
                             B, REPLAY_SEED, 0, ur)[2]
        hit = sel >= 0
        exact = torch.zeros(table.shape, dtype=torch.float64, device=dev).index_add_(
            0, sel[hit].long(), d_g[hit].to(torch.float64))
        idx = torch.where(hit, sel, P).long()
        emb32 = torch.ops.aten.embedding_dense_backward(
            d_g.reshape(-1, 27), idx.reshape(-1), P + 1, P, False)[:P].to(torch.float64)
        leaf = table.detach().requires_grad_(True)
        with torch.enable_grad():
            (emb64,) = torch.autograd.grad(path_replay.gather_rows(leaf, sel), leaf, d_g)
        print(f"  replay bwd {mode}, MSE cotangent: d(table) from d(g) against a float64 sum, "
              "relative L2: "
              + "; ".join(f"{name} embedding float32 {rel_l2(emb32[:, sl], exact[:, sl]):.3e}, "
                          f"take_rows {rel_l2(emb64[:, sl].to(torch.float64), exact[:, sl]):.3e}"
                          for name, sl in (("albedo", groups["albedo"]),
                                           ("param", groups["param"]))), flush=True)
        del g, d_g, col, exact, emb32, emb64

    # kernel times at the main shape, the plain versions', and this run's work
    sel_p, _ = recorded["philox"]
    g_p = path_replay.gather_rows(table, sel_p)
    work = replay_work(sel_p, table, T)
    fwd_args = (o, d, g_p, sel_p, sky6, T, k, B, REPLAY_SEED, 0)
    bwd_args = (o, d, g_p, sel_p, sky6, dcol, T, k, B, REPLAY_SEED, 0)
    turns = {}
    for run in (1, 2):
        for name, args, reps in (("forward", fwd_args, 20), ("backward", bwd_args, 10)):
            i = 0 if name == "forward" else 1
            t = in_turns({"shipped": lambda: shipped[i](*args),
                          "first design": lambda: first_pair[i](*args)}, reps)
            turns.setdefault(name, []).append(t)
            print(f"  replay {name} at max_depth {B}, in turns (run {run}): shipped "
                  f"{t['shipped']:.4f} ms, first design {t['first design']:.4f} ms (CUDA "
                  f"events, {W}x{H}) [{card}]", flush=True)
    fwd_ms, bwd_ms, fwd_first_ms, bwd_first_ms = (
        sum(t[label] for t in turns[name]) / len(turns[name])
        for label in ("shipped", "first design") for name in ("forward", "backward"))
    fwd_plain_ms = cuda_events(lambda: rpk.replay_fwd_reference(*fwd_args), 2)
    bwd_plain_ms = cuda_events(lambda: rpk.replay_bwd_reference(*bwd_args), 2)
    slabs = warp_slabs(g_p, sel_p, B)
    check(sum(work[2].values()) == slabs["ray_bounces"],
          f"bounces entered {work[2]} against {slabs['ray_bounces']}")
    run = slabs["warp_bounces"] - slabs["skipped"]
    print(f"  warps (philox sample): {slabs['skipped']} of {slabs['warp_bounces']} "
          f"warp-bounces skipped past dead tails; d(g) slabs: {slabs['zero_slabs']} zeros "
          f"unstaged, {slabs['staged']} staged; {slabs['ray_bounces']} ray-bounces in the "
          f"{run} warp-bounces run: {100 * slabs['ray_bounces'] / (32 * run):.2f} % of their "
          f"lanes alive ({100 * slabs['ray_bounces'] / (32 * slabs['warp_bounces']):.2f} % "
          "were every bounce run)", flush=True)
    replay_build_report(build, card)
    # max_depth 8, the deepest the wrapper takes: fewer blocks an SM
    _, sel8 = mk.trace_fused_sel(o, d, scene, k, 8, REPLAY_SEED, 0)
    g8 = path_replay.gather_rows(table, sel8)
    args8 = (o, d, g8, sel8, sky6, dcol, T, k, 8, REPLAY_SEED, 0)
    hold_replay_first("replay pair philox, max_depth 8", shipped, first_pair, args8)
    t8 = {name: in_turns({"shipped": lambda: shipped[i](*a),
                          "first design": lambda: first_pair[i](*a)}, reps)
          for name, i, a, reps in (("forward", 0, args8[:5] + args8[6:], 10),
                                   ("backward", 1, args8, 5))}
    slabs8 = warp_slabs(g8, sel8, 8)
    print("  max_depth 8, in turns: " + "; ".join(
        f"{name} shipped {t['shipped']:.4f} ms, first design {t['first design']:.4f} ms"
        for name, t in t8.items()) + f"; {slabs8['skipped']} of {slabs8['warp_bounces']} "
        f"warp-bounces skipped, {slabs8['zero_slabs']} zero slabs, {slabs8['staged']} staged "
        f"(CUDA events, {W}x{H}) [{card}]", flush=True)
    work8 = replay_work(sel8, table, T)
    check(sum(work8[2].values()) == slabs8["ray_bounces"],
          f"max_depth 8: bounces entered {work8[2]} against {slabs8['ray_bounces']}")
    print("  max_depth 8 bounds: " + "; ".join(
        f"{name} {ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP; shipped "
        f"{t['shipped'] / ms:.2f} times it)"
        for (name, t), (nbytes, ops) in zip(t8.items(), work8[:2])
        for ms, by in [bound(nbytes, ops)]) + f"; bounces entered by kind {work8[2]}",
        flush=True)
    del g8, sel8, args8
    gather_ms = cuda_events(lambda: path_replay.gather_rows(table, sel_p), 10)
    print(f"  philox sample, bounces entered by kind {work[2]}; "
          f"replay forward kernel "
          f"{fwd_ms:.4f} ms (first design {fwd_first_ms:.4f}), plain {fwd_plain_ms:.3f} ms; "
          f"replay backward kernel {bwd_ms:.4f} ms (first design {bwd_first_ms:.4f}), plain "
          f"{bwd_plain_ms:.3f} ms; gather_rows (take_rows) {gather_ms:.4f} ms (CUDA "
          f"events, {W}x{H}) [{card}]", flush=True)
    del recorded, g_p, urand_ext

    # (c) replay against fused, the reference's own purpose for the route
    target = torch.zeros((R, 3), device=dev)
    ab = {}
    for sweep in ("fused", "replay"):
        c = RenderConfig(width=W, height=H, max_depth=B, grad_sweep=sweep)
        ab[sweep] = train.mse_step(params, pkt, cam, target, c, REPLAY_SEED)
    (lf, gf), (lr, gr) = ab["fused"], ab["replay"]
    loss_rel = abs(float(lr) - float(lf)) / abs(float(lf))
    rels = {}
    for key in gf:
        nf = float(gf[key].norm())
        if nf == 0.0:  # no gradient reaches it (the emissive cube's transform)
            check(float(gr[key].abs().max()) == 0.0, f"replay d{key} should be zero")
            continue
        rels[key] = float((gr[key] - gf[key]).norm()) / nf
    print(f"  grad_sweep 'replay' vs 'fused', {W}x{H}, spp 1, seed {REPLAY_SEED}: loss "
          f"{float(lr):.8f} vs {float(lf):.8f} (relative {loss_rel:.3e}); gradient relative L2: "
          + ", ".join(f"{key} {v:.3e}" for key, v in rels.items()), flush=True)
    check(loss_rel <= REPLAY_LOSS_REL, f"replay vs fused loss: relative {loss_rel:.3e}")
    for key, v in rels.items():
        limit = REPLAY_GEOM_REL if key in REPLAY_GEOMETRY else REPLAY_GRAD_REL
        check(v <= limit, f"replay vs fused d{key}: relative L2 {v:.3e} > {limit}")
    del ab, gf, gr

    # (d) the main path: mse_step on the replay route, counted
    cfg_r = RenderConfig(width=W, height=H, max_depth=B, grad_sweep="replay")
    check(integrator.grad_route(cfg_r, pkt) == "replay", "the demo packet is not routed replay")

    def step(c, seed, spp=1):
        loss, grads = train.mse_step(params, pkt, cam, target, c, seed, spp=spp)
        torch.cuda.synchronize()
        check(math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all())
                                                 for g in grads.values()),
              f"{c.grad_sweep} mse_step: non-finite")
        return loss, grads

    mk.record_launches = rpk.fwd_launches = rpk.bwd_launches = fg.launches = 0
    step(cfg_r, 100)
    t0 = time.perf_counter()
    for i in range(STEPS):
        loss, grads = step(cfg_r, 101 + i)
    r_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    launches = (mk.record_launches, rpk.fwd_launches, rpk.bwd_launches, fg.launches)
    check(launches == (STEPS + 1,) * 3 + (0,), f"replay mse_step: launches (record, replay "
          f"forward, replay backward, fused backward) {launches}, expected one each of the "
          f"first three a sample")
    check(float(grads["mat_albedo"].abs().max()) > 0 and
          float(grads["sph_radius"].abs().max()) > 0 and
          float(grads["cam_position"].abs().max()) > 0, "replay mse_step: zero gradients")
    torch.cuda.reset_peak_memory_stats()
    step(cfg_r, 200)
    r_peak = torch.cuda.max_memory_allocated()
    step(cfg, 100)
    t0 = time.perf_counter()
    for i in range(STEPS):
        step(cfg, 101 + i)
    f_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    torch.cuda.reset_peak_memory_stats()
    step(cfg, 200)
    f_peak = torch.cuda.max_memory_allocated()
    print(f"  replay mse_step spp 1: {r_ms:.3f} ms/step, {R * B / r_ms / 1e3:.2f} Mrays/s "
          f"fwd+bwd (W*H*max_depth/s, host clock), peak {r_peak / 2**30:.2f} GiB, loss "
          f"{float(loss):.6f}; launches a sample: record {launches[0] / (STEPS + 1):g}, replay "
          f"forward {launches[1] / (STEPS + 1):g}, replay backward "
          f"{launches[2] / (STEPS + 1):g}; fused mse_step in this phase {f_ms:.3f} ms/step, "
          f"peak {f_peak / 2**30:.2f} GiB [{card}]", flush=True)
    device_share(lambda: step(cfg_r, 300), 3, "replay mse_step", card)

    # the constant-memory schedule on the replay route at spp SPP_TRAIN
    mk.record_launches = rpk.fwd_launches = rpk.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss2p, grads2p = train.two_pass_mse_step(params, pkt, cam, target, cfg_r, 400,
                                              spp=SPP_TRAIN)
    torch.cuda.synchronize()
    dt2p = (time.perf_counter() - t0) * 1e3
    peak2p = torch.cuda.max_memory_allocated()
    l2p = (mk.record_launches, rpk.fwd_launches, rpk.bwd_launches)
    check(l2p == (2 * SPP_TRAIN, 2 * SPP_TRAIN, SPP_TRAIN),
          f"replay two-pass spp {SPP_TRAIN}: launches {l2p}")
    check(math.isfinite(float(loss2p)) and all(bool(torch.isfinite(g).all())
                                               for g in grads2p.values()),
          "replay two-pass: non-finite")
    print(f"  replay two_pass_mse_step spp {SPP_TRAIN}: {dt2p:.1f} ms/step, peak "
          f"{peak2p / 2**30:.2f} GiB, launches (record, forward, backward) {l2p} [{card}]",
          flush=True)
    del grads2p

    # the two-pass schedule equals the monolithic step (smaller shape)
    Ws, Hs, spp_s = 320, 180, 8
    cfg_s = RenderConfig(width=Ws, height=Hs, max_depth=B, grad_sweep="replay")
    cam_s = cam_ops.Camera.create(width=Ws, height=Hs)
    par_s = sh.differentiable_params(pkt, cam_s)
    tgt_s = torch.from_numpy(rs.uniform(0.0, 0.5, (Ws * Hs, 3)).astype(np.float32)).to(dev)
    l1, g1 = train.mse_step(par_s, pkt, cam_s, tgt_s, cfg_s, 7, spp=spp_s)
    l2, g2 = train.two_pass_mse_step(par_s, pkt, cam_s, tgt_s, cfg_s, 7, spp=spp_s,
                                     samples_per_call=3)
    torch.cuda.synchronize()
    for key in g1:
        a, b = g2[key], g1[key]
        check(bool(torch.allclose(a, b, rtol=TWO_PASS_RTOL,
                                  atol=TWO_PASS_ATOL * float(b.abs().max()))),
              f"replay two_pass d{key} differs from mse_step: {float((a - b).abs().max())}")
    check(abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1)), f"replay two_pass loss {l1} {l2}")
    print(f"  replay two_pass_mse_step == mse_step at {Ws}x{Hs}, spp {spp_s} (chunks of 3): "
          f"loss {float(l1):.6f} vs {float(l2):.6f}", flush=True)

    return [with_bound({
        "name": "replay_fwd",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/replay_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/replay_kernel.py:277",
        "launches": launches[1],
        "max_abs_err": fwd_err,
        "ms": fwd_ms,
        "plain_ms": fwd_plain_ms,
        "first_design_ms": fwd_first_ms,
    }, *work[0]), with_bound({
        "name": "replay_bwd",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/replay_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/replay_kernel.py:289",
        "launches": launches[2],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "first_design_ms": bwd_first_ms,
    }, *work[1])]


# Raster kernels vs plain versions (phases 12-14). Coverage, z and the hard
# shading are never contracted (raster.cuh), so the hard image must equal the
# plain version's bit for bit; a sample that differs counts as an edge flip,
# allowed on at most FLIP_FRAC of the samples. The soft unit is built without
# FMA contraction, but a group is summed in another order and the
# stable sigmoid takes its other branch for negative arguments: the soft
# image within SOFT_ATOL (tests/test_dual_pipeline.py's kernel-vs-XLA bound)
# and the residuals' content (coverage share W/D, colour N/D) within it, the
# max logit m equal on >= TIGHT_FRAC of the samples. d(table) is summed by
# float atomics in no fixed order: within DTAB_REL relative L2 of the plain
# version, and d(transforms), d(camera position) within GRAD_REL. The column
# groups of d(table) (soft_raster.GRAD_GROUPS) span norms from ~1e-15 (1/w,
# whose exact gradient is zero: the normal is normalised) to ~1e4, and the
# inverse squared edge lengths of sliver triangles are ill-conditioned in
# float32, so each group is held on its own against the plain version in
# float64 on the same inputs: no further from it than DTAB_FACTOR times the
# plain float32 version, or DTAB_REL of the group's norm.
SOFT_ATOL, DTAB_REL, GRAD_REL, DTAB_FACTOR = 3e-5, 1e-4, 1e-3, 2.0
RASTER_W, RASTER_H, RASTER_SS, SIGMA = 1280, 720, 2, 0.5
FRAMES_K = 4


def read_ppm(path):
    """(H, W, 3) uint8 of a binary P6 PPM as tests/goldens holds them."""
    import numpy as np

    with open(path, "rb") as f:
        magic, dims, maxval, data = f.read().split(b"\n", 3)
    w, h = (int(v) for v in dims.split())
    if magic != b"P6" or int(maxval) != 255:
        raise SmokeFailure(f"{path}: not a P6 PPM")
    return np.frombuffer(data, np.uint8).reshape(h, w, 3)


def raster_phases(dev, card, rs, first_hard):
    """Phases 12-14: the hard raster, SoftRas forward and SoftRas backward
    kernels against their plain versions (the hard kernel also sample for
    sample against its first design, ``first_hard``, and timed in turns with
    it), then the rasterizer's serving and training main paths at 1280x720
    ss 2. Returns the three kernels' entries of the ``kernels`` line."""
    import dataclasses

    import numpy as np
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.models.scene import Scene
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import raster_kernel as rast
    from ptre_tpu_torch.ops.cuda import soft_raster as sr
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import rasterizer as ras
    from ptre_tpu_torch.render import train
    from ptre_tpu_torch.utils.config import RasterConfig

    W, H, ss = RASTER_W, RASTER_H, RASTER_SS
    Hs, Ws = H * ss, W * ss
    n_samples = Hs * Ws
    cfg = RasterConfig(width=W, height=H, supersample=ss)
    cam = cam_ops.Camera.create(width=W, height=H)
    pkt = demo.reference_demo_scene(32, 16).build_packet(spheres_as_triangles=True, device=dev)
    with torch.no_grad():
        tris, cbox = rast.pack_raster_tris(pkt, cam, cfg)
        soft_tris, _ = sr._soft_cols(pkt, cam, cfg)
    n_live = int((tris[:, 12] > 0.5).sum())
    print(f"phase 12: hard raster kernel vs plain, demo scene ({pkt.num_triangles} triangles, "
          f"{n_live} kept, {cbox.shape[0]} chunks of 64) at {W}x{H} ss {ss} "
          f"({Ws}x{Hs} samples)", flush=True)
    scal = rast.raster_scalars(cfg)
    got = rast.raster_tiles(tris, cbox, scal, Hs, Ws, ss)
    want = rast.raster_reference(tris, cbox, scal, Hs, Ws, ss)
    fst = first_hard(tris, cbox, scal, Hs, Ws, ss)
    torch.cuda.synchronize()
    ys = rast.sample_ys(Hs, ss, 0.0, 1.0, device=dev)
    hard_visits = rast.visited_pairs(cbox, Hs, Ws, ss)
    hard_pairs = rast.box_pairs(tris, ys, Ws)
    swept = hard_visits * rast.TILE * rast.TILE * rast.CHUNK
    flips = int((got != want).any(dim=0).sum())
    hard_err = float((got - want).abs().max())
    allowed = math.ceil(FLIP_FRAC * n_samples)
    n_blocks = -(-Hs // rast.TILE) * -(-Ws // rast.TILE)
    n_first = int((got != fst).any(dim=0).sum())
    print(f"  max_abs_err {hard_err:.3e}; {flips} samples differ (edge flips allowed: "
          f"{allowed}); {n_first} differ from the first design's; visited (block, chunk) "
          f"pairs {hard_visits} of {n_blocks * int((cbox[:, 4] > 0.5).sum())} (blocks x live "
          f"chunks): {swept} (sample, row) pairs swept by the first design, {hard_pairs} of "
          f"them ({100 * hard_pairs / swept:.2f} %) with the sample inside the row's box",
          flush=True)
    check(bool(torch.isfinite(got).all()), "hard kernel: non-finite image")
    check(flips <= allowed, f"hard kernel: {flips} samples differ from the plain version")
    check(n_first == 0, f"hard kernel: {n_first} samples differ from the first design's")
    # the counting instantiation: the same image; the row gate's pairs against
    # those in the rows' own boxes and in their gate boxes (hard_gate_boxes)
    h_stats = torch.zeros(len(rast.STATS), dtype=torch.int64, device=dev)
    counted = rast.raster_tiles(tris, cbox, scal, Hs, Ws, ss, stats=h_stats)
    h_stats = dict(zip(rast.STATS, h_stats.tolist()))
    gate = rast.hard_gate_boxes(tris, rast.window_span(Hs, Ws, ss))
    keep = tris[:, 12] > 0.5
    reach = (gate[:, 1] - tris[:, 24])[keep]
    gate_pairs = rast.box_pairs(tris, ys, Ws, boxes=gate)
    print(f"  row gate: {h_stats['rows_passed']} rows passed of {hard_visits * rast.CHUNK} "
          f"visited; {h_stats['pairs_evaluated']} pairs evaluated (inside the rows' boxes "
          f"{hard_pairs}, inside their gate boxes {gate_pairs}; the first design swept {swept}), "
          f"{h_stats['pairs_covering']} covering; {int(torch.isinf(reach).sum())} of {n_live} kept "
          f"rows ungated, the largest finite reach {float(reach[torch.isfinite(reach)].max()):.3e} "
          "samples", flush=True)
    check(torch.equal(counted, got), "hard kernel: the counting instantiation's image differs")
    check(h_stats["visits"] == hard_visits, f"hard kernel: {h_stats['visits']} visits")
    check(hard_pairs <= h_stats["pairs_evaluated"] <= gate_pairs,
          "hard kernel: pairs evaluated outside [in-box pairs, in-gate-box pairs]")
    geo = float((got - scal[9:12].to(dev)[:, None, None]).abs().amax(dim=0).gt(1e-3).float().mean())
    check(0.05 < geo < 0.95, f"hard kernel: {100 * geo:.1f} % of the samples show geometry")

    # ragged size + strided window, then an empty scene, against the plain versions
    for (Wr, Hr, ssr, y0, rows, stride) in ((999, 537, 2, 5.0, 150, 3), (333, 200, 3, 0.0, 200, 1)):
        cfg_r = RasterConfig(width=Wr, height=Hr, supersample=ssr)
        cam_r = cam_ops.Camera.create(width=Wr, height=Hr)
        with torch.no_grad():
            t_r, b_r = rast.pack_raster_tris(pkt, cam_r, cfg_r)
        sc_r = rast.raster_scalars(cfg_r, 0.0, y0, stride)
        g_r = rast.raster_tiles(t_r, b_r, sc_r, rows * ssr, Wr * ssr, ssr)
        w_r = rast.raster_reference(t_r, b_r, sc_r, rows * ssr, Wr * ssr, ssr)
        f_r = first_hard(t_r, b_r, sc_r, rows * ssr, Wr * ssr, ssr)
        torch.cuda.synchronize()
        n_diff = int((g_r != w_r).any(dim=0).sum())
        n_first_r = int((g_r != f_r).any(dim=0).sum())
        check(n_first_r == 0, f"{Wr}x{Hr}: {n_first_r} samples differ from the first design's")
        # the soft forward there at sigma 2, and its row gate's included pairs
        with torch.no_grad():
            ts_r, _ = sr._soft_cols(pkt, cam_r, cfg_r)
        db_r, ss_r = sr.dilate(b_r, 2.0), rast.raster_scalars(cfg_r, 1.0 / 2.0, y0, stride)
        st_r = torch.zeros(len(sr.STATS), dtype=torch.int64, device=dev)
        gs_r, _ = sr.soft_forward(ts_r, db_r, ss_r, rows * ssr, Wr * ssr, ssr, stats=st_r)
        ws_r, _ = sr.soft_forward_reference(ts_r, db_r, ss_r, rows * ssr, Wr * ssr, ssr)
        s_err = float((gs_r - ws_r).abs().max())
        inc_r = sr.included_pairs(ts_r, db_r, ss_r, rows * ssr, Wr * ssr, ssr)
        print(f"  {Wr}x{Hr} ss {ssr}, rows y0={y0:g} stride {stride} x {rows}: {n_diff} samples "
              f"differ, {n_first_r} from the first design's; soft (sigma 2) max_abs_err {s_err:.3e}, {int(st_r[3])} pairs included "
              f"by the row gate, {inc_r} by the plain version", flush=True)
        check(n_diff <= math.ceil(FLIP_FRAC * g_r[0].numel()), f"{Wr}x{Hr}: {n_diff} differ")
        check(s_err <= SOFT_ATOL and int(st_r[3]) == inc_r, f"{Wr}x{Hr}: soft forward differs")
    empty = Scene().build_packet(spheres_as_triangles=True, device=dev)
    for soft in (False, True):
        with torch.no_grad():
            e_img = ras.rasterize(empty, cam, cfg, soft=soft)
        e_err = float((e_img - torch.tensor(cfg.clear_color, device=dev)).abs().max())
        check(e_err <= 1e-7, f"empty scene (soft={soft}): {e_err} off the clear colour")
    print("  empty scene: the clear colour everywhere (hard and soft)", flush=True)
    # the repo's golden: demo scene (16, 8) at 64x36 ss 2 (scripts/make_goldens.py)
    golden = read_ppm(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                   "goldens", "demo_raster.ppm")).astype(np.int16)
    g_pkt = demo.reference_demo_scene(16, 8).build_packet(spheres_as_triangles=True, device=dev)
    with torch.no_grad():
        g_img = ras.rasterize(g_pkt, cam_ops.Camera.create(width=64, height=36),
                              RasterConfig(width=64, height=36, supersample=2))
    g_u8 = (g_img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy().astype(np.int16)
    gd = np.abs(g_u8 - golden)
    print(f"  demo_raster.ppm: {100 * (gd <= 2).mean():.2f} % within 2 steps, max {gd.max()}",
          flush=True)
    check((gd <= 2).mean() >= DISPLAY_FRAC and gd.max() <= DISPLAY_MAX,
          "the kernel's image is outside the golden bound")

    hard_turns = in_turns({
        "shipped": lambda: rast.raster_tiles(tris, cbox, scal, Hs, Ws, ss),
        "first design": lambda: first_hard(tris, cbox, scal, Hs, Ws, ss)}, 20)
    hard_ms = hard_turns["shipped"]
    hard_plain_ms = cuda_events(lambda: rast.raster_reference(tris, cbox, scal, Hs, Ws, ss), 1)
    print(f"  hard kernel {hard_ms:.4f} ms, the first design {hard_turns['first design']:.4f} ms "
          f"(in turns), plain {hard_plain_ms:.3f} ms (CUDA events, {Ws}x{Hs} samples) [{card}]",
          flush=True)
    if build.last_build is not None:
        print("  " + "; ".join(e for e in ptxas_summary(build.last_build[1])
                               if e.startswith("raster_")), flush=True)

    # ---- the serving main path: rasterize, rasterize_frames ----------------------------
    print(f"phase 12: main path rasterize {W}x{H} ss {ss}, 1 + {STEPS} frames; "
          f"rasterize_frames K = {FRAMES_K}", flush=True)
    rast.launches = 0
    with torch.no_grad():
        img = ras.rasterize(pkt, cam, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            img = ras.rasterize(pkt, cam, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / STEPS
        frame_launches = rast.launches
        check(frame_launches == STEPS + 1, f"rasterize: {frame_launches} kernel launches for "
              f"{STEPS + 1} frames")
        check(img.shape == (H, W, 3) and bool(torch.isfinite(img).all()), "rasterize: image")
        frames = pkt.transforms[None].repeat(FRAMES_K, 1, 1, 1).clone()
        frames[:, :, 3, 1] += torch.linspace(0.0, 0.3, FRAMES_K, device=dev)[:, None]
        rast.launches = 0
        t0 = time.perf_counter()
        imgs = ras.rasterize_frames(pkt, cam, frames, cfg)
        torch.cuda.synchronize()
        dt_k = (time.perf_counter() - t0) / FRAMES_K
        frames_launches = rast.launches
        check(frames_launches == FRAMES_K, f"rasterize_frames: {frames_launches} launches")
        check(torch.equal(imgs[0], img) and torch.equal(imgs[-1], ras.rasterize(
            dataclasses.replace(pkt, transforms=frames[-1]), cam, cfg)),
            "rasterize_frames differs from per-frame rasterize")
        check(not torch.equal(imgs[0], imgs[-1]), "rasterize_frames: the frames do not move")
    print(f"  rasterize: {dt * 1e3:.3f} ms/frame, {W * H / dt / 1e6:.2f} Mpixels/s (host clock); "
          f"rasterize_frames: {dt_k * 1e3:.3f} ms/frame; launches {frame_launches} and "
          f"{frames_launches} [{card}]", flush=True)

    # ---- 13. the soft forward kernel vs its plain version -----------------------------
    print(f"phase 13: SoftRas forward kernel vs plain, {Ws}x{Hs} samples, sigma {SIGMA}",
          flush=True)
    dbox = sr.dilate(cbox, SIGMA)
    sscal = rast.raster_scalars(cfg, 1.0 / SIGMA)
    s_img, s_res = sr.soft_forward(soft_tris, dbox, sscal, Hs, Ws, ss)
    w_img, w_res = sr.soft_forward_reference(soft_tris, dbox, sscal, Hs, Ws, ss)
    torch.cuda.synchronize()
    soft_visits = rast.visited_pairs(dbox, Hs, Ws, ss)
    soft_pairs = rast.box_pairs(soft_tris, ys, Ws, sr.DILATE_SIGMA * SIGMA)
    fwd_err = float((s_img - w_img).abs().max())
    live = w_res[1] > 0
    check(torch.equal(s_res[1] > 0, live), "soft forward: other samples reached by geometry")
    share_err = 0.0
    for k in (2, 3, 4, 5):
        a = torch.where(live, s_res[k] / s_res[1].clamp_min(1e-30), 0.0)
        b = torch.where(live, w_res[k] / w_res[1].clamp_min(1e-30), 0.0)
        share_err = max(share_err, float((a - b).abs().max()))
    m_equal = float((s_res[0] == w_res[0]).float().mean())
    print(f"  image max_abs_err {fwd_err:.3e}; W/D, N/D max_abs_err {share_err:.3e}; max logit "
          f"equal on {100 * m_equal:.4f} % of the samples; {100 * float(live.float().mean()):.2f} % "
          f"of the samples reached; visited (block, chunk) pairs {soft_visits}: "
          f"{soft_visits * rast.TILE * rast.TILE * rast.CHUNK} (sample, row) pairs swept, "
          f"{soft_pairs} with the sample inside the row's dilated box", flush=True)
    check(bool(torch.isfinite(s_img).all() and torch.isfinite(s_res).all()),
          "soft forward: non-finite output")
    check(fwd_err <= SOFT_ATOL and share_err <= SOFT_ATOL, "soft forward differs")
    check(m_equal >= TIGHT_FRAC, f"soft forward: max logit equal on only {m_equal:.6f}")
    # the counting instantiation: same outputs; the gate's pairs against the sweep's
    f_stats = torch.zeros(len(sr.STATS), dtype=torch.int64, device=dev)
    c_img, c_res = sr.soft_forward(soft_tris, dbox, sscal, Hs, Ws, ss, stats=f_stats)
    f_stats = dict(zip(sr.STATS, f_stats.tolist()))
    check(torch.equal(c_img, s_img) and torch.equal(c_res, s_res),
          "soft forward: the counting instantiation's outputs differ")
    check(f_stats["visits"] == soft_visits, f"soft forward: {f_stats['visits']} visits")
    swept = soft_visits * rast.TILE * rast.TILE * rast.CHUNK
    print(f"  row gate: {f_stats['rows_passed']} rows passed of {soft_visits * rast.CHUNK} "
          f"visited; {f_stats['pairs_evaluated']} (sample, row) pairs evaluated, against "
          f"{swept} swept without the row gate and {soft_pairs} inside the row's dilated box; "
          f"{f_stats['pairs_included']} above the coverage threshold", flush=True)
    check(soft_pairs <= f_stats["pairs_evaluated"] <= swept,
          "soft forward: pairs evaluated outside [in-box pairs, pairs swept]")
    if build.last_build is not None:
        print("  " + "; ".join(e for e in ptxas_summary(build.last_build[1])
                               if e.startswith("soft_")), flush=True)
    fwd_ms = cuda_events(lambda: sr.soft_forward(soft_tris, dbox, sscal, Hs, Ws, ss), 10)
    fwd_plain_ms = cuda_events(
        lambda: sr.soft_forward_reference(soft_tris, dbox, sscal, Hs, Ws, ss), 1)
    print(f"  forward kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.3f} ms (CUDA events) "
          f"[{card}]", flush=True)

    # ---- 14. the soft backward kernel vs its plain version ---------------------------
    print("phase 14: SoftRas backward kernel vs plain, same table, residuals and a random "
          "image cotangent", flush=True)
    dimg = torch.from_numpy(rs.standard_normal((3, Hs, Ws), dtype=np.float32)).to(dev)
    got_d = sr.soft_backward(soft_tris, dbox, sscal, w_res, dimg, Hs, Ws, ss)
    want_d = sr.soft_backward_reference(soft_tris, dbox, sscal, w_res, dimg, Hs, Ws, ss)
    torch.cuda.synchronize()
    exact = sr.soft_backward_reference(soft_tris.double(), dbox, sscal, w_res.double(),
                                       dimg.double(), Hs, Ws, ss)
    dtab_rel = float((got_d - want_d).norm() / want_d.norm())
    bwd_err = float((got_d - want_d).abs().max())
    print(f"  d(table): relative L2 {dtab_rel:.3e}, max_abs_err {bwd_err:.3e} (largest "
          f"{float(want_d.abs().max()):.3e})", flush=True)
    check(bool(torch.isfinite(got_d).all()), "soft backward: non-finite d(table)")
    check(dtab_rel <= DTAB_REL, f"soft backward: d(table) relative L2 {dtab_rel}")
    groups = {}
    for group, c in sr.GRAD_GROUPS.items():
        norm = float(exact[:, c].norm())
        groups[group] = (float((got_d.double() - exact)[:, c].norm()),
                         float((want_d.double() - exact)[:, c].norm()), norm)
    print("  d(table) by column group, L2 off float64 of kernel / plain float32 (float64 "
          "norm): " + "; ".join(f"{g} {k:.3e} / {p:.3e} ({n:.3e})"
                                for g, (k, p, n) in groups.items()), flush=True)
    for group, (e_k, e_p, norm) in groups.items():
        check(e_k <= max(DTAB_FACTOR * e_p, DTAB_REL * norm),
              f"soft backward: d(table) {group} {e_k} off float64, plain float32 {e_p}")
    del exact
    n_inc = sr.included_pairs(soft_tris, dbox, sscal, Hs, Ws, ss)
    b_stats = torch.zeros(len(sr.STATS), dtype=torch.int64, device=dev)
    sr.soft_backward(soft_tris, dbox, sscal, w_res, dimg, Hs, Ws, ss, stats=b_stats)
    b_stats = dict(zip(sr.STATS, b_stats.tolist()))
    print(f"  row gate: {b_stats['pairs_evaluated']} pairs evaluated, "
          f"{b_stats['pairs_included']} through the adjoint; the plain version's pairs above "
          f"the coverage threshold (included_pairs) {n_inc}", flush=True)
    check(b_stats == f_stats, f"soft backward: counters {b_stats} against the forward's")
    check(b_stats["pairs_included"] == n_inc == f_stats["pairs_included"],
          "soft kernels: the gate dropped or added a pair above the coverage threshold")
    bwd_ms = cuda_events(lambda: sr.soft_backward(soft_tris, dbox, sscal, w_res, dimg, Hs, Ws,
                                                  ss), 5)
    bwd_plain_ms = cuda_events(lambda: sr.soft_backward_reference(
        soft_tris, dbox, sscal, w_res, dimg, Hs, Ws, ss), 1)
    print(f"  backward kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.3f} ms (CUDA events) "
          f"[{card}]", flush=True)
    del got_d, want_d, s_img, s_res, w_img, w_res, dimg

    # the gradient w.r.t. transforms and camera: kernels vs plain versions
    target = torch.zeros((H, W, 3), device=dev)
    params = sh.differentiable_params(pkt, cam)

    class PlainSoft(torch.autograd.Function):
        """SoftRaster with the plain versions, on the card."""

        @staticmethod
        def forward(ctx, t, b, sc):
            im, rs_ = sr.soft_forward_reference(t.detach(), b, sc, Hs, Ws, ss)
            ctx.save_for_backward(t, b, sc, rs_)
            return im

        @staticmethod
        def backward(ctx, g):
            t, b, sc, rs_ = ctx.saved_tensors
            return sr.soft_backward_reference(t.detach(), b, sc, rs_, g.contiguous(), Hs, Ws,
                                              ss), None, None

    def plain_step():
        leaves = {k: params[k].detach().requires_grad_(True) for k in train.RASTER_PARAM_KEYS}
        pk, cm = sh.apply_params({**params, **leaves}, pkt, cam)
        cols, cb = sr._soft_cols(pk, cm, cfg)
        im = rast.resolve(PlainSoft.apply(cols, sr.dilate(cb, SIGMA), sscal), H, W, ss)
        loss = torch.mean((im - target) ** 2)
        return loss.detach(), dict(zip(train.RASTER_PARAM_KEYS,
                                       torch.autograd.grad(loss, list(leaves.values()))))

    loss_k, grads_k = train.raster_mse_step(params, pkt, cam, target, cfg, SIGMA)
    loss_p, grads_p = plain_step()
    torch.cuda.synchronize()
    check(abs(float(loss_k) - float(loss_p)) <= 1e-5 * float(loss_p),
          f"raster_mse_step loss {float(loss_k)} vs plain {float(loss_p)}")
    for key in ("transforms", "cam_position"):
        rel = float((grads_k[key] - grads_p[key]).norm() / grads_p[key].norm())
        print(f"  d({key}): relative L2 kernels-plain {rel:.3e}", flush=True)
        check(rel <= GRAD_REL, f"raster_mse_step d({key}) relative L2 {rel}")

    # ---- the training main path: raster_mse_step; the soft forward alone ---------------
    print(f"phase 14: main path train.raster_mse_step {W}x{H} ss {ss}, 1 + {STEPS} steps; "
          f"rasterize(soft=True) 1 + {STEPS} frames", flush=True)
    sr.fwd_launches = sr.bwd_launches = 0
    train.raster_mse_step(params, pkt, cam, target, cfg, SIGMA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loss, grads = train.raster_mse_step(params, pkt, cam, target, cfg, SIGMA)
    torch.cuda.synchronize()
    dt_step = (time.perf_counter() - t0) / STEPS
    peak_step = torch.cuda.max_memory_allocated()
    step_launches = (sr.fwd_launches, sr.bwd_launches)
    check(step_launches == (STEPS + 1, STEPS + 1), f"raster_mse_step: launches {step_launches}")
    check(math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all())
                                             for g in grads.values()),
          "raster_mse_step: non-finite loss or gradient")
    check(float(grads["transforms"].abs().max()) > 0 and
          float(grads["cam_position"].abs().max()) > 0, "raster_mse_step: zero gradients")
    sr.fwd_launches = 0
    with torch.no_grad():
        ras.rasterize(pkt, cam, cfg, soft=True, sigma=SIGMA)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            s_frame = ras.rasterize(pkt, cam, cfg, soft=True, sigma=SIGMA)
        torch.cuda.synchronize()
    dt_soft = (time.perf_counter() - t0) / STEPS
    peak_soft = torch.cuda.max_memory_allocated()
    check(sr.fwd_launches == STEPS + 1, f"rasterize(soft): {sr.fwd_launches} launches")
    check(bool(torch.isfinite(s_frame).all()), "rasterize(soft): non-finite image")
    print(f"  raster_mse_step: {dt_step * 1e3:.3f} ms/step (soft forward + backward, host "
          f"clock), loss {float(loss):.6f}, peak {peak_step / 2**20:.1f} MiB; "
          f"rasterize(soft=True): {dt_soft * 1e3:.3f} ms/frame, peak {peak_soft / 2**20:.1f} "
          f"MiB; launches fwd {step_launches[0]}, bwd {step_launches[1]} and "
          f"{sr.fwd_launches} [{card}]", flush=True)
    with torch.no_grad():
        device_share(lambda: ras.rasterize(pkt, cam, cfg), 8, "rasterize", card)
    device_share(lambda: train.raster_mse_step(params, pkt, cam, target, cfg, SIGMA), 4,
                 "raster_mse_step", card)

    # the bounds count the pairs these inputs need (box_pairs, and for the
    # adjoint the pairs above the coverage threshold), not the kernels' sweep;
    # the hard kernel's, the pairs its row gate evaluated (its own counts: at
    # least box_pairs, the rows' boxes grown by their rounding reach)
    table_bytes = tris.numel() * 4 + cbox.numel() * 4
    return [with_bound({
        "name": "raster_hard",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/raster_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/raster_kernel.py:255",
        "launches": frame_launches,
        "max_abs_err": hard_err,
        "ms": hard_ms,
        "plain_ms": hard_plain_ms,
        "first_design_ms": hard_turns["first design"],
    }, table_bytes + 3 * n_samples * 4,
        h_stats["pairs_evaluated"] * OPS_HARD_PAIR + n_samples * OPS_HARD_SAMPLE), with_bound({
        "name": "soft_raster_fwd",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/soft_raster_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/soft_raster.py:144",
        "launches": step_launches[0],
        "max_abs_err": fwd_err,
        "ms": fwd_ms,
        "plain_ms": fwd_plain_ms,
    }, table_bytes + (3 + sr.RES_PLANES) * n_samples * 4,
        soft_pairs * OPS_SOFT_PAIR), with_bound({
        "name": "soft_raster_bwd",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/soft_raster_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/soft_raster.py:251",
        "launches": step_launches[1],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }, 2 * table_bytes + (3 + sr.RES_PLANES) * n_samples * 4,
        soft_pairs * OPS_SOFT_PAIR + n_inc * OPS_SOFT_ADJ)]


ENGINE_W, ENGINE_H = 1280, 720  # the window's size (`app/window.py`)
ENGINE_FRAMES = 12
ENGINE_TOGGLES = (4, 8)  # the 'P' key before these frames
ENGINE_RESET = 6  # the right button before this (raster) frame
ENGINE_TIMED = 20  # frames timed a mode, after 2 warm-up frames
CLI_FRAMES = ["render", "--frames", "4", "--toggle-every", "2", "--format", "npy"]


def engine_phase(dev, card):
    """Phase 22: the engine facade, its checkpoint, the CLI and the native
    scene on the demo at 1280x720, spp 1. Twelve `Renderer` frames with the
    engine toggled before frames 4 and 8 and a reset before frame 6: one
    render kernel launch a path-traced frame and one hard raster launch a
    raster frame, each frame bit-equal to the same seeds replayed through
    `render_step` / `rasterize` directly (dispatch-ahead: frame i returns
    frame i-1's display); a resume from a checkpoint after 3 frames
    bit-equal to 6 uninterrupted frames; ``cli render`` in a subprocess
    (its 4 frames equal to the same command run in this process, which
    counts its launches), ``cli info`` and ``cli bench``; `NativeScene`'s
    demo packets against `Scene.build_packet`; host ms/frame of path-traced
    frames with ``present_async`` on and off and of raster frames."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from ptre_tpu_torch import cli
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.models.native_scene import NativeScene
    from ptre_tpu_torch.models.scene import PACKET_COUNTS, PACKET_LEAVES
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import raster_kernel as rast
    from ptre_tpu_torch.ops.cuda import render_kernel as rk
    from ptre_tpu_torch.render import engine
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import rasterizer as ras
    from ptre_tpu_torch.utils import checkpoint as ckpt
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

    t_phase = time.perf_counter()
    W, H = ENGINE_W, ENGINE_H
    print(f"phase 22: engine, checkpoint, CLI and native scene, demo at {W}x{H}, spp 1",
          flush=True)
    work = os.path.join(build.BUILD_DIR, f"engine.{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    # the CLI in its own process, run while this one checks the engine
    sub_out = os.path.join(work, "cli_sub")
    sub = subprocess.Popen([sys.executable, "-m", "ptre_tpu_torch.cli", *CLI_FRAMES,
                            "--out", sub_out], cwd=root, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        cam = cam_ops.Camera.create(width=W, height=H)
        cfg, rcfg = RenderConfig(width=W, height=H), RasterConfig(width=W, height=H)

        def renderer(**kw):
            return engine.Renderer(demo.reference_demo_scene(32, 16), cam, cfg, rcfg,
                                   device=dev, **kw)

        def drive(r, frames, counts=None):
            """The frames ``r`` returns, toggled and reset as the phase says;
            with ``counts``, each frame's (render, raster) launches."""
            out = []
            for i in range(frames):
                if i in ENGINE_TOGGLES:
                    r.toggle_engine()
                if i == ENGINE_RESET:
                    r.reset()
                before = (rk.launches, rast.launches)
                img = r.draw_frame()  # applies a toggle queued before it
                out.append((r.engine, img))
                if counts is not None:
                    counts.append((rk.launches - before[0], rast.launches - before[1]))
            return out

        # ---- launches and frames, against the seeds replayed directly ----
        r = renderer()
        counts = []
        rk.launches = rast.launches = 0
        frames = drive(r, ENGINE_FRAMES, counts)
        torch.cuda.synchronize()
        launches = (rk.launches, rast.launches)
        kinds = [k for k, _ in frames]
        n_pt = sum(k == engine.EngineKind.PATHTRACER for k in kinds)
        for i, (k, c) in enumerate(zip(kinds, counts)):
            check(c == ((1, 0) if k == engine.EngineKind.PATHTRACER else (0, 1)),
                  f"engine frame {i} ({k.name}): (render, raster) launches {c}")
        check(launches == (n_pt, ENGINE_FRAMES - n_pt), f"engine: launches {launches}")
        check(r.accum.frame == ENGINE_FRAMES - max(ENGINE_TOGGLES),
              f"engine: the reset left {r.accum.frame} samples")
        print(f"  {ENGINE_FRAMES} frames (toggles before {ENGINE_TOGGLES}, reset before "
              f"{ENGINE_RESET}): render kernel {launches[0]} launches for {n_pt} path-traced "
              f"frames, hard raster kernel {launches[1]} for {ENGINE_FRAMES - n_pt} raster "
              "frames, one a frame", flush=True)

        pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
        rpkt = demo.reference_demo_scene(32, 16).build_packet(spheres_as_triangles=True,
                                                              device=dev)
        key = rng.key_for(cfg.seed)
        acc = pt.AccumState.create(H, W, dev)
        direct, pending_reset = [], False
        for i, k in enumerate(kinds):
            pending_reset |= i == ENGINE_RESET
            if k == engine.EngineKind.PATHTRACER:
                if pending_reset:
                    acc, pending_reset = acc.reset(), False
                acc = pt.render_step(pkt, cam, acc, rng.fold(key, i), cfg)
                direct.append(pt.to_display(acc.linear).cpu().numpy())
            else:
                with torch.no_grad():
                    img = ras.rasterize(rpkt, cam, rcfg)
                direct.append((torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy())
        zeros = np.zeros((H, W, 3), np.uint8)
        for i, ((k, got), want) in enumerate(zip(frames, direct)):
            if k == engine.EngineKind.PATHTRACER:  # dispatch-ahead: the previous frame
                fresh = i == 0 or kinds[i - 1] != k
                want = zeros if fresh else direct[i - 1]
            check(np.array_equal(got, want), f"engine frame {i} differs from the direct replay")
        sync_frames = drive(renderer(present_async=False), ENGINE_FRAMES)
        for i, ((_, got), want) in enumerate(zip(sync_frames, direct)):
            check(np.array_equal(got, want), f"synchronous frame {i} differs from the replay")
        check(torch.equal(acc.linear, r.accum.linear), "engine: accumulator differs")
        print(f"  every frame bit-equal to the direct replay ({n_pt} render_step, "
              f"{ENGINE_FRAMES - n_pt} rasterize; dispatch-ahead frames one behind)", flush=True)

        # ---- checkpoint and resume -------------------------------------------
        whole, first = renderer(), renderer()
        for _ in range(6):
            whole.draw_frame()
        for _ in range(3):
            first.draw_frame()
        path = os.path.join(work, "state.npz")
        ckpt.save_render_state(path, first.accum, cfg.seed, first._frame_index)
        resumed = renderer()
        resumed.accum, _, resumed._frame_index, _ = ckpt.load_render_state(path)
        for _ in range(3):
            resumed.draw_frame()
        torch.cuda.synchronize()
        check(resumed.accum.frame == 6 and torch.equal(resumed.accum.linear, whole.accum.linear),
              "resume: accumulator differs from 6 uninterrupted frames")
        print("  resume after 3 frames: accum.linear bit-equal to 6 uninterrupted frames",
              flush=True)

        # ---- native scene ------------------------------------------------------
        ns = NativeScene()
        ns.add_mesh_tri("default")
        ns.add_mesh_cube("cube")
        ns.add_mesh_uv_sphere("sphere", False, 32, 16)
        for name, mesh, (s, rot, t) in (
                ("ground", "sphere", (10.0, (math.pi / 2, 0.0, 0.0), (0.0, -10.0, 0.0))),
                ("sph", "sphere", (0.5, 0.0, (0.0, 0.5, 0.0))),
                ("wall", "cube", (1.0, 0.0, (1.0, 0.5, 0.0)))):
            check(ns.add_model(name, mesh), f"native scene: model {name}")
            ns.set_transforms(name, s, rot, t)
        nat = ns.build_packet(device=dev)
        for leaf in PACKET_LEAVES:
            a, b = getattr(nat, leaf), getattr(pkt, leaf)
            check(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b),
                  f"native packet: {leaf} differs")
        check(all(getattr(nat, c) == getattr(pkt, c) for c in PACKET_COUNTS),
              "native packet: counts differ")
        print(f"  NativeScene: the demo packet on {dev} equal to Scene.build_packet leaf for "
              "leaf", flush=True)

        # ---- the CLI -------------------------------------------------------------
        in_out = os.path.join(work, "cli_in")
        rk.launches = rast.launches = 0
        check(cli.main([*CLI_FRAMES, "--out", in_out]) == 0, "cli render: exit code")
        torch.cuda.synchronize()
        check((rk.launches, rast.launches) == (2, 2),
              f"cli render: (render, raster) launches {(rk.launches, rast.launches)}, "
              "expected 2 path-traced and 2 raster frames, one launch each")
        out, err = sub.communicate(timeout=300)
        check(sub.returncode == 0, f"cli render subprocess exited {sub.returncode}:\n{err}")
        names = sorted(os.listdir(sub_out))
        check(names == [f"frame_{i:05d}.npy" for i in range(4)], f"cli render wrote {names}")
        for n in names:
            check(np.array_equal(np.load(os.path.join(sub_out, n)),
                                 np.load(os.path.join(in_out, n))),
                  f"cli render: {n} differs from the engine's in this process")
        print("  cli render --frames 4 --toggle-every 2: subprocess exit 0, 4 frames equal "
              "to the engine's, one launch a frame (2 render, 2 hard raster)", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(["info"]) == 0, "cli info: exit code")
        info = json.loads(buf.getvalue())
        check(info["devices"][0] == torch.cuda.get_device_name(0) and info["backend"] == "cuda"
              and info["card"]["name"] in card, f"cli info: {info}")
        print(f"  cli info: {json.dumps(info)}", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(["bench"]) == 0, "cli bench: exit code")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(line["value"] > 0 and all(v > 0 for v in line["extra"].values())
              and line["device"]["name"] == torch.cuda.get_device_name(0),
              f"cli bench: {line}")
        print(f"  cli bench: {json.dumps(line)} [{card}]", flush=True)

        # ---- host ms/frame ------------------------------------------------------------
        def ms_per_frame(r):
            for _ in range(2):
                r.draw_frame()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ENGINE_TIMED):
                r.draw_frame()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / ENGINE_TIMED

        pt_async = ms_per_frame(renderer())
        pt_sync = ms_per_frame(renderer(present_async=False))
        raster = ms_per_frame(renderer(engine=engine.EngineKind.RASTERIZER))
        print(f"  Renderer.draw_frame {W}x{H}, host clock over {ENGINE_TIMED} frames: "
              f"path-traced {pt_async:.3f} ms/frame dispatch-ahead, {pt_sync:.3f} "
              f"synchronous; raster {raster:.3f} [{card}]", flush=True)
        device_share(renderer().draw_frame, ENGINE_TIMED,
                     f"Renderer.draw_frame path-traced {W}x{H} dispatch-ahead", card)
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.communicate()
        shutil.rmtree(work, ignore_errors=True)
    print(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)



# ---- phase 23: the sharded steps (`parallel/sharding.py`, `parallel/distributed.py`) ----

SHARD_W, SHARD_H, SHARD_RAGGED_H = 1920, 1080, 1078
SHARD_SEED = 23
SHARD_SPP, SHARD_STEPS = 4, 2  # render: 1 + 2 steps of spp 4
SHARED_WORLD, SHARED_MESH, RAGGED_MESH = 4, (2, 2), (4, 1)
SHARED_TRAIN_SPP = 2
# The sharded gradients against the one-process replay: d(table) and d(sky)
# are summed by atomics in no fixed order (the fused backward, the soft
# backward), so per leaf rtol 1e-5 with atol 1e-5 of the leaf's largest
# entry; images, losses aside, bit for bit.
SHARD_GRAD_RTOL = 1e-5


def shard_inputs(dev, height=SHARD_H):
    """The demo at SHARD_W x height, max_depth 5, its raster packet and
    config (ss 2, as `scripts/bench_dual.py`), and a target drawn from
    SHARD_SEED."""
    import numpy as np
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

    scn = demo.reference_demo_scene(32, 16)
    target = np.random.default_rng(SHARD_SEED).uniform(0.0, 0.5, (height, SHARD_W, 3))
    return (scn.build_packet(device=dev), scn.build_packet(spheres_as_triangles=True, device=dev),
            cam_ops.Camera.create(width=SHARD_W, height=height),
            RenderConfig(width=SHARD_W, height=height),
            RasterConfig(width=SHARD_W, height=height, supersample=2),
            torch.from_numpy(target.astype(np.float32)).to(dev))


def replay_render(pkt, cam, cfg, key, shape, spp, lin=None, frame=0, row_order="strided"):
    """`shard_render_step` of a (dp, sp) mesh in one process: every shard's
    running average over its samples from ``lin`` (the shard layout; zeros
    if None), then the sp mean. Returns the shard-layout image."""
    import torch

    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh

    dp, sp = shape
    rows = sh.padded_height(cam.height, dp) // dp
    dev = pkt.device
    full = torch.zeros((dp * rows, cam.width, 3), device=dev) if lin is None else lin
    out = torch.empty_like(full)
    with torch.no_grad():
        forward = sh._forward(pkt, cfg)
        for dp_i in range(dp):
            y0, stride = sh._row_start_stride(dp_i, rows, dp, row_order)
            parts = []
            for sp_i in range(sp):
                lkey = rng.fold(key, dp_i * 131071 + sp_i)
                acc, n = full[dp_i * rows:(dp_i + 1) * rows], frame
                for s in range(spp // sp):
                    n += 1
                    img = sh._sample_rows(rng.fold(rng.fold(lkey, s), n), pkt, cam, cfg, y0, rows,
                                          stride, forward).reshape(rows, cam.width, 3)
                    nf = torch.tensor(float(n), dtype=torch.float32, device=dev)
                    acc = img / nf + acc * ((nf - 1.0) / nf)
                parts.append(acc)
            mean = parts[0]
            for x in parts[1:]:
                mean = mean + x
            out[dp_i * rows:(dp_i + 1) * rows] = mean / sp if sp > 1 else mean
    return out


def replay_loss(pkt, cam, cfg, key, shape, spp, target, rpkt=None, rcfg=None,
                raster_weight=0.5, row_order="strided"):
    """(loss, grads) of `shard_train_step` (or, with ``rpkt``,
    `dual_train_step`) of a (dp, sp) mesh in one process: every shard's
    samples and soft raster rows in one autograd graph."""
    import dataclasses

    import torch

    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import rasterizer as ras

    dp, sp = shape
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in sh.differentiable_params(pkt, cam).items()}
    pk, cm = sh.apply_params(leaves, pkt, cam)
    forward = sh._forward(pk, cfg)
    rows = sh.padded_height(cam.height, dp) // dp
    tgt = sh.to_shard_order(target, dp, row_order)
    total = 0.0
    for dp_i in range(dp):
        y0, stride = sh._row_start_stride(dp_i, rows, dp, row_order)
        imgs = []
        for sp_i in range(sp):
            lkey = rng.fold(key, dp_i * 131071 + sp_i)
            acc = torch.zeros((rows, cam.width, 3), device=pkt.device)
            for s in range(spp // sp):
                acc = acc + sh._sample_rows(rng.fold(lkey, s), pk, cm, cfg, y0, rows, stride,
                                            forward).reshape(rows, cam.width, 3)
            imgs.append(acc / (spp // sp))
        ys = y0 + stride * torch.arange(rows, dtype=torch.float32, device=pkt.device)
        mask = (ys < cam.height).float()[:, None, None]
        t = tgt[dp_i * rows:(dp_i + 1) * rows]
        total = total + torch.sum(mask * (sum(imgs) / sp - t) ** 2)
        if rpkt is not None:
            rp = dataclasses.replace(rpkt, transforms=sh.raster_transforms(leaves, pkt, rpkt))
            rz = ras.raster_rows(rp, cm, rcfg, y0, rows, soft=True, stride=stride)
            total = total + raster_weight * torch.sum(mask * (rz - t) ** 2)
    loss = total / (cam.height * cam.width * 3)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def hold_grads(what, loss, grads, want_loss, want):
    """The sharded (loss, grads) against the replay's: loss rtol 1e-5,
    each leaf within SHARD_GRAD_RTOL; returns the largest error of a leaf
    relative to its largest entry."""
    import torch

    worst = 0.0
    check(abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss)),
          f"{what}: loss {float(loss)} against the replay's {float(want_loss)}")
    for k, w in want.items():
        g = grads[k]
        scale = max(float(w.abs().max()), 1e-30)
        err = (g - w).abs()
        check(bool(torch.isfinite(g).all()), f"{what}: d({k}) not finite")
        check(bool((err <= SHARD_GRAD_RTOL * w.abs() + SHARD_GRAD_RTOL * scale).all()),
              f"{what}: d({k}) differs from the replay's by {float(err.max())} "
              f"(largest entry {scale})")
        worst = max(worst, float(err.max()) / scale)
    return worst


def kernel_counts():
    """The launch counters of every kernel the sharded steps may run."""
    from ptre_tpu_torch.ops.cuda import fused_grad, raster_kernel, render_kernel, soft_raster
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import sweep_kernel

    return {"record": mk.record_launches, "fused_bwd": fused_grad.launches,
            "sweep": sweep_kernel.launches, "raster_hard": raster_kernel.launches,
            "soft_fwd": soft_raster.fwd_launches, "soft_bwd": soft_raster.bwd_launches,
            "render": render_kernel.launches}


def reset_kernel_counts():
    from ptre_tpu_torch.ops.cuda import fused_grad, raster_kernel, render_kernel, soft_raster
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import sweep_kernel

    mk.record_launches = fused_grad.launches = sweep_kernel.launches = 0
    raster_kernel.launches = soft_raster.fwd_launches = soft_raster.bwd_launches = 0
    render_kernel.launches = 0


def check_counts(what, want):
    """The counters since `reset_kernel_counts` equal ``want`` (kernels not
    named: 0): every sample went through its kernels, nothing else ran."""
    got = kernel_counts()
    full = {k: want.get(k, 0) for k in got}
    check(got == full, f"{what}: kernel launches {got}, expected {full}")
    return {k: v for k, v in got.items() if v}


def timed_steps(fn, steps):
    """Host ms per call of ``fn`` over ``steps`` calls after one warm-up,
    each window ending in a synchronize; returns (ms, the last result)."""
    import torch

    out = fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, steps + 1):
        out = fn(t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, out


def sharding_phase(dev, card):
    """Phase 23: the sharded steps at 1920x1080, max_depth 5 (raster ss 2).

    1. A world of one over NCCL in this process, mesh (1, 1): the packet
       replicated by broadcast; `shard_render_step` (spp 4, 1 + 2 steps) on
       the default route (record kernel) and on the staged route with a key
       (sweep kernel); `shard_train_step` (spp 1); `shard_raster_step` hard
       and soft; `dual_train_step` (spp 1). Launch counts per step; images
       bit-equal to the one-process replay, the hard raster to `rasterize`,
       gradients within SHARD_GRAD_RTOL; host ms/step.
    2. Four gloo ranks sharing the card (`shard_rank_main`, subprocesses,
       mesh (2, 2), every rank on cuda:0): render spp 4, train and dual spp
       2, and on a (4, 1) mesh at H = 1078 the render and the hard raster;
       each rank checks its launch counts, rank 0 holds the assembled
       results against the replay of all shards."""
    import torch
    import torch.distributed as dist

    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import rasterizer as ras

    t_phase = time.perf_counter()
    print(f"phase 23: sharded steps, demo at {SHARD_W}x{SHARD_H}, max_depth 5", flush=True)
    work = os.path.join(build.BUILD_DIR, f"shard.{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        mesh = sh.make_mesh((1, 1))
        print(f"  world of one: backend {dist.get_backend()}, device {sh.mesh_device(mesh)} "
              f"({torch.cuda.get_device_name(sh.mesh_device(mesh))})", flush=True)
        pkt, rpkt, cam, cfg, rcfg, target = shard_inputs(dev)
        pkt, rpkt = sh.replicate(mesh, pkt), sh.replicate(mesh, rpkt)
        staged = dataclasses.replace(cfg, grad_sweep="staged")
        key = rng.key_for(SHARD_SEED)
        times = {}

        for name, c, kernel, per in (("render", cfg, "record", 1),
                                     ("render staged", staged, "sweep", cfg.max_depth)):
            lin = torch.zeros((SHARD_H, SHARD_W, 3), device=dev)
            reset_kernel_counts()
            state = {"acc": pt.AccumState(lin, 0)}

            def render(t, c=c, state=state):
                state["acc"] = sh.shard_render_step(mesh, pkt, cam, state["acc"],
                                                    rng.fold(key, t), c, spp=SHARD_SPP)
                return state["acc"]

            times[name], acc = timed_steps(render, SHARD_STEPS)
            counts = check_counts(name, {kernel: per * SHARD_SPP * (SHARD_STEPS + 1)})
            want, frame = None, 0
            for t in range(SHARD_STEPS + 1):
                want = replay_render(pkt, cam, c, rng.fold(key, t), (1, 1), SHARD_SPP, want, frame)
                frame += SHARD_SPP
            torch.cuda.synchronize()
            check(acc.frame == frame and torch.equal(acc.linear, want),
                  f"{name}: the sharded image differs from the replay's")
            print(f"  {name}: spp {SHARD_SPP}, 1 + {SHARD_STEPS} steps, launches {counts}; "
                  "image bit-equal to the replay", flush=True)
            device_share(lambda c=c: sh.shard_render_step(mesh, pkt, cam, acc, key, c,
                                                          spp=SHARD_SPP), 2,
                         f"shard_render_step ({name}) spp {SHARD_SPP}", card)

        params = sh.differentiable_params(pkt, cam)
        reset_kernel_counts()
        times["train"], (loss, grads, _) = timed_steps(
            lambda t: sh.shard_train_step(mesh, params, pkt, cam, target, rng.fold(key, t), cfg),
            SHARD_STEPS)
        counts = check_counts("train", {"record": SHARD_STEPS + 1, "fused_bwd": SHARD_STEPS + 1})
        worst = hold_grads("train", loss, grads, *replay_loss(
            pkt, cam, cfg, rng.fold(key, SHARD_STEPS), (1, 1), 1, target))
        print(f"  shard_train_step spp 1: launches {counts} (1 + {SHARD_STEPS} steps); loss "
              f"{float(loss):.6f}, gradients within {worst:.2e} of each leaf's largest entry "
              "of the replay's", flush=True)
        device_share(lambda: sh.shard_train_step(mesh, params, pkt, cam, target, key, cfg), 2,
                     "shard_train_step spp 1", card)

        for soft in (False, True):
            name = "raster soft" if soft else "raster hard"
            reset_kernel_counts()
            times[name], img = timed_steps(
                lambda t, soft=soft: sh.shard_raster_step(mesh, rpkt, cam, rcfg, soft=soft),
                SHARD_STEPS)
            counts = check_counts(name, {"soft_fwd" if soft else "raster_hard": SHARD_STEPS + 1})
            with torch.no_grad():
                want = ras.rasterize(rpkt, cam, rcfg, soft=soft)
            torch.cuda.synchronize()
            check(torch.equal(img.detach(), want), f"{name}: differs from rasterize")
            print(f"  shard_raster_step {name[7:]}: launches {counts}; image bit-equal to "
                  "rasterize", flush=True)

        reset_kernel_counts()
        times["dual train"], (loss, grads) = timed_steps(
            lambda t: sh.dual_train_step(mesh, params, pkt, rpkt, cam, target, rng.fold(key, t),
                                         cfg, rcfg), SHARD_STEPS)
        n = SHARD_STEPS + 1
        counts = check_counts("dual train", {"record": n, "fused_bwd": n, "soft_fwd": n,
                                             "soft_bwd": n})
        worst = hold_grads("dual train", loss, grads, *replay_loss(
            pkt, cam, cfg, rng.fold(key, SHARD_STEPS), (1, 1), 1, target, rpkt, rcfg))
        check(float(grads["transforms"].abs().max()) > 0, "dual train: d(transforms) is zero")
        print(f"  dual_train_step spp 1: launches {counts}; gradients within {worst:.2e} of "
              "each leaf's largest entry of the replay's", flush=True)
        device_share(lambda: sh.dual_train_step(mesh, params, pkt, rpkt, cam, target, key, cfg,
                                                rcfg), 2, "dual_train_step spp 1", card)
        print("  world of one, host ms/step (1 warm-up, then " + str(SHARD_STEPS) + "): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" [{card}]", flush=True)
        dist.destroy_process_group()

        # part 2, after part 1's timings: the shared-card world's ranks
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r),
             str(SHARED_WORLD), f"file://{os.path.join(work, 'store')}", work], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, LOCAL_RANK=str(r))) for r in range(SHARED_WORLD)]
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
        for r, (p, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines():
                print(f"  [rank {r}] {line}", flush=True)
            check(p.returncode == 0, f"shared-card rank {r} exited {p.returncode}")
        with open(os.path.join(work, "shared.json")) as f:
            shared = json.load(f)
        print(f"  four gloo ranks on one card: {json.dumps(shared)} [{card}]", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        if dist.is_initialized():
            dist.destroy_process_group()
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    print(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


# Rematerialisation (phase 26). With remat_bounces (the default) mse_step and
# the sharded train step recompute each sample in the backward past spp 1,
# and the staged trace each bounce from its sweep's winners; without it they
# keep every residual. The same operations on the same inputs and draws: the
# loss and the camera's gradients (fed by d(o), d(d), deterministic) equal
# bit for bit; the table's and the sky's, which the fused backward sums by
# atomics in no fixed order (run to run 1.1e-7 to 1.6e-6, ROADMAP C2), within
# REMAT_GRAD_REL of each leaf's largest entry. Memory: the peak at the
# largest spp with remat within REMAT_PEAK_RATIO of spp 1's.
REMAT_DEMO_SPP = (1, 4, 16)
REMAT_STAGED_SPP = (1, 4)
REMAT_STAGED_DEEP = 12  # remat only: without it, ~12 times spp 1's residuals
REMAT_SHARD_SPP = (1, 4)
REMAT_PEAK_RATIO = 1.25
REMAT_GRAD_REL = 1e-5
REMAT_CAMERA_LEAVES = ("cam_position", "cam_forward", "cam_fov")


def hold_remat_grads(what, on, off):
    """Loss and the camera's gradients of ``on`` equal to ``off``'s bit for
    bit, the other leaves within REMAT_GRAD_REL of their largest entry;
    returns the largest such distance."""
    import torch

    (l_on, g_on), (l_off, g_off) = on, off
    check(float(l_on) == float(l_off), f"{what}: loss {float(l_on)} against {float(l_off)}")
    worst = 0.0
    for k, a in g_on.items():
        b = g_off[k]
        check(bool(torch.isfinite(a).all()), f"{what}: d({k}) not finite")
        if k in REMAT_CAMERA_LEAVES:
            check(torch.equal(a, b), f"{what}: d({k}) differs with remat")
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(rel <= REMAT_GRAD_REL, f"{what}: d({k}) {rel:.2e} of its largest entry apart")
        worst = max(worst, rel)
    return worst


def remat_phase(dev, card):
    """Phase 26: ``remat_bounces`` on and off, in turns, on the three cells
    whose memory grew with spp before the port rematerialised (module
    docstring, item 26)."""
    import torch
    import torch.distributed as dist

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import integrator, rng
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train
    from ptre_tpu_torch.utils.config import RenderConfig

    t_phase = time.perf_counter()
    W, H, B = W_MAIN, H_MAIN, 5
    R = W * H
    print(f"phase 26: rematerialisation at {W}x{H}, max_depth {B}: remat_bounces on and off "
          "in turns", flush=True)
    cam = cam_ops.Camera.create(width=W, height=H)
    target = torch.zeros((R, 3), device=dev)
    rows = []  # (cell, spp, remat, ms/step, peak GiB, launches)

    def cell(name, step, spp, remat, want, calls=3):
        """``calls`` steps (the first a warm-up, then the peak reset), the
        counts set to 0 just before and read just after: (host ms of a
        timed step, peak bytes, the last (loss, grads))."""
        reset_kernel_counts()
        out = step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for t in range(1, calls):
            out = step(t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (calls - 1)
        peak = torch.cuda.max_memory_allocated()
        got = check_counts(f"{name} spp {spp} remat {remat}",
                           {k: v * calls for k, v in want.items()})
        rows.append((name, spp, remat, ms, peak / 2**30, got))
        return ms, peak, out

    def drive(name, pkt, c, spps, want, calls=3, grad_spp=4, remat_only=()):
        """Each spp with remat on and off in turns (on alone at the spps in
        ``remat_only``); the gradients at ``grad_spp`` held on against off.
        Returns {(spp, remat): peak}."""
        params = sh.differentiable_params(pkt, cam)
        peaks, outs = {}, {}
        for spp in spps + remat_only:
            order = (True, False) if spp % 2 else (False, True)
            for remat in (True,) if spp in remat_only else order:
                cfg = dataclasses.replace(c, remat_bounces=remat)
                _, peaks[spp, remat], outs[spp, remat] = cell(
                    name, lambda t: train.mse_step(params, pkt, cam, target, cfg, 900 + t,
                                                   spp=spp),
                    spp, remat, want(spp, remat), calls)
        worst = hold_remat_grads(f"{name} spp {grad_spp}", outs[grad_spp, True],
                                 outs[grad_spp, False])
        print(f"  {name}: spp {grad_spp} gradients with remat on against off: loss and the "
              f"camera's bit for bit, the others within {worst:.2e} of their largest entry",
              flush=True)
        return peaks

    # ---- the demo, fused route: a record launch a sample, again past spp 1
    demo_pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
    fused = RenderConfig(width=W, height=H, max_depth=B)
    check(integrator.grad_route(fused, demo_pkt) == "fused", "the demo is not routed fused")
    peaks = drive("demo", demo_pkt, fused, REMAT_DEMO_SPP, lambda spp, remat: {
        "record": spp * (2 if remat and spp > 1 else 1), "fused_bwd": spp})
    big = REMAT_DEMO_SPP[-1]
    check(peaks[big, True] <= REMAT_PEAK_RATIO * peaks[1, True],
          f"demo: spp {big} peaks at {peaks[big, True]} B, spp 1 at {peaks[1, True]} B")
    params = sh.differentiable_params(demo_pkt, cam)
    for remat in (True, False):
        cfg = dataclasses.replace(fused, remat_bounces=remat)
        device_share(lambda: train.mse_step(params, demo_pkt, cam, target, cfg, 5, spp=4), 2,
                     f"demo mse_step spp 4 remat {remat}", card)
    sites = sync_sites(lambda: train.mse_step(params, demo_pkt, cam, target, fused, 6, spp=2))
    print(f"  demo mse_step spp 2 (remat): synchronizing calls {sites or 'none'}", flush=True)
    check(not sites, f"demo mse_step spp 2: synchronizing calls {sites}")
    del demo_pkt, params

    # ---- config 4, wavefront in record mode: the live count stays on the
    # card (the sort decision is taken there), forward and recompute alike
    name, (fn, kw), _, _ = TRI_CONFIGS[1]
    c4 = getattr(demo, fn)(**kw).build_packet(device=dev)
    c4_params = sh.differentiable_params(c4, cam)
    for remat in (True, False):
        cfg = dataclasses.replace(fused, remat_bounces=remat)
        train.mse_step(c4_params, c4, cam, target, cfg, 7, spp=2)
        sites = sync_sites(lambda: train.mse_step(c4_params, c4, cam, target, cfg, 8, spp=2))
        print(f"  {name} mse_step spp 2 remat {remat}: synchronizing calls {sites or 'none'}",
              flush=True)
        check(not sites, f"{name} mse_step spp 2 remat {remat}: synchronizing calls {sites}")
    del c4, c4_params
    torch.cuda.empty_cache()

    # ---- the 65,024-row mesh, staged route forced: sweeps once a bounce,
    # again only in a sample's recompute
    mesh_pkt = getattr(demo, STAGED_SCENE[0])(**STAGED_SCENE[1]).build_packet(device=dev)
    staged = dataclasses.replace(fused, grad_sweep="staged")
    check(integrator.grad_route(staged, mesh_pkt) == "staged", "the mesh is not routed staged")
    peaks = drive("staged mesh", mesh_pkt, staged, REMAT_STAGED_SPP,
                  lambda spp, remat: {"sweep": B * spp * (2 if remat and spp > 1 else 1)},
                  calls=2, remat_only=(REMAT_STAGED_DEEP,))
    check(peaks[1, True] < peaks[1, False],
          f"staged mesh spp 1: {peaks[1, True]} B with remat, {peaks[1, False]} B without")
    check(peaks[REMAT_STAGED_DEEP, True] <= REMAT_PEAK_RATIO * peaks[1, True],
          f"staged mesh: spp {REMAT_STAGED_DEEP} peaks at {peaks[REMAT_STAGED_DEEP, True]} B, "
          f"spp 1 at {peaks[1, True]} B")
    del mesh_pkt
    torch.cuda.empty_cache()

    # ---- the sharded train step, a world of one over NCCL
    try:
        mesh = sh.make_mesh((1, 1))
        pkt, _, scam, cfg, _, starget = shard_inputs(dev)
        pkt = sh.replicate(mesh, pkt)
        sparams = sh.differentiable_params(pkt, scam)
        key = rng.key_for(SHARD_SEED)
        peaks, outs = {}, {}
        for spp in REMAT_SHARD_SPP:
            for remat in ((True, False) if spp % 2 else (False, True)):
                c = dataclasses.replace(cfg, remat_bounces=remat)
                _, peaks[spp, remat], out = cell(
                    "shard_train_step", lambda t: sh.shard_train_step(
                        mesh, sparams, pkt, scam, starget, rng.fold(key, t), c, spp=spp),
                    spp, remat, {"record": spp * (2 if remat and spp > 1 else 1),
                                 "fused_bwd": spp})
                outs[spp, remat] = out[:2]
        big = REMAT_SHARD_SPP[-1]
        worst = hold_remat_grads(f"shard_train_step spp {big}", outs[big, True],
                                 outs[big, False])
        print(f"  shard_train_step: spp {big} gradients with remat on against off: loss and the "
              f"camera's bit for bit, the others within {worst:.2e}", flush=True)
        check(peaks[big, True] <= REMAT_PEAK_RATIO * peaks[1, True],
              f"shard_train_step: spp {big} peaks at {peaks[big, True]} B, spp 1 at "
              f"{peaks[1, True]} B")
        c = dataclasses.replace(cfg, remat_bounces=True)
        sites = sync_sites(lambda: sh.shard_train_step(mesh, sparams, pkt, scam, starget, key, c,
                                                       spp=2))
        print(f"  shard_train_step spp 2 (remat): synchronizing calls {sites or 'none'}",
              flush=True)
        check(not sites, f"shard_train_step spp 2: synchronizing calls {sites}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    print(f"  {'cell':<17} {'spp':>4} {'remat':>6} {'ms/step':>10} {'peak GiB':>9}  launches",
          flush=True)
    for name, spp, remat, ms, gib, got in rows:
        print(f"  {name:<17} {spp:>4} {str(remat):>6} {ms:>10.3f} {gib:>9.3f}  {got}",
              flush=True)
    print(f"  (host clock, one warm-up step then 2 timed, or 1 on the staged mesh; peak: "
          f"torch.cuda.max_memory_allocated over the timed steps) [{card}]", flush=True)
    print(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


def shard_rank_main(argv):
    """One rank of phase 23's shared-card world: ``chip_smoke.py
    --shard-rank <rank> <world> <init_method> <out_dir>``. Fails (non-zero
    exit) on any check; rank 0 writes ``shared.json`` to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import distributed
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import rasterizer as ras

    rank, world, init, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    t0 = time.perf_counter()
    distributed.initialize(init, world, rank, backend="gloo", timeout=600)
    mesh = sh.make_mesh(SHARED_MESH)
    dev = sh.mesh_device(mesh)
    print(f"backend {dist.get_backend()}, device {dev} ({torch.cuda.get_device_name(dev)}), "
          f"mesh coordinates {sh._coords(mesh)}", flush=True)
    pkt, rpkt, cam, cfg, rcfg, target = shard_inputs(dev)
    pkt = sh.replicate(mesh, pkt)  # broadcast of CUDA tensors over gloo
    key = rng.key_for(SHARD_SEED)
    dp, sp = SHARED_MESH
    local = {}

    reset_kernel_counts()
    zeros = sh.shard_rows(mesh, torch.zeros((SHARD_H, SHARD_W, 3)))
    acc = sh.shard_render_step(mesh, pkt, cam, pt.AccumState(zeros, 0), key, cfg, spp=SHARD_SPP)
    image = sh.gather_rows(mesh, acc.linear)
    torch.cuda.synchronize()
    local["render"] = check_counts("render", {"record": SHARD_SPP // sp})

    params = sh.differentiable_params(pkt, cam)
    tslab = sh.shard_rows(mesh, sh.to_shard_order(target, dp))
    reset_kernel_counts()
    loss, grads, _ = sh.shard_train_step(mesh, params, pkt, cam, tslab, key, cfg,
                                         spp=SHARED_TRAIN_SPP)
    torch.cuda.synchronize()
    per = SHARED_TRAIN_SPP // sp
    local["train"] = check_counts("train", {"record": per, "fused_bwd": per})
    reset_kernel_counts()
    dloss, dgrads = sh.dual_train_step(mesh, params, pkt, rpkt, cam, tslab, key, cfg, rcfg,
                                       spp=SHARED_TRAIN_SPP)
    torch.cuda.synchronize()
    local["dual"] = check_counts("dual", {"record": per, "fused_bwd": per, "soft_fwd": 1,
                                          "soft_bwd": 1})

    ragged = sh.make_mesh(RAGGED_MESH)
    rp_pkt, rr_pkt, r_cam, r_cfg, r_rcfg, _ = shard_inputs(dev, SHARD_RAGGED_H)
    hp = sh.padded_height(SHARD_RAGGED_H, RAGGED_MESH[0])
    reset_kernel_counts()
    racc = sh.shard_render_step(ragged, rp_pkt, r_cam, pt.AccumState(
        sh.shard_rows(ragged, torch.zeros((hp, SHARD_W, 3))), 0), key, r_cfg, spp=2)
    rimage = sh.gather_rows(ragged, racc.linear)
    rraster = sh.gather_rows(ragged, sh.shard_raster_step(ragged, rr_pkt, r_cam, r_rcfg))
    torch.cuda.synchronize()
    local["ragged"] = check_counts("ragged", {"record": 2, "raster_hard": 1})
    print(f"launches {json.dumps(local)}; steps took {time.perf_counter() - t0:.1f} s",
          flush=True)
    dist.destroy_process_group()
    if rank != 0:
        return

    result = {"ranks": world, "mesh": list(SHARED_MESH), "backend": "gloo",
              "device": str(dev), "launches_rank0": local}
    want = replay_render(pkt, cam, cfg, key, SHARED_MESH, SHARD_SPP)
    check(torch.equal(image, want), "shared card: render differs from the replay of all shards")
    result["render"] = "bit-equal to the replay"
    result["train_worst"] = hold_grads("shared card train", loss, grads, *replay_loss(
        pkt, cam, cfg, key, SHARED_MESH, SHARED_TRAIN_SPP, target))
    result["dual_worst"] = hold_grads("shared card dual", dloss, dgrads, *replay_loss(
        pkt, cam, cfg, key, SHARED_MESH, SHARED_TRAIN_SPP, target, rpkt, rcfg))
    want = replay_render(rp_pkt, r_cam, r_cfg, key, RAGGED_MESH, 2)
    check(torch.equal(rimage, want), "ragged: render differs from the replay of all shards")
    with torch.no_grad():
        whole = ras.rasterize(rr_pkt, r_cam, r_rcfg)
    got = sh.to_image_order(rraster, RAGGED_MESH[0], SHARD_RAGGED_H)
    check(got.shape == whole.shape and torch.equal(got, whole),
          "ragged: the hard raster shards differ from rasterize")
    result["ragged"] = f"H {SHARD_RAGGED_H} on {list(RAGGED_MESH)}: render bit-equal to the " \
                       "replay, hard raster to rasterize"
    with open(os.path.join(out_dir, "shared.json"), "w") as f:
        json.dump(result, f)


# ---- phase 27: the row gathers' backward (`ops/cuda/take_rows.py`) ----------------------

#: timed backward calls a site and side, each side twice (a, b, b, a)
TAKE_ROWS_REPS = 20


def device_events(fn, reps):
    """(device ms, device events) per call of ``fn`` by the profiler over
    ``reps`` calls, after one: the summed time of its kernels and
    memsets."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.time_range.end - e.time_range.start for e in dev)
    return us / 1e3 / reps, len(dev) / reps


def take_rows_sites(dev):
    """{site: (table as (N, F), idx (M,) int64)}: the differentiable gathers of
    a config-4 `mse_step` sample and of the dual step's raster packing at
    1920x1080, captured from the port's own calls, detached."""
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.models import scene as scene_mod
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import path_replay
    from ptre_tpu_torch.ops.cuda import fused_grad as fg
    from ptre_tpu_torch.ops.cuda import raster_kernel as rast
    from ptre_tpu_torch.ops.cuda import take_rows as tr
    from ptre_tpu_torch.render import rasterizer as ras
    from ptre_tpu_torch.utils.config import RasterConfig

    names = {scene_mod: ["drawcall transforms"], path_replay: ["triangle materials",
                                                                "sphere materials"],
             ras: ["raster transforms"], rast: ["raster permutation"]}
    sites = {}

    def recorder(mod):
        def take(table, idx):
            sites[names[mod][sum(n in sites for n in names[mod])]] = (
                table.detach().reshape(table.shape[0], -1).contiguous(),
                idx.long().contiguous())
            return tr.take_rows(table, idx)
        return take

    for mod in names:
        mod.take_rows = recorder(mod)
    try:
        pkt = demo.config4_mixed_scene(128, 64).build_packet(device=dev)
        rpkt = demo.config4_mixed_scene(128, 64).build_packet(spheres_as_triangles=True,
                                                              device=dev)
        cam = cam_ops.Camera.create(width=W_MAIN, height=H_MAIN, device=dev)
        table, T, _ = path_replay.build_table(pkt)
        rast.pack_raster_tris(rpkt, cam, RasterConfig(width=W_MAIN, height=H_MAIN,
                                                      supersample=2))
    finally:
        for mod in names:
            mod.take_rows = tr.take_rows
    perm = fg.prepare_forward(pkt).scene.perm_tri
    sites["Morton permutation"] = (table[:T].detach().contiguous(), perm.long().contiguous())
    return sites


def take_rows_launches(dev):
    """{step: kernel launches of the rows backward}: the counters from 0
    over one config-4 `mse_step` at spp 4 (the `mixed_mesh.train` cell's)
    and one `dual_train_step` at 1920x1080, each call counted as its
    instantiation launches (shared 2, global 3). A path-traced sample
    makes 3 shared calls (transforms, triangle and sphere materials) and 1
    global (the Morton permutation); the dual step adds the raster
    transforms (shared) and the raster permutation (global)."""
    import torch
    import torch.distributed as dist

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import take_rows as tr
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

    started = not dist.is_initialized()
    mesh = sh.make_mesh((1, 1))
    try:
        pkt = demo.config4_mixed_scene(128, 64).build_packet(device=dev)
        rpkt = demo.config4_mixed_scene(128, 64).build_packet(spheres_as_triangles=True,
                                                              device=dev)
        cam = cam_ops.Camera.create(width=W_MAIN, height=H_MAIN, device=dev)
        cfg = RenderConfig(width=W_MAIN, height=H_MAIN)
        rcfg = RasterConfig(width=W_MAIN, height=H_MAIN, supersample=2)
        target = torch.full((H_MAIN, W_MAIN, 3), 0.25, device=dev)
        params = sh.differentiable_params(pkt, cam)
        steps = {
            "mse_step": (lambda: train.mse_step(params, pkt, cam, target.reshape(-1, 3), cfg,
                                                seed=7, spp=4), (12, 4)),
            "dual_train_step": (lambda: sh.dual_train_step(mesh, params, pkt, rpkt, cam, target,
                                                           rng.key_for(7), cfg, rcfg), (4, 2)),
        }
        launched = {}
        for name, (step, want) in steps.items():
            tr.launches_shared = tr.launches_global = 0
            step()
            torch.cuda.synchronize()
            got = (tr.launches_shared, tr.launches_global)
            check(got == want, f"{name}: rows backward calls (shared, global) {got}, "
                               f"expected {want}")
            launched[name] = 2 * got[0] + 3 * got[1]
            print(f"  {name} at {W_MAIN}x{H_MAIN}: rows backward calls (shared, global) {got}, "
                  f"{launched[name]} launches", flush=True)
    finally:
        if started:
            dist.destroy_process_group()
    return launched


def take_rows_phase(dev, card):
    """Phase 27 (module docstring, item 27): per site the backward through
    `take_rows` in turns with ``table[idx]``'s, its error against float64,
    its bits across runs and its launches; the kernels' registers; a table
    and the kernel entry of the site that takes most time."""
    import torch

    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import take_rows as tr

    t_phase = time.perf_counter()
    print("phase 27: the row gathers' backward at config 4's shapes, take_rows in turns with "
          f"table[idx]'s [{card}]", flush=True)
    if build.last_build is not None:
        regs = [k for k in ptxas_summary(build.last_build[1]) if k.startswith("rows_")]
        print("  take_rows_kernel.cu: " + "; ".join(regs) + f" [{card}]", flush=True)
    else:
        print("  take_rows_kernel.cu: library not built in this run", flush=True)
    gen = torch.Generator(dev).manual_seed(27)
    rows, entries = [], []
    launched = take_rows_launches(dev)
    for site, (table, idx) in take_rows_sites(dev).items():
        (N, F), M = table.shape, idx.shape[0]
        kind = tr.instantiation(N, F, M, build.load_library().ptre_take_rows_max_cells())
        g = torch.randn((M, F), device=dev, generator=gen)
        ours, plain = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
        out_ours, out_plain = tr.take_rows(ours, idx), plain[idx]
        check(torch.equal(out_ours, out_plain), f"{site}: take_rows' forward differs")

        def backward(out, leaf):
            return lambda: torch.autograd.grad(out, leaf, g, retain_graph=True)[0]

        before = (tr.launches_shared, tr.launches_global)
        got = backward(out_ours, ours)()
        check((tr.launches_shared - before[0], tr.launches_global - before[1])
              == ((1, 0) if kind == "shared" else (0, 1)), f"{site}: launch counters")
        again = backward(out_ours, ours)()
        want64 = torch.zeros((N, F), dtype=torch.float64, device=dev).index_add_(
            0, idx, g.double())
        ref = backward(out_plain, plain)()
        want = want64.to(torch.float32).abs()
        ulp = (torch.nextafter(want, torch.full_like(want, math.inf)) - want).double()
        err = (got.double() - want64).abs()
        check(bool((err <= ulp).all()), f"{site}: beyond a float32 ulp of float64")
        if kind == "shared" or N == M:
            check(torch.equal(got, again), f"{site}: d(table) differs between runs")
        ref_err = float(((ref.double() - want64).abs() / ulp.clamp_min(1e-45)).max())
        sides = {"take_rows": backward(out_ours, ours), "table[idx]": backward(out_plain, plain)}
        times = in_turns(sides, TAKE_ROWS_REPS)
        dev_ms = {k: device_events(fn, TAKE_ROWS_REPS) for k, fn in sides.items()}
        nbytes = M * F * 4 + M * 8 + N * F * 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        dups = M - int(torch.unique(idx).numel())
        rows.append((site, N, F, M, dups, kind, times["take_rows"], times["table[idx]"],
                     dev_ms["take_rows"], dev_ms["table[idx]"], bound_ms,
                     float((err / ulp.clamp_min(1e-45)).max()), ref_err,
                     torch.equal(got, again)))
        entries.append(with_bound({
            "name": f"take_rows_bwd ({site})", "route": "cuda",
            "source": "ptre_tpu_torch/csrc/take_rows_kernel.cu",
            "replaces": "torch index_put_(accumulate=True), the backward of table[idx]",
            "launches": launched["mse_step"], "dual_launches": launched["dual_train_step"],
            "ms": dev_ms["take_rows"][0], "plain_ms": dev_ms["table[idx]"][0],
        }, nbytes, 0))
    print("  a call's time: CUDA events over calls in turns (host-paced for short calls), and "
          "the device time of its kernels by the profiler, with their count", flush=True)
    print(f"  {'site':<20} {'N':>5} {'F':>2} {'M':>5} {'dups':>5} {'inst':<6} "
          f"{'ours ms':>7} {'idx ms':>7} {'ours dev ms (n)':>16} {'idx dev ms (n)':>15} "
          f"{'bound ms':>8} {'ulps':>4} {'idx ulps':>8} same bits", flush=True)
    for r in rows:
        print(f"  {r[0]:<20} {r[1]:>5} {r[2]:>2} {r[3]:>5} {r[4]:>5} {r[5]:<6} "
              f"{r[6]:>7.4f} {r[7]:>7.4f} {r[8][0]:>12.5f} ({r[8][1]:g}) "
              f"{r[9][0]:>11.5f} ({r[9][1]:g}) {r[10]:>8.5f} {r[11]:>4.2f} {r[12]:>8.3g} "
              f"{r[13]}", flush=True)
    path = ("drawcall transforms", "triangle materials", "sphere materials",
            "Morton permutation")
    raster = ("raster transforms", "raster permutation")
    for what, names in (("a path-traced sample", path), ("the raster packing", raster)):
        ours = sum(r[8][0] for r in rows if r[0] in names)
        theirs = sum(r[9][0] for r in rows if r[0] in names)
        print(f"  {what}: device {ours:.4f} ms through take_rows against {theirs:.4f} ms "
              f"through table[idx]'s backward [{card}]", flush=True)
    print(f"phase 27 done in {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return max(entries, key=lambda e: e["plain_ms"])


def take_rows_main():
    """``python3 chip_smoke.py take_rows``: the kernel library and phase 27
    alone."""
    import torch

    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card, f"torch {torch.__version__}", flush=True)
    build.load_library()
    entry = take_rows_phase(dev, card)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"kind": torch.cuda.get_device_name(0)}}),
          flush=True)


def shortlists_main():
    """``python3 chip_smoke.py shortlists``: the kernel library, then the
    mask kernel writing the shortlists against the dense mask and the sort
    (`hold_lists`) at every live bounce past 0 of a 1080p sample of the
    4,080-leaf mesh and at bounce 1 of config 4's."""
    import torch

    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card, f"torch {torch.__version__}", flush=True)
    build.load_library()
    for name, mesh in (PAST_CAP_MESHES[1], (TRI_CONFIGS[1][0], TRI_CONFIGS[1][1])):
        _, _, scene, k, _, _, _, states = mask_states(dev, (name, mesh, W_MAIN, H_MAIN))
        print(f"shortlists: {name}, {scene.n_leaf} leaves at {W_MAIN}x{H_MAIN}", flush=True)
        for b, state, _ in states if scene.n_leaf > MASK_STAGED_LEAVES else states[:1]:
            hold_lists(f"{name} bounce {b}", state, scene, k,
                       wf.wave_mask(state, scene.boxes, k.t_min, supers=scene.mask_supers),
                       card)
    print(json.dumps({"ok": True, "device": {"kind": torch.cuda.get_device_name(0)}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_rank_main(sys.argv[2:])
    elif sys.argv[1:2] == ["take_rows"]:
        take_rows_main()
    elif sys.argv[1:2] == ["shortlists"]:
        shortlists_main()
    else:
        main()
