#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ptre_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the render kernel from ``ptre_tpu_torch/csrc`` with nvcc, holds it
against its plain PyTorch version on the card, then drives the port's main
path — demo scene → ``render_step`` → ``to_display`` at 1920x1080, spp 4 —
and checks that every sample went through the kernel. Any failed check
raises and the script exits non-zero; it prints its result lines only after
every phase passed:

  * a JSON line ``{"kernels": [...]}``: per kernel its launches on the main
    path, its largest error against the plain version, and its and the
    plain version's time per call at the main path's shape;
  * last, ``{"ok": true, "device": {...}}``.

Every time printed is beside the card's name and power limit as
``nvidia-smi`` reports them. Imports nothing of JAX.
"""

from __future__ import annotations

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

    from ptre_tpu.utils.config import RenderConfig
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.models.scene import Scene
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import render_kernel as rk
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.device import require_cuda

    # ---- 1. environment ------------------------------------------------------
    dev = require_cuda()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(card, flush=True)
    print(f"torch {torch.__version__}, device {torch.cuda.get_device_name(dev)}, "
          f"torch.version.cuda {torch.version.cuda}", flush=True)
    print(sh([build.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    if build.last_build is not None:
        regs = [ln.strip() for ln in build.last_build[1].splitlines() if "registers" in ln]
        print(f"kernel build {build.last_build[0]:.2f} s (nvcc, sm_90a); "
              f"{'; '.join(regs)} [{card}]", flush=True)
    else:
        print(f"kernel library already built; load {build_s:.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def inputs(scene, W, H, max_depth=5, cam_kw=None):
        cfg = RenderConfig(width=W, height=H, max_depth=max_depth)
        packed = mk.pack_scene(scene.build_packet().to(dev))
        rows = rk.camera_rows(cam_ops.Camera.create(width=W, height=H, **(cam_kw or {})))
        return cfg, packed, rows

    def kernel_and_plain(prev, packed, rows, n, cfg, seed, urand):
        want = rk.sample_accum_reference(prev, packed, rows, n, cfg, seed, urand)
        got = prev.clone()
        rk.sample_accum(got, packed, rows, n, cfg, seed, urand)
        torch.cuda.synchronize()
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

    pkt_small = demo_scene.build_packet().to(dev)
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
        pkt = demo.reference_demo_scene(32, 16).build_packet().to(dev)
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
        return launches, dt, img

    def time_kernel(W, H, reps=20):
        """Kernel ms per sample (CUDA events over many launches)."""
        cfg, packed, rows = inputs(demo_scene, W, H)
        acc = torch.zeros((H, W, 3), device=dev)
        for i in range(3):
            rk.sample_accum(acc, packed, rows, i + 1, cfg, i)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(reps):
            rk.sample_accum(acc, packed, rows, 4 + i, cfg, 100 + i)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

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
        k_ms = time_kernel(W, H)
        p_ms = time_plain(W, H)
        p_mrays = W * H * 5 / (p_ms / 1e3) / 1e6
        results[(W, H)] = (launches, k_ms, p_ms)
        print(f"  render_step: {ms_step_sample:.4f} ms/sample, {mrays:.2f} Mrays/s "
              f"(W*H*spp*steps*max_depth/s, host clock) [{card}]", flush=True)
        print(f"  kernel alone: {k_ms:.4f} ms/sample (CUDA events) [{card}]", flush=True)
        print(f"  plain PyTorch on the card: {p_ms:.3f} ms/sample, {p_mrays:.2f} "
              f"Mrays/s [{card}]", flush=True)

    launches, k_ms, p_ms = results[(W_MAIN, H_MAIN)]
    print(json.dumps({"kernels": [{
        "name": "render_sample",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/render_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/render_kernel.py:79",
        "launches": launches,
        "max_abs_err": max(err_ext, err_philox),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
