#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ptre_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the kernels from ``ptre_tpu_torch/csrc`` with nvcc (one process per
source, all at once), then:

  1-5. holds the render kernel against its plain PyTorch version and drives
       the progressive main path — demo scene → ``render_step`` →
       ``to_display`` at 1920x1080 and 1280x720, spp 4 — checking that every
       sample went through the kernel;
  6-7. holds the recording forward and the fused backward kernels of the
       gradient path against their plain versions at 1920x1080;
  8.   drives the training main path — ``differentiable_params`` →
       ``mse_step`` at 1920x1080, spp 1 (1 + 8 steps) and one spp-64 step —
       checking that every sample went through both kernels, and that
       ``two_pass_mse_step`` equals ``mse_step`` at 320x180.

Any failed check raises and the script exits non-zero; it prints its result
lines only after every phase passed:

  * a JSON line ``{"kernels": [...]}``: per kernel its launches on its main
    path, its largest error against the plain version (for the gradient
    kernels outside the rays whose path flipped, which are counted and
    bounded on their own), and its and the plain version's time per call at
    the main path's shape;
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
# Gradient kernels vs plain versions (phases 6-7). The record kernel's color
# is unclamped (an emitter gives 10): TIGHT is relative above 1. The
# backward kernel recomputes the chain with FMAs, and float32 is too coarse
# for some rays: a ray whose path flips (a near/far root or the
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
    kernels = [{
        "name": "render_sample",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/render_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/render_kernel.py:79",
        "launches": launches,
        "max_abs_err": max(err_ext, err_philox),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    kernels += gradient_phases(dev, card, rs)

    # ---- 9. result -----------------------------------------------------------------
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def gradient_phases(dev, card, rs):
    """Phases 6-8: the recording and fused backward kernels against their
    plain versions, then the training step (`mse_step`) at 1920x1080.
    Returns the two kernels' entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from ptre_tpu.utils.config import RenderConfig
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import path_replay, rng
    from ptre_tpu_torch.ops.cuda import fused_grad as fg
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import train

    W, H, B = W_MAIN, H_MAIN, 5
    R = W * H
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.reference_demo_scene(32, 16).build_packet().to(dev)
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
        recorded[mode] = (sel, ur)

    # ---- 7. backward kernel vs its plain version ----------------------------------
    print(f"phase 7: fused backward kernel vs plain, {W}x{H}, same selections", flush=True)
    dcol = torch.from_numpy(rs.standard_normal((R, 3), dtype=np.float32)).to(dev)
    bwd_err = 0.0
    groups = {"v0-v2": slice(0, 9), "n0-n2": slice(9, 18), "center": slice(18, 21),
              "radius": slice(21, 22), "albedo": slice(23, 26), "param": slice(26, 27)}
    geometry = ("v0-v2", "n0-n2", "center", "radius")
    f64 = torch.float64
    for mode, (sel, ur) in recorded.items():
        ur64 = mk.trace_uniforms(o, B, GRAD_SEED, 0, ur).to(f64)

        def three(cot):
            """kernel, plain float32, plain float64 — the same inputs."""
            out = (fg.fused_bwd(table, sky6, o, d, sel, cot, k, B, T, GRAD_SEED, 0, ur),
                   fg.fused_bwd_reference(table, sky6, o, d, sel, cot, k, B, T,
                                          GRAD_SEED, 0, ur),
                   fg.fused_bwd_reference(table.to(f64), sky6.to(f64), o.to(f64),
                                          d.to(f64), sel, cot.to(f64), k, B, T,
                                          GRAD_SEED, 0, ur64))
            torch.cuda.synchronize()
            return out

        def flipped(a, b, mag):
            err = ((a[2].to(f64) - b[2].to(f64)).abs()
                   + (a[3].to(f64) - b[3].to(f64)).abs()).amax(dim=1)
            return err > FLIP_REL * mag + RAY_ATOL

        got, want, exact = three(dcol)
        mag = (exact[2].abs() + exact[3].abs()).amax(dim=1)
        flip_k, flip_p = flipped(got, want, mag), flipped(want, exact, mag)
        for name, a, b in (("d(o)", got[2], want[2]), ("d(d)", got[3], want[3])):
            top = float(b.abs().max())
            err = (a - b).abs()
            frac = float((err <= RAY_TIGHT * top).float().mean())
            bwd_err = max(bwd_err, float(err[~flip_k].max()))
            print(f"  {mode} {name}: max_abs_err {float(err.max()):.3e}, "
                  f"{float(err[~flip_k].max()):.3e} outside flipped rays (largest "
                  f"{top:.3e}); {100 * frac:.4f}% within {RAY_TIGHT:g} of the largest",
                  flush=True)
            check(bool(torch.isfinite(a).all()), f"bwd {mode}: non-finite {name}")
            check(frac >= TIGHT_FRAC, f"bwd {mode}: only {frac:.6f} of {name} within")
        allowed = math.ceil(BWD_FLIP_FRAC * R)
        print(f"  {mode}: {int(flip_k.sum())} rays flipped between kernel and plain "
              f"(allowed {allowed}); {int(flip_p.sum())} between plain float32 and "
              f"float64", flush=True)
        check(int(flip_k.sum()) <= allowed, f"bwd {mode}: {int(flip_k.sum())} flipped")
        # the summed gradients, without the flipped rays' cotangents
        got, want, exact = three(torch.where((flip_k | flip_p)[:, None], 0.0, dcol))
        named = [(n, sl) for n, sl in groups.items()] + [("sky", None)]
        for name, sl in named:
            a, b, e = ((x[1] if sl is None else x[0][:, sl]).to(f64)
                       for x in (got, want, exact))
            if float(e.norm()) == 0.0:  # no gradient reaches it (emissive cube)
                check(float(a.norm()) == 0.0, f"bwd {mode}: d(table) {name} not zero")
                continue
            rel_p = float((a - b).norm() / b.norm())
            rel_k64 = float((a - e).norm() / e.norm())
            rel_p64 = float((b - e).norm() / e.norm())
            bwd_err = max(bwd_err, float((a - b).abs().max()))
            print(f"  {mode} d({'sky' if sl is None else 'table ' + name}): relative L2 "
                  f"kernel-plain {rel_p:.3e}, kernel-float64 {rel_k64:.3e}, "
                  f"plain-float64 {rel_p64:.3e}", flush=True)
            if name in geometry:
                check(rel_k64 <= max(SUM_REL, GEOM_FACTOR * rel_p64),
                      f"bwd {mode}: d(table) {name} off float64 by {rel_k64}")
            else:
                check(rel_p <= SUM_REL, f"bwd {mode}: d({name}) relative L2 {rel_p}")
        check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
              f"bwd {mode}: non-finite d(table) or d(sky)")
        del got, want, exact

    # kernel times at the main shape (CUDA events) and the plain versions'
    def events(fn, reps):
        fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    sel_p, _ = recorded["philox"]
    rec_ms = events(lambda: mk.trace_fused_sel(o, d, scene, k, B, GRAD_SEED, 0), 20)
    bwd_ms = events(lambda: fg.fused_bwd(table, sky6, o, d, sel_p, dcol, k, B, T,
                                         GRAD_SEED, 0), 10)
    rec_plain_ms = events(lambda: mk.trace_record_reference(o, d, scene, k, B,
                                                            GRAD_SEED, 0), 2)
    bwd_plain_ms = events(lambda: fg.fused_bwd_reference(
        table, sky6, o, d, sel_p, dcol, k, B, T, GRAD_SEED, 0), 2)
    print(f"  record kernel {rec_ms:.4f} ms, plain {rec_plain_ms:.3f} ms; backward "
          f"kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.3f} ms (CUDA events, "
          f"{W}x{H}) [{card}]", flush=True)
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

    # the first spp-64 step grows the caching allocator by ~19 GiB (measured
    # 1.9 s against ~1.0 s for the next ones): one warm-up step first
    step(SPP_TRAIN, 299)
    mk.record_launches = fg.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss64, _ = step(SPP_TRAIN, 300)
    dt64 = time.perf_counter() - t0
    peak64 = torch.cuda.max_memory_allocated()
    check((mk.record_launches, fg.launches) == (SPP_TRAIN, SPP_TRAIN),
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

    return [{
        "name": "trace_record",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/record_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/megakernel.py:734",
        "launches": launches[0],
        "max_abs_err": rec_err,
        "ms": rec_ms,
        "plain_ms": rec_plain_ms,
    }, {
        "name": "fused_bwd",
        "route": "cuda",
        "source": "ptre_tpu_torch/csrc/fused_grad_kernel.cu",
        "replaces": "ptre_tpu/ops/pallas/fused_grad.py:112",
        "launches": launches[1],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }]


if __name__ == "__main__":
    main()
