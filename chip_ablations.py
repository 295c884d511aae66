#!/usr/bin/env python3
"""Ablations of the hard raster kernel and the culled megakernel on one GPU.

    python3 chip_ablations.py

Not a gate: ``chip_smoke.py`` holds the shipped kernels to their plain
versions and first designs. This script measures what the designs' parts
cost. Each variant is a text edit of a copy of ``ptre_tpu_torch/csrc``
(under the git-ignored ``_build/``), built by its own nvcc process beside the
library and timed in turns (CUDA events, a, b, ..., b, a) with the shipped
build on the main path's inputs; a variant's output is compared with the
shipped kernel's first and must be equal, since none changes the
arithmetic.

Hard raster kernel, the demo scene at 1280x720 ss 2 (2560x1440 samples):
  * "staged": each visited chunk's 64 rows staged in shared memory, as the
    first design did, instead of read through L1/L2 (image equal);
  * "no visit": no chunk visited (every sample clear: the write floor);
  * "no shading": the winner's z written instead of its shaded colour;
  beside a ``fill_`` of the three planes.

Culled megakernel, BASELINE config 4 at 1920x1080 and config 3 at 512x512,
one recording sample of 5 bounces:
  * "per lane": every lane whose ray passes a leaf sweeps its 64 rows
    itself (wave.cuh sweep_leaf's loop) instead of the warp sweeping the
    passing rays one at a time, two rows a lane;
  * "spread <= n": the warp sweeps a leaf's passing rays only where at most
    n lanes pass it, else per lane;
  * blocks of 128 and 64 rays instead of 256 (the wrapper's ``lanes``).

Prints the card's name and power limit beside every time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

# mega_kernel.cu: the leaf loop's call of the warp sweep, and the per-lane
# sweep that replaces it in the "per lane" and "spread <= n" variants
WARP_CALL = """          if (passed != 0) {
            sweep_leaf_warp(rows + (int64_t)leaf * kLeafFloats, leaf, passed, r, wp, best);
          }"""
PER_LANE = """
__device__ __forceinline__ void sweep_leaf_lane(const float* rows, int leaf, const WaveRay& r,
                                                const WaveParams& p, TriBest& best) {
  for (int j = 0; j < kLeaf; ++j) {
    const float4* q = reinterpret_cast<const float4*>(rows + j * kRowStride);
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    const float row[kRowStride] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                   c.x, c.y, c.z, c.w};
    float t;
    if (!row_accepts(row, r.o, r.d, p.t_min, p.t_max, p.det_eps, &t)) continue;
    best.hit = true;
    if (t < best.t) {
      best.t = t;
      best.idx = leaf * kLeaf + j;
    }
  }
}

template <bool kRecord, bool kStats>
__global__"""
SPREAD_CALL = """          const float* leaf_rows = rows + (int64_t)leaf * kLeafFloats;
          if (passed != 0 && __popc(passed) <= SPREAD_MAX) {
            sweep_leaf_warp(leaf_rows, leaf, passed, r, wp, best);
          } else if (passed >> (threadIdx.x & 31) & 1u) {
            sweep_leaf_lane(leaf_rows, leaf, r, wp, best);
          }"""


def variant(build, unit, tag, edits, flags=()):
    """Start nvcc on a copy of csrc/ with ``edits`` ((old, new) pairs, each
    old text present) made to ``unit``."""
    src = os.path.join(build.BUILD_DIR, f"{tag}_src.{os.getpid()}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src, ignore=shutil.ignore_patterns("baseline"))
    path = os.path.join(src, unit)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        cs.check(old in text, f"{tag}: the edited text is not in {unit}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return cs.start_unit_build(unit, tag, flags, src)


def main():
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import raster_kernel as rast
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig
    from ptre_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card, flush=True)
    hard_v = {
        "staged": variant(build, "raster_kernel.cu", "staged", [
            ("  __shared__ GateBox s_box[kChunk];",
             "  __shared__ __align__(16) float s_rows[kChunk * kRow];\n"
             "  __shared__ GateBox s_box[kChunk];"),
            ("    if (mask != 0 && t.in) {\n      hard_sweep_gated(rows, s_box,",
             "    if (mask != 0) {  // block-uniform; the next gate's barrier guards s_rows\n"
             "      const float4* g = reinterpret_cast<const float4*>(rows);\n"
             "      float4* sh = reinterpret_cast<float4*>(s_rows);\n"
             "      for (int i = tid; i < kChunk * kRow / 4; i += kThreads) sh[i] = __ldg(g + i);\n"
             "      __syncthreads();\n"
             "    }\n"
             "    if (mask != 0 && t.in) {\n      hard_sweep_gated(s_rows, s_box,")]),
        "no visit": variant(build, "raster_kernel.cu", "novisit", [
            ("  for_each_chunk(p, cbox, t, tid, [&](int kc) {",
             "  if (p.n_chunks < 0) for_each_chunk(p, cbox, t, tid, [&](int kc) {")]),
        "no shading": variant(build, "raster_kernel.cu", "noshade", [
            ("shade_winner(tris + (int64_t)best_i * kRow, t.px, t.py, p.scal, rgb);",
             "rgb[0] = rgb[1] = rgb[2] = best_z;")]),
    }
    lane_edits = [("\ntemplate <bool kRecord, bool kStats>\n__global__", PER_LANE),
                  (WARP_CALL, SPREAD_CALL)]
    mega_v = {"per lane": variant(build, "mega_kernel.cu", "perlane", lane_edits,
                                  ("-DSPREAD_MAX=0",))}
    for n in (4, 8, 16):
        mega_v[f"spread <= {n}"] = variant(build, "mega_kernel.cu", f"spread{n}", lane_edits,
                                           (f"-DSPREAD_MAX={n}",))
    shipped = build.load_library()
    report = []
    hard_libs = {k: cs.finish_unit_build(b, report) for k, b in hard_v.items()}
    mega_libs = {k: cs.finish_unit_build(b, report) for k, b in mega_v.items()}
    print("variants: " + "; ".join(report) + f" [{card}]", flush=True)

    # ---- the hard raster kernel -------------------------------------------------
    W, H, ss = cs.RASTER_W, cs.RASTER_H, cs.RASTER_SS
    cfg = RasterConfig(width=W, height=H, supersample=ss)
    cam = cam_ops.Camera.create(width=W, height=H)
    pkt = demo.reference_demo_scene(32, 16).build_packet(spheres_as_triangles=True, device=dev)
    with torch.no_grad():
        tris, cbox = rast.pack_raster_tris(pkt, cam, cfg)
    scal = rast.raster_scalars(cfg)
    Hs, Ws = H * ss, W * ss
    p = rast.raster_params(scal, Hs, Ws, ss, cbox.shape[0])

    def hard_of(lib):
        lib.ptre_raster_hard.restype = ctypes.c_int
        lib.ptre_raster_hard.argtypes = shipped.ptre_raster_hard.argtypes

        def fn():
            out = torch.empty((3, Hs, Ws), dtype=torch.float32, device=dev)
            rc = lib.ptre_raster_hard(ctypes.addressof(p), tris.data_ptr(), cbox.data_ptr(),
                                      out.data_ptr(), None,
                                      torch.cuda.current_stream(dev).cuda_stream)
            cs.check(rc == 0, f"variant raster launch failed ({rc})")
            return out

        return fn

    fns = {"shipped": lambda: rast.raster_tiles(tris, cbox, scal, Hs, Ws, ss)}
    fns.update({k: hard_of(lib) for k, lib in hard_libs.items()})
    cs.check(torch.equal(fns["staged"](), fns["shipped"]()), "staged: another image")
    for _ in range(2):
        times = cs.in_turns(fns, 50)
        print(f"hard raster kernel, {Ws}x{Hs} samples, in turns: " + ", ".join(
            f"{k} {ms:.4f} ms" for k, ms in times.items()) + f" [{card}]", flush=True)
    planes = torch.empty((3, Hs, Ws), dtype=torch.float32, device=dev)
    fill_ms = cs.cuda_events(lambda: planes.fill_(0.5), 50)
    print(f"  fill_ of the (3, {Hs}, {Ws}) planes {fill_ms:.4f} ms [{card}]", flush=True)

    # ---- the culled megakernel -----------------------------------------------------
    def mega_of(lib):
        lib.ptre_trace_culled.restype = ctypes.c_int
        lib.ptre_trace_culled.argtypes = shipped.ptre_trace_culled.argtypes

        def fn(*args, **kw):
            load, count = build.load_library, mk.culled_launches
            mk.build.load_library = lambda: lib
            try:
                return mk.trace_culled(*args, **kw)
            finally:
                mk.build.load_library, mk.culled_launches = load, count

        return fn

    B = 5
    for name, (fn, kw), W, H in reversed(cs.TRI_CONFIGS):
        R = W * H
        k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=B))
        scene_pkt = getattr(demo, fn)(**kw).build_packet(device=dev)
        cam = cam_ops.Camera.create(width=W, height=H)
        scene = wf.prepare_scene(scene_pkt, screen_cam=cam)
        u = rng.ray_uniforms(cs.TRAIN_SEED, 0, R, 1, dev)
        o, d = (x.contiguous() for x in cam_ops.get_rays(cam, *pt.pixel_grid(H, W, dev),
                                                          (u - 0.5).T))
        fns = {"shipped": mk.trace_culled}
        fns.update({v: mega_of(lib) for v, lib in mega_libs.items()})
        want = mk.trace_culled(o, d, scene, k, B, cs.TRAIN_SEED, 0, record=True)
        for v, f in list(fns.items())[1:]:
            got = f(o, d, scene, k, B, cs.TRAIN_SEED, 0, record=True)
            cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                     f"{name} {v}: other colours or selections")
        for lanes in (128, 64):
            got = mk.trace_culled(o, d, scene, k, B, cs.TRAIN_SEED, 0, record=True, lanes=lanes)
            cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                     f"{name} lanes {lanes}: other colours or selections")
        timed = {v: (lambda f=f: f(o, d, scene, k, B, cs.TRAIN_SEED, 0, record=True))
                 for v, f in fns.items()}
        timed.update({f"blocks of {n}": (lambda n=n: mk.trace_culled(
            o, d, scene, k, B, cs.TRAIN_SEED, 0, record=True, lanes=n)) for n in (128, 64)})
        times = cs.in_turns(timed, 3)
        print(f"culled megakernel, {name} at {W}x{H}, one recording sample, in turns: "
              + ", ".join(f"{v} {ms:.4f} ms" for v, ms in times.items()) + f" [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
