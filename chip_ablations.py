#!/usr/bin/env python3
"""Ablations of the hard raster kernel, the culled megakernel, the replay
pair, the mask kernel, the material select and the bounce kernel's sweep
on one GPU.

    python3 chip_ablations.py [raster_mega] [replay] [mask] [materials] [bounce] [present]
                              [culled_flips] [syncs [--root DIR]]
    (no argument: raster_mega and replay)

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

Replay pair, the demo scene at 1920x1080, max_depth 5 and 8, the
recording kernel's selections of one Philox sample (chip_smoke.py phase
21's):
  * "forward floor": the forward's chain step replaced by its loads alone
    (the selection and the columns the chain reads of a hit's row, summed;
    the same bounces entered), beside the bytes of the 32-byte sectors
    the forward touches against those its bound counts (the colour is not
    the shipped one; the backward is unchanged and must equal it);
  * "slab rows": each bounce's 32 rows staged by the warp as a slab of
    float4s in shared memory, where a lane needs one, instead of read as
    each lane's own columns;
  * "staged rays": o, d, d(colour) read and the colour, d(o), d(d) written
    as a warp's 384 contiguous bytes through shared memory instead of by
    each lane;
  * "no dead tails": every bounce run, dead lanes or not (no vote);
  * "scalar slabs": d(g) written by coalesced scalar stores from the slice
    instead of float4s;
  * "16 warps": the backward's launch bounds ask for 4 blocks of 128
    threads an SM instead of 3 (128 registers, with spills);
  * "forward 7 blocks", "forward 10 blocks": the forward's launch bounds
    without a minimum (7 blocks an SM) or asking for 10, instead of 8;
  * "8 warps": the backward's launch bounds ask for 2 blocks an SM;
  * "with FMA": the unit built with FMA contraction (not shipped: its
    colour is read against the plain version, not held);
  beside the first design (``csrc/baseline/replay_pair/``), with the
  shipped kernels' registers, shared memory and blocks an SM.

Mask kernel ("mask"), its global instantiation (past 1,024 leaves) on
every live bounce after the first of one 1920x1080 sample of BASELINE
config 3's uv-sphere at 320x128 and 512x256 segments (1,270 and 4,080
leaves; chip_smoke.py's `mask_states`):
  * "dynamic shared": every block stages the leaf boxes and the supertile
    boxes into dynamic shared memory (sized by n_leaf, opted in past 48 KB)
    before the walk, instead of reading them through L1/L2 (verdicts equal).

Material tables ("materials"): the render, record, wave and culled units
as shipped, which read a hit's material row by index (the render, record
and culled kernels from the table in place, the wave kernel from a copy in
shared memory up to 8 materials), against the parent's units (variants of
the shipped sources: the row scan of megakernel.py:625-631 in place of
trace.cuh material_row, and the (8, 8) table staged by every block), on
<= 8 materials: the demo at 1920x1080 (render kernel, spp 4's sample, and
the recording kernel), BASELINE config 4 at 1920x1080 (the bounce kernel at
bounces 1-4 of one sample, the culled megakernel recording one sample).
Beside them, at each bounce, the wave kernel "in place" (no table staged,
also timed against the shipped one in 10 pairs) and the shipped wave unit
under launch bounds of "5 blocks an SM" (at most 51 registers: the parent's
occupancy, so the select is told from the register budget); and the SASS
of the shipped wave kernel against each of those builds (instructions by
opcode, cuobjdump). Then, on config 4 with
300 distinct materials (`chip_smoke.many_materials_scene`), the table read
in place against the variant "dynamic shared": every block stages the
whole table (num_mats x 32 B) in dynamic shared memory; bounce kernel at
bounces 1-4 and culled megakernel. Every output equal bit for bit.

Bounce kernel ("bounce"): the wavefront's bounce kernel (`csrc/
wave_kernel.cu`: the warp sweeps a leaf's passing rays one at a time, each
lane's two rows loaded once a visit through L1/L2, the (t, row) minimum by a
REDUX of order keys and two ballots, `wave.cuh sweep_leaf_warp`) at every
bounce of one 1920x1080 sample of BASELINE config 4 (the screen-binned
bounce 0 and the masked bounces 1-4, chip_smoke.py's `mask_states`) and at
bounce 1 of the 65,024-row and 4,080-leaf meshes, both instantiations, with
the counting instantiation's counters, against:
  * "per lane, staged": the unit shipped before it (``csrc/baseline/
    wave_lane/``: each passing ray sweeps the leaf on its own lane, rows
    staged in shared memory by cp.async, a block barrier a leaf);
  * "spread, staged": that unit with the warp sweep reading the staged rows
    in place of the per-lane sweep;
  * "fallback >= n" for n in 8, 16, 24: a (warp, leaf) visit that n or more
    lanes pass swept per lane (each lane its own ray, the rows through
    L1/L2) instead of by the warp;
  * "rows a ray": the lane's rows loaded for every ray swept;
  * "butterfly": the (t, row) minimum by five shuffle steps;
  * "rows a ray, butterfly": both (the culled megakernel's sweep before);
timed in turns (CUDA events), next states and selections bit for bit the
shipped kernel's, with each build's registers, spills and shared memory
(ptxas) and SASS instruction counts (`sass_counts`); and the culled
megakernel (one recording sample of config 4) with the three sweep
variants, colours and selections bit for bit.

Culled megakernel flips ("culled_flips", no variant built): the four cases
of the card test ``test_culled_megakernel_matches_plain_version`` (culling
on and off, external uniforms and in-kernel Philox; BASELINE config 4's
mesh at 64x32 segments, 256x128 rays, max_depth 4, recording) over seeds
0-199: the seed of a ``torch.Generator`` on the card that draws the external
uniforms, or the kernel's Philox seed in place of the test's 9. For each
seed the rays flipped (colour beyond 1e-4 relative or any selection
differing) between the kernel and its plain version and between the culled
kernel and the wavefront's kernels on the same rays and draws, and for each
flipped ray the first bounce whose selection differs, the kinds of hit on
both sides (triangle, sphere with its radius, miss) and the kind of the
bounce before it; whether three launches of the kernel are bit-equal. The
sweep runs in a fresh process, then again after the card suite
(``tests/test_torch_cuda.py -m cuda``) has run in the same process, and
every output of the two sweeps is compared bit for bit; last, 200 unseeded
draws of the default generator after the suite, culling off, external
uniforms, as the test drew before it was seeded.

Presentation ("present", no variant built): `Renderer.draw_frame`'s
path-traced frames with ``present_async`` on and off, timed in turns on the
host clock at 1280x720 spp 1, 1920x1080 spp 1 and 1920x1080 spp 4, with
each mode's device-busy time a frame.

Host round trips ("syncs", no variant built): one call each of the paths
that should make no synchronizing call, with every camera left at its
default device: a dense `render_step` (the demo at 1920x1080, spp 4, keyed
as the engine keys its frames), a dispatch-ahead `Renderer.draw_frame`
(1280x720, spp 1), `shard_render_step` on a world of one over NCCL (the demo
at 1920x1080, spp 4), `rasterize` hard and soft (1280x720 ss 2, no graph),
`raster_mse_step`, the dense `mse_step` (1920x1080, spp 1),
`shard_train_step` and `dual_train_step` (1920x1080, spp 1). For each, the
synchronizing calls of one call under torch's CUDA sync debug mode, by the
line of the port that made them (`chip_smoke.sync_sites`), host ms a call
over five windows without the profiler (the calls queued, then each call
followed by a synchronize), then the profile of a few calls
(`chip_smoke.device_share`: host and device ms a call, idle share,
synchronizes, event waits and copies a call). ``--root
DIR`` imports ``ptre_tpu_torch`` from DIR instead (a checkout of another
commit, unpacked in a git-ignored directory): the same calls, so two
commits are compared in one machine. Then, sites only, the routes that keep
data-dependent reads: config 4 `render_step` and `mse_step` (the
wavefront) and the demo's `mse_step` on the replay route.

Prints the card's name and power limit beside every time.
"""

from __future__ import annotations

import ctypes
import math
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


def variant(build, unit, tag, edits, flags=(), base=None):
    """Start nvcc on ``unit`` of a copy of csrc/ with ``edits`` made: (old,
    new) pairs, each old text present, to ``unit``, or {file: pairs} to the
    files named (the unit or its headers). ``base``: a file of csrc/ copied
    over ``unit`` first (a frozen unit built against the shipped headers)."""
    src = os.path.join(build.BUILD_DIR, f"{tag}_src.{os.getpid()}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src, ignore=shutil.ignore_patterns("baseline"))
    if base is not None:
        shutil.copy(os.path.join(build.CSRC_DIR, base), os.path.join(src, unit))
    for name, pairs in (edits if isinstance(edits, dict) else {unit: edits}).items():
        path = os.path.join(src, name)
        with open(path) as f:
            text = f.read()
        for old, new in pairs:
            cs.check(old in text, f"{tag}: the edited text is not in {name}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return cs.start_unit_build(unit, tag, flags, src)


def main():
    args = sys.argv[1:]
    if "--root" in args:
        i = args.index("--root")
        sys.path.insert(0, os.path.abspath(args[i + 1]))
        del args[i:i + 2]
    from ptre_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card, flush=True)
    parts = args or ["raster_mega", "replay"]
    for part in parts:
        cs.check(part in ("raster_mega", "replay", "mask", "materials", "bounce",
                          "culled_flips", "present", "syncs"), f"unknown part {part}")
    if "raster_mega" in parts:
        raster_mega(dev, card)
    if "replay" in parts:
        replay(dev, card)
    if "mask" in parts:
        mask(dev, card)
    if "materials" in parts:
        materials(dev, card)
    if "bounce" in parts:
        bounce(dev, card)
    if "present" in parts:
        present(dev, card)
    if "culled_flips" in parts:
        culled_flips(dev, card)
    if "syncs" in parts:
        syncs(dev, card)


# mask_kernel.cu: the global instantiation's walk on boxes in global memory,
# and the boxes staged in dynamic shared memory that replace it
MASK_GLOBAL_WALK = """  extern __shared__ unsigned s_words[];"""
MASK_DYN_DECL = """  extern __shared__ __align__(16) unsigned s_words[];"""
MASK_GLOBAL_CALL = """  for (int i = tid; i < n_words; i += blockDim.x) s_words[i] = 0u;
  __syncthreads();

  mask_walk<kStats>(p, n_super, boxes, supers, s_words, live, o, dir, stats);"""
MASK_DYN_CALL = """  float* s_box = reinterpret_cast<float*>(s_words + ((n_words + 3) & ~3));
  float* s_sup = s_box + (size_t)p.n_leaf * kBoxStride;
  for (int i = tid; i < n_words; i += blockDim.x) s_words[i] = 0u;
  for (int i = tid; i < p.n_leaf * kBoxStride; i += blockDim.x) s_box[i] = boxes[i];
  for (int i = tid; i < n_super * kBoxStride; i += blockDim.x) s_sup[i] = supers[i];
  __syncthreads();

  mask_walk<kStats>(p, n_super, s_box, s_sup, s_words, live, o, dir, stats);"""
MASK_GLOBAL_BYTES = """  const size_t bytes = sizeof(unsigned) * (size_t)((p.n_leaf + 31) / 32);"""
MASK_DYN_BYTES = """  const size_t bytes = sizeof(unsigned) * (size_t)((((p.n_leaf + 31) / 32) + 3) & ~3) +
                       sizeof(float) * kBoxStride *
                           (size_t)(p.n_leaf + (p.n_leaf + kSuper - 1) / kSuper);"""
MASK_MESHES = (
    ("1,270 leaves", ("config3_scene", dict(flat=False, segments=320, rings=128, diffuse=True)),
     cs.W_MAIN, cs.H_MAIN),
    ("4,080 leaves", ("config3_scene", dict(flat=False, segments=512, rings=256, diffuse=True)),
     cs.W_MAIN, cs.H_MAIN),
)


def mask(dev, card):
    """The mask's global instantiation against the variant whose blocks stage
    the boxes in dynamic shared memory, verdicts compared, timed in turns."""
    import torch

    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import wavefront as wf

    dyn = variant(build, "mask_kernel.cu", "maskdyn", [
        (MASK_GLOBAL_WALK, MASK_DYN_DECL), (MASK_GLOBAL_CALL, MASK_DYN_CALL),
        (MASK_GLOBAL_BYTES, MASK_DYN_BYTES)])
    shipped = build.load_library()
    report = []
    lib = cs.finish_unit_build(dyn, report)
    print("variant: " + "; ".join(x for x in report if "global" in x) + f" [{card}]",
          flush=True)
    lib.ptre_wave_mask.restype = ctypes.c_int
    lib.ptre_wave_mask.argtypes = shipped.ptre_wave_mask.argtypes

    def staged_in_shared(state, scene, t_min):
        r_pad = state.shape[1]
        out = torch.empty((r_pad // wf.LANES, scene.n_leaf), dtype=torch.bool, device=dev)
        p = wf.MaskParams(t_min=mk.f32(t_min), r_pad=r_pad, n_leaf=scene.n_leaf)
        rc = lib.ptre_wave_mask(ctypes.addressof(p), state.data_ptr(), scene.boxes.data_ptr(),
                                scene.mask_supers.data_ptr(), out.data_ptr(), None, wf.LANES,
                                torch.cuda.current_stream(dev).cuda_stream)
        cs.check(rc == 0, f"dynamic shared variant: launch failed ({rc})")
        return out

    for config in MASK_MESHES:
        name = config[0]
        _, _, scene, k, _, _, _, states = cs.mask_states(dev, config)
        for b, state, _ in states:
            got = wf.wave_mask(state, scene.boxes, k.t_min, supers=scene.mask_supers)
            cs.check(torch.equal(staged_in_shared(state, scene, k.t_min), got),
                     f"{name} bounce {b}: the variant's verdicts differ")
            times = cs.in_turns({
                "shipped": lambda: wf.wave_mask(state, scene.boxes, k.t_min,
                                                supers=scene.mask_supers),
                "dynamic shared": lambda: staged_in_shared(state, scene, k.t_min)}, 10)
            print(f"  mask, {name}, bounce {b} ({int((state[9] > 0.5).sum())} live rays): "
                  + ", ".join(f"{label} {ms:.4f} ms" for label, ms in times.items())
                  + f" (CUDA events, in turns; verdicts equal) [{card}]", flush=True)
        del states


# trace.cuh's select by index, and the parent's scan over every row
MATS_INDEXED = """  const int m = material_row(mat_id, sc.num_mats);
  if (m >= 0) {
    const float* row = sc.mats + m * kMatStride;
    m_kind = row[0];
    m_ar = row[1];
    m_ag = row[2];
    m_ab = row[3];
    m_param = row[4];
  }"""
MATS_SCAN = """  for (int m = 0; m < sc.num_mats; ++m) {
    if (fabsf(mat_id - (float)m) < 0.5f) {
      const float* row = sc.mats + m * kMatStride;
      m_kind = row[0];
      m_ar = row[1];
      m_ag = row[2];
      m_ab = row[3];
      m_param = row[4];
    }
  }"""
MATS_SKY = "  __shared__ float s_sky[8];\n"
MATS_DECL = "  __shared__ float s_mat[kStagedMats * kMatStride];\n" + MATS_SKY
MATS_DYN_DECL = "  extern __shared__ float s_mat[];  // max(num_mats, kStagedMats) rows\n" + MATS_SKY
MATS_DENSE_SKY = "  if (tid < 8) s_sky[tid] = tab.sky[tid];"
MATS_BLOCK_SKY = "  if (tid < 8) s_sky[tid] = sky[tid];"
MATS_COPY = "  for (int i = tid; i < {n} * kMatStride; i += {step}) s_mat[i] = {src}[i];\n"
MATS_N = "(p.w.num_mats > kStagedMats ? p.w.num_mats : kStagedMats)"
#: the parent's units: the scan, and the (8, 8) table staged by every block
MATS_PARENT = {
    "render_kernel.cu": {"trace.cuh": [
        (MATS_INDEXED, MATS_SCAN), (MATS_SKY, MATS_DECL),
        (MATS_DENSE_SKY, MATS_COPY.format(n="kStagedMats", step="kDenseWarps * kLanes",
                                          src="tab.mats") + MATS_DENSE_SKY),
        ("{nullptr, s_sph, tab.mats, s_sky", "{nullptr, s_sph, s_mat, s_sky")]},
    "wave_kernel.cu": {"trace.cuh": [(MATS_INDEXED, MATS_SCAN)], "wave_kernel.cu": [
        ("  const bool staged = p.num_mats <= kStagedMats;", "  const bool staged = true;")]},
    "mega_kernel.cu": {"trace.cuh": [(MATS_INDEXED, MATS_SCAN)], "mega_kernel.cu": [
        (MATS_SKY, MATS_DECL),
        (MATS_BLOCK_SKY, MATS_COPY.format(n="kStagedMats", step="blockDim.x", src="mats")
         + MATS_BLOCK_SKY),
        ("{tris, sphs, mats, s_sky", "{tris, sphs, s_mat, s_sky")]},
}
MATS_PARENT["record_kernel.cu"] = MATS_PARENT["render_kernel.cu"]
#: the wave kernel reading even a table of <= 8 rows in place
MATS_WAVE_IN_PLACE = [("  const bool staged = p.num_mats <= kStagedMats;",
                       "  const bool staged = false;")]
#: the wave and culled kernels staging the whole table in dynamic shared
#: memory, whatever its size
MATS_DYN = {
    "wave_kernel.cu": [
        ("  __shared__ float s_mat[kStagedMats * kMatStride];", MATS_DYN_DECL.splitlines()[0]),
        ("""  const bool staged = p.num_mats <= kStagedMats;  // else read in place
  if (staged) {
    for (int i = tid; i < kStagedMats * kMatStride; i += blockDim.x) s_mat[i] = mats[i];
  }""", "  const bool staged = true;\n"
         + MATS_COPY.format(n=MATS_N.replace("p.w.", "p."), step="blockDim.x", src="mats")),
        ("<<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>",
         "<<<p.r_pad / lanes, lanes, sizeof(float) * ptre::kMatStride * "
         + MATS_N.replace("p.w.", "p.").replace("kStagedMats", "ptre::kStagedMats")
         + ", (cudaStream_t)stream>>>")],
    "mega_kernel.cu": [
        (MATS_SKY, MATS_DYN_DECL),
        (MATS_BLOCK_SKY, MATS_COPY.format(n=MATS_N, step="blockDim.x", src="mats")
         + MATS_BLOCK_SKY),
        ("{tris, sphs, mats, s_sky", "{tris, sphs, s_mat, s_sky"),
        ("<<<n_blocks, lanes, 0, st>>>",
         f"<<<n_blocks, lanes, sizeof(float) * kMatStride * {MATS_N}, st>>>")],
}
MATS_UNITS = {"render_kernel.cu": "ptre_render_sample", "record_kernel.cu": "ptre_trace_record",
              "wave_kernel.cu": "ptre_wave_bounce", "mega_kernel.cu": "ptre_trace_culled"}
#: blocks of 256 an SM that the parent's wave kernel (48 registers) runs;
#: the shipped kernel under these launch bounds tells the select from the
#: register budget and occupancy
MATS_WAVE_BLOCKS = 5
MATS_PAIRS = 10


def sass_counts(lib_path, kernel):
    """{function: {opcode: count}} of the SASS of every function of the
    library whose name holds ``kernel`` (cuobjdump, predicates and
    modifiers dropped)."""
    import collections
    import re

    from ptre_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = cs.sh([tool, "-sass", lib_path])
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            if kernel in name:
                out[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and name in out:
            out[name][m.group(1)] += 1
    return out


def sass_report(label, shipped, other):
    """One line a function: instructions in ``shipped`` and ``other``
    (`sass_counts`) and the opcodes whose counts differ."""
    for name in sorted(shipped):
        a, b = shipped[name], other.get(name, {})
        diff = {op: (a.get(op, 0), b.get(op, 0)) for op in sorted(set(a) | set(b))
                if a.get(op, 0) != b.get(op, 0)}
        print(f"  SASS {name}: shipped {sum(a.values())} instructions, {label} "
              f"{sum(b.values())}; opcodes differing (shipped, {label}): {diff}", flush=True)


def materials(dev, card):
    """The four units against the parent's on <= 8 materials, the wave
    kernel's staged table against the table read in place, and the table
    read in place against the table staged in dynamic shared memory on 300
    materials; outputs compared bit for bit, timed in turns (CUDA events)."""
    import numpy as np
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import render_kernel as rk
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.config import RenderConfig

    parent_b = {u: variant(build, u, f"matsparent_{u[:4]}", e, build.UNIT_FLAGS.get(u, ()))
                for u, e in MATS_PARENT.items()}
    dyn_b = {u: variant(build, u, f"matsdyn_{u[:4]}", e) for u, e in MATS_DYN.items()}
    wave_b = {"in place": variant(build, "wave_kernel.cu", "matsinplace", MATS_WAVE_IN_PLACE),
              f"{MATS_WAVE_BLOCKS} blocks an SM": variant(
                  build, "wave_kernel.cu", "matsblocks", [
                      ("__launch_bounds__(kMaxLanes)",
                       f"__launch_bounds__(kMaxLanes, {MATS_WAVE_BLOCKS})")])}
    shipped = build.load_library()
    if build.last_build is not None:
        print("shipped: " + "; ".join(x for x in cs.ptxas_summary(build.last_build[1])
                                      if any(k in x for k in ("dense", "wave_bounce", "mega")))
              + f" [{card}]", flush=True)
    libs = {}
    for what, builds in (("parent's units", parent_b), ("dynamic shared variants", dyn_b),
                         ("wave variants", wave_b)):
        report = []
        libs[what] = {u: cs.finish_unit_build(b, report) for u, b in builds.items()}
        print(f"{what}: " + "; ".join(report) + f" [{card}]", flush=True)
    parent, dyn, wave_v = (libs[w] for w in ("parent's units", "dynamic shared variants",
                                             "wave variants"))
    for table in (parent, dyn, wave_v):
        for u, lib in table.items():
            fn = MATS_UNITS.get(u, "ptre_wave_bounce")
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes

    def through(lib, call):
        """``call()`` with every wrapper launching from ``lib``; counts
        restored."""
        def fn():
            load = build.load_library
            counts = (rk.launches, mk.record_launches, wf.bounce_launches, mk.culled_launches)
            build.load_library = lambda: lib
            try:
                return call()
            finally:
                build.load_library = load
                (rk.launches, mk.record_launches, wf.bounce_launches,
                 mk.culled_launches) = counts
        return fn

    def differ(a, b):
        """Rays (or pixels, or state columns) on which two outputs differ."""
        if a.dim() == 3:
            return int((a != b).any(dim=-1).sum())
        return int((a != b).any(dim=0 if a.shape[0] in (wf.STATE_ROWS, 5) else 1).sum())

    def turns(what, fns, reps, n):
        outs = {label: f() for label, f in fns.items()}
        torch.cuda.synchronize()
        first = next(iter(outs.values()))
        first = first if isinstance(first, tuple) else (first,)
        diffs = []
        for label, out in list(outs.items())[1:]:
            out = out if isinstance(out, tuple) else (out,)
            diffs.append(max(differ(a, b) for a, b in zip(first, out)))
        for _ in range(2):
            times = cs.in_turns(fns, reps)
            print(f"  {what}: " + ", ".join(f"{label} {ms:.4f} ms" for label, ms in times.items())
                  + f" (CUDA events, in turns); {diffs} of {n} differ [{card}]", flush=True)
        if any(diffs):
            unequal.append(f"{what}: outputs differ on {diffs} of {n}")

    def pairs(what, fns, reps):
        """MATS_PAIRS turns of the two functions of ``fns``, each a, b, b, a."""
        (la, lb), runs = fns, [cs.in_turns(fns, reps) for _ in range(MATS_PAIRS)]
        wins = sum(r[la] < r[lb] for r in runs)
        ratio = sum(r[lb] / r[la] for r in runs) / len(runs)
        print(f"  {what}, {MATS_PAIRS} pairs ({la}, {lb}) ms: "
              + "; ".join(f"{r[la]:.4f}, {r[lb]:.4f}" for r in runs)
              + f"; {la} faster in {wins} of {MATS_PAIRS}, {lb} / {la} {ratio:.4f} on average"
              f" [{card}]", flush=True)

    unequal = []  # checked once every reading is printed
    W, H, B, seed = cs.W_MAIN, cs.H_MAIN, 5, 0x17
    R = W * H
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    k = mk.TraceConsts.from_config(cfg)
    cam = cam_ops.Camera.create(width=W, height=H)
    px, py = pt.pixel_grid(H, W, dev)
    o, d = (x.contiguous() for x in cam_ops.get_rays(
        cam, px, py, (rng.ray_uniforms(seed, 1, R, 1, dev) - 0.5).T))

    # ---- <= 8 materials: the shipped units against the parent's ------------------------
    print(f"<= 8 materials, shipped against the parent's units, {W}x{H}, max_depth {B}:",
          flush=True)
    packed = mk.pack_scene(demo.reference_demo_scene(32, 16).build_packet(device=dev))
    rows = rk.camera_rows(cam)
    acc = torch.zeros((H, W, 3), device=dev)

    def two(unit, call):
        return {"shipped": call, "parent's unit": through(parent[unit], call)}

    turns("demo render kernel (spp 4's fourth sample)", two(
        "render_kernel.cu", lambda: rk.sample_accum(acc.clone(), packed, rows, 4, cfg, 100)),
        20, R)
    turns("demo recording kernel", two(
        "record_kernel.cu", lambda: mk.trace_fused_sel(o, d, packed, k, B, seed, 0)), 20, R)
    config4 = cs.TRI_CONFIGS[1]
    for label, pkt in (("config 4", None),
                       ("config 4, 300 materials", cs.many_materials_scene(
                           dev, np.random.default_rng(300)))):
        _, _, scene, kk, oo, dd, _, states = cs.mask_states(dev, config4, seed=seed, pkt=pkt)
        if pkt is not None:
            print(f"{label}: the table ({scene.num_mats} rows) read in place against staged in "
                  f"dynamic shared memory, {W}x{H}, max_depth {B}:", flush=True)
        for b, state, ids in states:
            short, cnt = wf.wave_mask_lists(state, scene.boxes, kk.t_min,
                                            supers=scene.mask_supers)

            def bounce(state=state, ids=ids, short=short, cnt=cnt, b=b):
                return wf.wave_bounce(state, ids, short, cnt, scene, kk, b, seed, 1)

            what = f"{label} bounce kernel, bounce {b} ({int((state[9] > 0.5).sum())} live rays)"
            if pkt is not None:
                turns(what, {"shipped": bounce,
                             "dynamic shared": through(dyn["wave_kernel.cu"], bounce)}, 10,
                      state.shape[1])
                continue
            turns(what, {**two("wave_kernel.cu", bounce),
                         **{v: through(lib, bounce) for v, lib in wave_v.items()}},
                  10, state.shape[1])
            pairs(what, {"staged": bounce, "in place": through(wave_v["in place"], bounce)}, 10)

        def culled():
            return mk.trace_culled(oo, dd, scene, kk, B, seed, 0, record=True)

        turns(f"{label} culled megakernel, one recording sample",
              {"shipped": culled, "dynamic shared": through(dyn["mega_kernel.cu"], culled)}
              if pkt is not None else two("mega_kernel.cu", culled), 5, oo.shape[0])
        del states, scene
        torch.cuda.empty_cache()

    ship_sass = sass_counts(shipped._name, "wave_bounce_kernel")
    for label, lib in (("parent's unit", parent["wave_kernel.cu"]),
                       *((v, lib) for v, lib in wave_v.items())):
        sass_report(label, ship_sass, sass_counts(lib._name, "wave_bounce_kernel"))
    cs.check(not unequal, "; ".join(unequal))


# wave_kernel.cu: the warp sweep of a leaf's passing rays, and the per-lane
# sweep of the "fallback >= n" variants (PER_LANE's function, inserted
# before the kernel); the parent unit's per-lane sweep of staged rows, and
# the warp sweep of those rows that replaces it in "spread, staged"
BOUNCE_WARP_CALL = """      if (passed != 0) {
        sweep_leaf_warp(rows + (int64_t)leaf * kLeafFloats, leaf, passed, r, p, best);
      }"""
BOUNCE_FALLBACK_CALL = """      const float* leaf_rows = rows + (int64_t)leaf * kLeafFloats;
      if (passed != 0 && __popc(passed) < FALLBACK_MIN) {
        sweep_leaf_warp(leaf_rows, leaf, passed, r, p, best);
      } else if (passed >> (tid & 31) & 1u) {
        sweep_leaf_lane(leaf_rows, leaf, r, p, best);
      }"""
KERNEL_HEAD = "\ntemplate <bool kRecord, bool kStats>\n__global__"
LANE_STAGED_CALL = """    if (live && slab_pass_within(boxes + leaf * kBoxStride, r.o, iv, p.t_min, best.t)) {
      sweep_leaf(s_rows[k & 1], leaf, r, p, best);
    }"""
SPREAD_STAGED_CALL = """    const unsigned passed = __ballot_sync(
        kFullWarp, live && slab_pass_within(boxes + leaf * kBoxStride, r.o, iv, p.t_min, best.t));
    if (passed != 0) sweep_leaf_warp(s_rows[k & 1], leaf, passed, r, p, best);"""
GLOBAL_ROW_LOADS = "const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);"
SHARED_ROW_LOADS = "const float4 a = q[0], b = q[1], c = q[2];"
# wave.cuh sweep_leaf_warp's parts as shipped, and the variants' in their
# place: the rows loaded for every ray instead of once a visit ("rows a
# ray"), the (t, row) minimum by a butterfly of shuffles instead of a REDUX
# of order keys and two ballots ("butterfly"), and both (the culled
# megakernel's sweep before the bounce kernel took it)
SWEEP_HOIST = """  const int lane = threadIdx.x & 31;
  float rw[2][kRowStride];
  for (int h = 0; h < 2; ++h) {
    const float4* q = reinterpret_cast<const float4*>(rows + (lane + 32 * h) * kRowStride);
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    const float v[kRowStride] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
    for (int i = 0; i < kRowStride; ++i) rw[h][i] = v[i];
  }
  for (unsigned m = passed; m != 0; m &= m - 1) {"""
SWEEP_NO_HOIST = """  const int lane = threadIdx.x & 31;
  for (unsigned m = passed; m != 0; m &= m - 1) {"""
ROW_LOAD = """      const float4* q = reinterpret_cast<const float4*>(rows + (lane + 32 * h) * kRowStride);
      const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
      const float rw_h[kRowStride] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                      c.x, c.y, c.z, c.w};
"""
SWEEP_TESTS = """    for (int h = 0; h < 2; ++h) {
      acc[h] = row_accepts(rw[h], o, d, p.t_min, p.t_max, p.det_eps, &t_row[h]);
    }"""
SWEEP_REDUX = """    float t_row[2];
    bool acc[2];
""" + SWEEP_TESTS + """
    if (!__any_sync(kFullWarp, acc[0] || acc[1])) continue;
    // a row that accepts nothing as +inf: the least key is an accepted row's
    const float inf = __int_as_float(0x7f800000);
    const float t_lane = fminf(acc[0] ? t_row[0] : inf, acc[1] ? t_row[1] : inf);
    const unsigned k_min = __reduce_min_sync(kFullWarp, order_key(t_lane));
    const unsigned lo = __ballot_sync(kFullWarp, acc[0] && order_key(t_row[0]) == k_min);
    const unsigned hi = __ballot_sync(kFullWarp, acc[1] && order_key(t_row[1]) == k_min);
    const int j_min = lo != 0 ? __ffs(lo) - 1 : 31 + __ffs(hi);
    const float t_min = __shfl_sync(kFullWarp, j_min < 32 ? t_row[0] : t_row[1], j_min & 31);"""
SWEEP_BUTTERFLY = """    float t_min = kBig;
    int j_min = kLeaf;  // past every row: loses every tie
    bool any = false;
    for (int h = 0; h < 2; ++h) {
      float t;
      if (row_accepts(rw[h], o, d, p.t_min, p.t_max, p.det_eps, &t)) {
        any = true;
        if (t < t_min) {
          t_min = t;
          j_min = lane + 32 * h;
        }
      }
    }
    if (!__any_sync(kFullWarp, any)) continue;
    for (int off = 16; off > 0; off >>= 1) {
      const float t_o = __shfl_xor_sync(kFullWarp, t_min, off);
      const int j_o = __shfl_xor_sync(kFullWarp, j_min, off);
      if (t_o < t_min || (t_o == t_min && j_o < j_min)) {
        t_min = t_o;
        j_min = j_o;
      }
    }"""


def _rows_a_ray(text):
    """``text`` (a block of sweep_leaf_warp's ray loop) loading the lane's
    rows in each iteration of its row loop."""
    head = "    for (int h = 0; h < 2; ++h) {\n"
    cs.check(head in text, "the row loop is not in the sweep")
    return text.replace(head, head + ROW_LOAD, 1).replace("rw[h]", "rw_h")


SWEEP_EDITS = {
    "rows a ray": [(SWEEP_HOIST, SWEEP_NO_HOIST), (SWEEP_TESTS, _rows_a_ray(SWEEP_TESTS))],
    "butterfly": [(SWEEP_REDUX, SWEEP_BUTTERFLY)],
    "rows a ray, butterfly": [(SWEEP_HOIST, SWEEP_NO_HOIST),
                              (SWEEP_REDUX, _rows_a_ray(SWEEP_BUTTERFLY))],
}
BOUNCE_FALLBACKS = (8, 16, 24)
BOUNCE_MESHES = (("config 4", cs.TRI_CONFIGS[1]),
                 ("65,024-row mesh", ("65,024-row mesh", cs.STAGED_SCENE, cs.W_MAIN, cs.H_MAIN)),
                 ("4,080-leaf mesh", MASK_MESHES[1]))


def bounce(dev, card):
    """The bounce kernel's warp sweep against the parent's per-lane unit and
    the variants above, every output bit for bit the shipped kernel's, timed
    in turns at each bounce (config 4) or at bounce 1 (the two meshes past
    the row cap); the culled megakernel with each sweep variant."""
    import torch

    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import wavefront as wf

    def fallback(n):
        return [(BOUNCE_WARP_CALL, BOUNCE_FALLBACK_CALL.replace("FALLBACK_MIN", str(n))),
                (KERNEL_HEAD, PER_LANE)]

    def tag(label):
        return "".join(c if c.isalnum() else "_" for c in label)

    lane_base = os.path.join("baseline", "wave_lane", "wave_kernel.cu")
    builds = {
        "per lane, staged": cs.start_wave_lane_build(),
        "spread, staged": variant(build, "wave_kernel.cu", "spreadstaged", {
            "wave_kernel.cu": [(LANE_STAGED_CALL, SPREAD_STAGED_CALL)],
            "wave.cuh": [(GLOBAL_ROW_LOADS, SHARED_ROW_LOADS)]}, base=lane_base),
        **{f"fallback >= {n}": variant(build, "wave_kernel.cu", f"fallback{n}", fallback(n))
           for n in BOUNCE_FALLBACKS},
        **{label: variant(build, "wave_kernel.cu", tag(label), {"wave.cuh": edits})
           for label, edits in SWEEP_EDITS.items()}}
    mega_builds = {label: variant(build, "mega_kernel.cu", "mega_" + tag(label),
                                  {"wave.cuh": edits}) for label, edits in SWEEP_EDITS.items()}
    shipped = build.load_library()
    if build.last_build is not None:
        print("shipped: " + "; ".join(x for x in cs.ptxas_summary(build.last_build[1])
                                      if "wave_bounce" in x or "mega" in x) + f" [{card}]",
              flush=True)
    fns = {"shipped": wf.wave_bounce}
    libs = {"shipped": shipped}
    for label, b in builds.items():
        report = []
        libs[label] = cs.finish_unit_build(b, report)
        print(f"{label}: " + "; ".join(x for x in report if "wave_bounce" in x) + f" [{card}]",
              flush=True)
        fns[label] = cs.lib_wave_bounce(libs[label], wf)
    for label, lib in libs.items():
        for name, ops in sorted(sass_counts(lib._name, "wave_bounce_kernel").items()):
            print(f"  SASS {label}: {name} {sum(ops.values())} instructions, "
                  f"{ops.get('SHFL', 0)} SHFL, {ops.get('BAR', 0)} BAR, {ops.get('LDS', 0)} LDS, "
                  f"{ops.get('LDG', 0)} LDG", flush=True)
    mega_fns = {}
    for label, b in mega_builds.items():
        report = []
        lib = cs.finish_unit_build(b, report)
        print(f"culled megakernel, {label}: " + "; ".join(x for x in report if "mega" in x)
              + f" [{card}]", flush=True)
        lib.ptre_trace_culled.restype = ctypes.c_int
        lib.ptre_trace_culled.argtypes = shipped.ptre_trace_culled.argtypes
        mega_fns[label] = lib

    unequal, sums = [], {}
    for mesh, config in BOUNCE_MESHES:
        _, _, scene, k, o, d, short0, states = cs.mask_states(dev, config, seed=0x27)
        W, H = config[2], config[3]
        R, B = W * H, 5
        bounces = [(b, s, i, *wf.wave_mask_lists(s, scene.boxes, k.t_min,
                                                 supers=scene.mask_supers))
                   for b, s, i in states]
        if mesh == "config 4":
            s0, i0, _ = wf.primary_state(o, d, scene, (H, W))
            bounces = [(0, s0, i0, *short0)] + bounces
        else:
            bounces = bounces[:1]
        del states
        sel = torch.full((B, R), -1, dtype=torch.int32, device=dev)
        for b, state, ids, short, cnt in bounces:
            stats = torch.zeros(len(wf.BOUNCE_STATS), dtype=torch.int64, device=dev)
            wf.wave_bounce(state, ids, short, cnt, scene, k, b, 0x27, 1, stats=stats)
            st = dict(zip(wf.BOUNCE_STATS, stats.tolist()))
            print(f"  {mesh} bounce {b}: counts {st}; rays a warp visit "
                  f"{st['own_pairs'] / max(st['warp_visits'], 1):.3f}, busy lane share of a "
                  f"per-lane sweep {100 * st['own_pairs'] / max(st['lane_slots'], 1):.2f} %",
                  flush=True)
            for rec in (False, True):
                def call(fn, state=state, ids=ids, short=short, cnt=cnt, b=b, rec=rec):
                    return lambda: fn(state, ids, short, cnt, scene, k, b, 0x27, 1,
                                      sel=sel if rec else None)

                outs = {}
                for label, fn in fns.items():
                    sel.fill_(-1)
                    outs[label] = (call(fn)(), sel.clone())
                torch.cuda.synchronize()
                diff = [label for label, (st, se) in outs.items()
                        if not (torch.equal(st, outs["shipped"][0])
                                and torch.equal(se, outs["shipped"][1]))]
                if diff:
                    unequal.append(f"{mesh} bounce {b} recording {rec}: {diff}")
                what = f"{mesh} bounce {b}{' recording' if rec else ''}"
                for _ in range(2):
                    times = cs.in_turns({label: call(fn) for label, fn in fns.items()}, 10)
                    print(f"  {what} ({int((state[9] > 0.5).sum())} live rays): " + ", ".join(
                        f"{label} {ms:.4f} ms" for label, ms in times.items())
                        + f" (CUDA events, in turns); differ from shipped: {diff} [{card}]",
                        flush=True)
                    for label, ms in times.items():
                        key = (mesh, rec, label)
                        sums[key] = sums.get(key, 0.0) + ms / 2
        del bounces, sel
        if mesh == "config 4":
            def culled(lib=None):
                def fn():
                    load = build.load_library
                    if lib is not None:
                        build.load_library = lambda: lib
                    try:
                        return mk.trace_culled(o, d, scene, k, B, 0x27, 0, record=True)
                    finally:
                        build.load_library = load
                return fn

            cfns = {"shipped": culled(), **{v: culled(lib) for v, lib in mega_fns.items()}}
            outs = {label: fn() for label, fn in cfns.items()}
            torch.cuda.synchronize()
            diff = [label for label, out in outs.items() if not all(
                torch.equal(a, b) for a, b in zip(out, outs["shipped"]))]
            if diff:
                unequal.append(f"culled megakernel: {diff}")
            for _ in range(2):
                times = cs.in_turns(cfns, 5)
                print(f"  culled megakernel, config 4, one recording sample: " + ", ".join(
                    f"{label} {ms:.4f} ms" for label, ms in times.items())
                    + f" (CUDA events, in turns); differ from shipped: {diff} [{card}]",
                    flush=True)
        del scene
        torch.cuda.empty_cache()
    for (mesh, rec, label), ms in sums.items():
        base = sums[(mesh, rec, "shipped")]
        print(f"  {mesh}{' recording' if rec else ''}, bounces summed: {label} {ms:.4f} ms "
              f"({ms / base:.4f} of shipped) [{card}]", flush=True)
    cs.check(not unequal, "; ".join(unequal))


FLIP_SEEDS = range(200)
#: kernel launches a (case, seed), compared bit for bit with the first
FLIP_REPEATS = 3
#: unseeded draws of the default generator after the card suite, as the card
#: test drew before it was seeded
FLIP_DRAWS = 200


def culled_flips(dev, card, seeds=FLIP_SEEDS):
    """The card test's four cases over ``seeds``, in a fresh process and
    again after the card suite has run in this process: flips of the kernel
    against its plain version and against the wavefront, with each flipped
    ray's first differing bounce and the kinds of hit there; whether the
    kernel's repeats are bit-equal; whether any (case, seed) differs bit for
    bit between the two sweeps; then ``FLIP_DRAWS`` unseeded draws of the
    default generator in the case that once failed on an unseeded draw
    (culling off, external uniforms)."""
    import collections
    import hashlib
    import math
    import time

    import pytest
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import wavefront as wf
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.config import RenderConfig

    W, H, B = 256, 128, 4
    cfg = RenderConfig(width=W, height=H, max_depth=B)
    pkt = demo.config4_mixed_scene(64, 32).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    scene = wf.prepare_scene(pkt, screen_cam=cam)
    px, py = pt.pixel_grid(H, W, dev)
    jit = torch.rand((H * W, 2), device=dev, generator=torch.Generator(dev).manual_seed(2))
    o, d = (x.contiguous() for x in cam_ops.get_rays(cam, px, py, jit - 0.5))
    k = mk.TraceConsts.from_config(cfg)
    R = o.shape[0]
    radius = [float(r) for r in pkt.sph_radius.tolist()]
    allowed = math.ceil(1e-4 * R)

    def kind(row):
        if row < 0:
            return "miss"
        if row < scene.tri_rows:
            return "tri"
        return f"sph r={radius[row - scene.tri_rows]:g}"

    def flips(color, want, sel, want_sel):
        """(count, Counter of (bounce, before, got -> want)) of flipped rays."""
        flip = ((color - want).abs() > 1e-4 * want.abs().clamp_min(1.0)).any(dim=1)
        differ = sel != want_sel
        flip |= differ.any(dim=0)
        where = collections.Counter()
        sel_h, want_h, differ_h = sel.cpu(), want_sel.cpu(), differ.cpu()
        for ray in torch.nonzero(flip).flatten().tolist():
            rows = torch.nonzero(differ_h[:, ray]).flatten().tolist()
            if not rows:
                where["colour only"] += 1
                continue
            b = rows[0]
            before = kind(int(sel_h[b - 1, ray])) if b else "camera"
            where[(b, before, f"{kind(int(sel_h[b, ray]))} -> {kind(int(want_h[b, ray]))}")] += 1
        return int(flip.sum()), where

    def one(urand, seed, cull):
        """Flips against the plain version and the wavefront, a digest of
        every output, and whether the kernel's repeats are bit-equal."""
        runs = [mk.trace_culled(o, d, scene, k, B, seed, 1, urand, cull=cull, record=True)
                for _ in range(FLIP_REPEATS)]
        color, sel = runs[0]
        same = all(torch.equal(c, color) and torch.equal(s, sel) for c, s in runs[1:])
        want, want_sel = mk.trace_culled_reference(o, d, scene, k, B, seed, 1, urand,
                                                   cull=cull, record=True)
        wcol, wsel, _ = wf.trace(o, d, scene, k, B, seed, 1, urand, tile_hint=(H, W),
                                 record=True)
        digest = hashlib.sha1()
        for t in (color, sel, want, want_sel, wcol, wsel):
            digest.update(t.cpu().numpy().tobytes())
        return (flips(color, want, sel, want_sel), flips(color, wcol, sel, wsel),
                digest.hexdigest(), same)

    def report(label, case, draws, results, t0):
        for i, name in enumerate(("plain", "wavefront")):
            c = [r[i][0] for r in results]
            where = collections.Counter()
            for r in results:
                where.update(r[i][1])
            top = max(c)
            print(f"  {label}: culled flips, {case}, against the {name}: {draws}: flipped "
                  f"rays per draw {dict(sorted(collections.Counter(c).items()))} (count: "
                  f"draws), max {top} (draws {[n for n, x in enumerate(c) if x == top][:8]}"
                  f"), mean {sum(c) / len(c):.3f} of {R} rays (allowed {allowed}); where: "
                  + "; ".join(f"{w}: {n}" for w, n in where.most_common()), flush=True)
        same = sum(r[3] for r in results)
        print(f"  {label}: {case}: kernel repeats ({FLIP_REPEATS} launches) bit-equal in "
              f"{same} of {len(results)} draws; {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)

    def sweep(label):
        """The four cases over ``seeds``: {(external, cull, seed): digest}."""
        digests = {}
        for external in (True, False):
            for cull in (True, False):
                t0, results = time.perf_counter(), []
                for s in seeds:
                    if external:
                        urand = torch.rand((2 + 2 * B, R), device=dev,
                                           generator=torch.Generator(dev).manual_seed(s))
                        results.append(one(urand, 9, cull))
                    else:
                        results.append(one(None, s, cull))
                    digests[(external, cull, s)] = results[-1][2]
                case = (f"cull {'on' if cull else 'off'}, "
                        f"{'external uniforms' if external else 'Philox'}")
                report(label, case, f"seeds {seeds.start}-{seeds.stop - 1}", results, t0)
        return digests

    fresh = sweep("fresh process")
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-p", "no:cacheprovider", "--noconftest", "-m", "cuda", "-q",
                      os.path.join(root, "tests", "test_torch_cuda.py")])
    print(f"  the card suite (tests/test_torch_cuda.py -m cuda) in this process: exit {int(rc)}, "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    after = sweep("after the card suite")
    differ = [key for key in fresh if fresh[key] != after[key]]
    print(f"  after the card suite: {len(differ)} of {len(fresh)} (external, cull, seed) runs "
          f"differ bit for bit from the fresh process's: {differ[:10]}", flush=True)
    t0, results = time.perf_counter(), []
    for _ in range(FLIP_DRAWS):
        results.append(one(torch.rand((2 + 2 * B, R), device=dev), 9, False))
    report("after the card suite", "cull off, external uniforms",
           f"{FLIP_DRAWS} unseeded draws of the default generator", results, t0)


PRESENT_SIZES = ((1280, 720, 1), (1920, 1080, 1), (1920, 1080, 4))
PRESENT_FRAMES = 30


def present(dev, card):
    """`Renderer.draw_frame` of path-traced demo frames with ``present_async``
    on and off at each of ``PRESENT_SIZES`` (width, height, spp a frame):
    host-clock ms/frame over ``PRESENT_FRAMES`` frames, the two modes timed
    in turns (a, b, b, a, a, b, b, a), each window ending in a synchronize,
    then each mode's device-busy time and idle share a frame
    (`chip_smoke.device_share`)."""
    import time

    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.render import engine
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

    for W, H, spp in PRESENT_SIZES:
        cam = cam_ops.Camera.create(width=W, height=H)
        cfg, rcfg = RenderConfig(width=W, height=H), RasterConfig(width=W, height=H)
        modes = {label: engine.Renderer(demo.reference_demo_scene(32, 16), cam, cfg, rcfg,
                                        spp_per_frame=spp, present_async=on, device=dev)
                 for label, on in (("dispatch-ahead", True), ("synchronous", False))}
        for r in modes.values():
            for _ in range(3):
                r.draw_frame()
        times = {label: [] for label in modes}
        for label in [*modes, *reversed(modes)] * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PRESENT_FRAMES):
                modes[label].draw_frame()
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3 / PRESENT_FRAMES)
        print(f"  Renderer.draw_frame path-traced {W}x{H} spp {spp}, host ms/frame over "
              f"{PRESENT_FRAMES} frames in turns: " + "; ".join(
                  f"{label} {', '.join(f'{t:.3f}' for t in v)} (mean {sum(v) / len(v):.3f})"
                  for label, v in times.items()) + f" [{card}]", flush=True)
        for label, r in modes.items():
            cs.device_share(r.draw_frame, PRESENT_FRAMES,
                            f"Renderer.draw_frame {W}x{H} spp {spp} {label}", card)


SYNC_REPS = 4
SYNC_WINDOWS = 5


def syncs(dev, card):
    """The host round trips of each path of the module docstring's "syncs"
    part: the synchronizing calls of one call by their lines, then the
    profile of SYNC_REPS calls."""
    import dataclasses
    import time

    import torch
    import torch.distributed as dist

    import ptre_tpu_torch
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import engine, train
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.render import rasterizer as ras
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

    print(f"syncs: ptre_tpu_torch from {os.path.dirname(ptre_tpu_torch.__file__)}", flush=True)
    scn = demo.reference_demo_scene(32, 16)
    key = rng.key_for(5)
    step = iter(range(10**6))

    def read(name, fn, reps=SYNC_REPS):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        sites = cs.sync_sites(fn)
        print(f"  {name}: {sum(sites.values())} synchronizing calls in one call"
              + "".join(f"; {n} at {site}" for site, n in sorted(sites.items())), flush=True)
        for each_call in (False, True):
            times = []
            for _ in range(SYNC_WINDOWS):
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                    if each_call:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / reps)
            print(f"  {name}: host ms/call over {SYNC_WINDOWS} windows of {reps} calls, "
                  + ("a synchronize after every call" if each_call else
                     "each ending in a synchronize") + ", no profiler: "
                  + ", ".join(f"{t:.3f}" for t in times)
                  + f" (median {sorted(times)[len(times) // 2]:.3f}) [{card}]", flush=True)
        cs.device_share(fn, reps, name, card)

    W, H = cs.W_MAIN, cs.H_MAIN
    pkt = scn.build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    print(f"  the camera's leaves lie on {cam.position.device}", flush=True)
    cfg = RenderConfig(width=W, height=H)
    acc = pt.AccumState.create(H, W, dev)
    read(f"render_step {W}x{H} spp 4", lambda: pt.render_step(
        pkt, cam, acc, rng.fold(key, next(step)), cfg, spp=4))
    params = sh.differentiable_params(pkt, cam)
    target = torch.zeros((W * H, 3), device=dev)
    read(f"mse_step {W}x{H} spp 1", lambda: train.mse_step(params, pkt, cam, target, cfg,
                                                            next(step)))

    EW, EH = 1280, 720
    r = engine.Renderer(scn, cam_ops.Camera.create(width=EW, height=EH),
                        RenderConfig(width=EW, height=EH), RasterConfig(width=EW, height=EH),
                        device=dev)
    read(f"Renderer.draw_frame {EW}x{EH} spp 1 dispatch-ahead", r.draw_frame, 20)

    RW, RH, ss, sigma = cs.RASTER_W, cs.RASTER_H, cs.RASTER_SS, cs.SIGMA
    rpkt = scn.build_packet(spheres_as_triangles=True, device=dev)
    rcam = cam_ops.Camera.create(width=RW, height=RH)
    rcfg = RasterConfig(width=RW, height=RH, supersample=ss)
    for soft in (False, True):
        def frame(soft=soft):
            with torch.no_grad():
                return ras.rasterize(rpkt, rcam, rcfg, soft=soft, sigma=sigma)
        read(f"rasterize {'soft' if soft else 'hard'} {RW}x{RH} ss {ss}", frame, 8)
    rparams = sh.differentiable_params(rpkt, rcam)
    rtarget = torch.zeros((RH, RW, 3), device=dev)
    read(f"raster_mse_step {RW}x{RH} ss {ss}",
         lambda: train.raster_mse_step(rparams, rpkt, rcam, rtarget, rcfg, sigma), 8)

    # the triangle-scale and replay routes (the wavefront takes its sort
    # decision on the card and should read nothing back): their sites only,
    # one call each, after a warm-up call
    tpkt = demo.config4_mixed_scene(128, 64).build_packet(device=dev)
    tparams = sh.differentiable_params(tpkt, cam)
    kept = {
        f"config 4 render_step {W}x{H} spp 1 (wavefront)": lambda: pt.render_step(
            tpkt, cam, acc, rng.fold(key, next(step)), cfg),
        f"config 4 mse_step {W}x{H} spp 1 (wavefront record, fused backward)":
            lambda: train.mse_step(tparams, tpkt, cam, target, cfg, next(step)),
        f"mse_step {W}x{H} spp 1, grad_sweep replay": lambda: train.mse_step(
            params, pkt, cam, target, dataclasses.replace(cfg, grad_sweep="replay"),
            next(step)),
    }
    for name, fn in kept.items():
        fn()
        sites = cs.sync_sites(fn)
        print(f"  {name}: {sum(sites.values())} synchronizing calls in one call"
              + "".join(f"; {n} at {site}" for site, n in sorted(sites.items())), flush=True)

    mesh = sh.make_mesh((1, 1))
    try:
        print(f"  world of one: backend {dist.get_backend()}", flush=True)
        spkt, srpkt = sh.replicate(mesh, pkt), sh.replicate(mesh, rpkt)
        scfg = RasterConfig(width=W, height=H, supersample=2)
        slab = torch.zeros((H, W, 3), device=dev)
        state = {"acc": pt.AccumState(torch.zeros((H, W, 3), device=dev), 0)}

        def render():
            state["acc"] = sh.shard_render_step(mesh, spkt, cam, state["acc"],
                                                rng.fold(key, next(step)), cfg, spp=4)

        read(f"shard_render_step {W}x{H} spp 4", render, 2)
        read(f"shard_train_step {W}x{H} spp 1", lambda: sh.shard_train_step(
            mesh, params, spkt, cam, slab, rng.fold(key, next(step)), cfg), 2)
        read(f"dual_train_step {W}x{H} spp 1", lambda: sh.dual_train_step(
            mesh, params, spkt, srpkt, cam, slab, rng.fold(key, next(step)), cfg, scfg), 2)
    finally:
        dist.destroy_process_group()


def raster_mega(dev, card):
    """The hard raster kernel's and the culled megakernel's variants against
    the shipped build, outputs compared, timed in turns."""
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


# replay_kernel.cu: the texts the replay variants edit. The shipped unit's
# per-lane row pointer, and a warp's 32 rows staged in shared memory (as
# float4s where the slab is whole and aligned) by warps where a lane needs
# one; its per-lane loads and stores of o, d, d(colour), colour, d(o),
# d(d), and the warp's 96 contiguous floats staged through shared memory.
LANE_ROW = """__device__ __forceinline__ const float* bounce_row(const TraceParams& p, const float* g,
                                                   int b, const WarpRays& w, bool need) {
  return need ? g + ((int64_t)b * p.n_rays + w.r0 + w.lane) * kRowStride : nullptr;
}"""
SLAB_ROW = """__shared__ __align__(16) float s_rows[kReplayWarps][kSlab];
__device__ __forceinline__ const float* bounce_row(const TraceParams& p, const float* g,
                                                   int b, const WarpRays& w, bool need) {
  float* slice = s_rows[threadIdx.x >> 5];
  if (__ballot_sync(kFull, need) != 0u) {
    __syncwarp();
    const float* src = g + slab_offset(p, b, w);
    if (w.n == 32 && p.n_rays % 4 == 0 && is16(g)) {
      const float4* q = reinterpret_cast<const float4*>(src);
      float4* s4 = reinterpret_cast<float4*>(slice);
      for (int i = w.lane; i < kSlab / 4; i += 32) s4[i] = __ldg(q + i);
    } else {
      for (int i = w.lane; i < w.n * kRowStride; i += 32) slice[i] = __ldg(src + i);
    }
    __syncwarp();
  }
  return slice + w.lane * kRowStride;
}"""
LANE_RAYS = """__device__ __forceinline__ void load3(const float* __restrict__ v, const WarpRays& w,
                                      float out[3]) {
  for (int i = 0; i < 3; ++i) out[i] = w.lane < w.n ? __ldg(v + 3 * (w.r0 + w.lane) + i) : 0.0f;
}

__device__ __forceinline__ void store3(float* __restrict__ v, const WarpRays& w,
                                       const float in[3]) {
  if (w.lane < w.n)
    for (int i = 0; i < 3; ++i) v[3 * (w.r0 + w.lane) + i] = in[i];
}"""
STAGED_RAYS = """__shared__ float s_rays[kReplayWarps][96];
__device__ __forceinline__ void load3(const float* __restrict__ v, const WarpRays& w,
                                      float out[3]) {
  float* slice = s_rays[threadIdx.x >> 5];
  __syncwarp();
  for (int i = w.lane; i < 3 * w.n; i += 32) slice[i] = __ldg(v + 3 * w.r0 + i);
  __syncwarp();
  for (int i = 0; i < 3; ++i) out[i] = w.lane < w.n ? slice[3 * w.lane + i] : 0.0f;
}

__device__ __forceinline__ void store3(float* __restrict__ v, const WarpRays& w,
                                       const float in[3]) {
  float* slice = s_rays[threadIdx.x >> 5];
  __syncwarp();
  for (int i = 0; i < 3; ++i) slice[3 * w.lane + i] = in[i];
  __syncwarp();
  for (int i = w.lane; i < 3 * w.n; i += 32) v[3 * w.r0 + i] = slice[i];
}"""
# The forward's chain step, and the same loads without its arithmetic: the
# selection, and the columns chain_bounce reads of a hit's row by its kind,
# summed into the colour; the path ends where the chain ends it (a miss or
# an emitter), so the same bounces are entered. Not equal to the shipped
# colour: its time is the forward's memory floor on these inputs.
CHAIN_STEP = "    replay_step(b, idx, row, p.sph_offset, un, sky, k, ln, none);"
LOADS_ONLY = """    if (ln.act) {
      if (idx < 0) {
        ln.c[0] += sky[0] * ln.d[1];
        ln.act = false;
      } else {
        float s = row[22] + row[23] + row[24] + row[25] + row[26];
        if (row[22] > 0.5f) {
          ln.act = false;
        } else if (idx < p.sph_offset) {
          for (int j = 0; j < 18; ++j) s += row[j];
        } else {
          for (int j = 18; j < 22; ++j) s += row[j];
        }
        ln.c[0] += s;
      }
    }"""
REPLAY_EDITS = {
    "forward floor": [(CHAIN_STEP, LOADS_ONLY)],
    "slab rows": [(LANE_ROW, SLAB_ROW)],
    "staged rays": [(LANE_RAYS, STAGED_RAYS)],
    "no dead tails": [("__ballot_sync(kFull, ln.act) == 0u", "p.max_depth < 0")],
    "scalar slabs": [("w.vec = w.n == 32 && p.n_rays % 4 == 0 && d_g != nullptr && is16(d_g);",
                      "w.vec = false;")],
    "16 warps": [("constexpr int kReplayMinBlocks = 3;", "constexpr int kReplayMinBlocks = 4;")],
    "forward 7 blocks": [("constexpr int kFwdMinBlocks = 8;", "constexpr int kFwdMinBlocks = 1;")],
    "forward 10 blocks": [("constexpr int kFwdMinBlocks = 8;",
                           "constexpr int kFwdMinBlocks = 10;")],
    "8 warps": [("constexpr int kReplayMinBlocks = 3;", "constexpr int kReplayMinBlocks = 2;")],
}


def forward_sectors(sel, table, T):
    """Bytes of the distinct 32-byte sectors the replay forward touches on
    recorded selections ``sel`` (B, R): o, d read and the colour written
    whole; the selection of each bounce a live path enters; the columns
    chain_bounce reads of each hit's row in g (B, R, 27) — an emitter's
    22-26, a sphere's 18-26, a triangle's 0-17 and 22-26."""
    import torch

    B, R = sel.shape
    emissive = table[:, 22] > 0.5
    live = torch.ones(R, dtype=torch.bool, device=sel.device)
    sel_at, spans = [], []
    for b in range(B):
        s = sel[b]
        hit = s >= 0
        emit = hit & emissive[s.clamp(min=0).long()]
        ray = torch.nonzero(live).squeeze(1)
        sel_at.append((b * R + ray) * 4)
        base = (b * R + ray) * 108
        tri, rest = (live & hit & ~emit & (s < T))[ray], (live & hit)[ray]
        spans += [(base[tri], 0, 72), (base[rest & emit[ray]], 88, 108),
                  (base[rest & ~emit[ray] & ~tri], 72, 108), (base[tri], 88, 108)]
        live = live & hit & ~emit

    def sectors(start, end):  # the sectors of byte ranges of at most 128 bytes
        first, last = start // 32, (end - 1) // 32
        span = first[:, None] + torch.arange(5, device=sel.device)
        return span[span <= last[:, None]]

    n_sel = sectors(torch.cat(sel_at), torch.cat(sel_at) + 4).unique().numel()
    n_rows = torch.cat([sectors(b + lo, b + hi) for b, lo, hi in spans]).unique().numel()
    return 32 * (n_sel + n_rows) + 3 * 32 * -(-R * 12 // 32)


def replay(dev, card):
    """The replay pair's variants (`REPLAY_EDITS`, the unit built with FMA
    contraction, the first design) against the shipped build: outputs
    compared, then timed in turns at max_depth 5 and 8."""
    import torch

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import path_replay, rng
    from ptre_tpu_torch.ops.cuda import build
    from ptre_tpu_torch.ops.cuda import megakernel as mk
    from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils.config import RenderConfig

    builds = {name: variant(build, "replay_kernel.cu", name.replace(" ", "_"), edits,
                            build.UNIT_FLAGS["replay_kernel.cu"])
              for name, edits in REPLAY_EDITS.items()}
    builds["with FMA"] = cs.start_unit_build("replay_kernel.cu", "replay_fma")
    builds["first design"] = cs.start_baseline_build("replay_kernel.cu", "replay_pair")
    build.load_library()
    cs.replay_build_report(build, card)
    pairs = {}
    for name, b in builds.items():
        report = []
        pairs[name] = cs.lib_replay_pair(cs.finish_unit_build(b, report), rpk, mk)
        print(f"  {name}: " + "; ".join(e for e in report if e.startswith("replay"))
              + f" [{card}]", flush=True)

    W, H, seed = cs.W_MAIN, cs.H_MAIN, cs.REPLAY_SEED
    R = W * H
    pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    jit = rng.ray_uniforms(seed, 0, R, 1, dev) - 0.5
    o, d = (t.contiguous() for t in cam_ops.get_rays(cam, *pt.pixel_grid(H, W, dev), jit.T))
    table, T, sky6 = path_replay.build_table(pkt)
    dcol = torch.randn((R, 3), device=dev, generator=torch.Generator(dev).manual_seed(5))
    shipped = (rpk.replay_fwd, rpk.replay_bwd)
    for B in (5, 8):
        k = mk.TraceConsts.from_config(RenderConfig(width=W, height=H, max_depth=B))
        _, sel = mk.trace_fused_sel(o, d, mk.pack_scene(pkt), k, B, seed, 0)
        g = path_replay.gather_rows(table, sel)
        fargs = (o, d, g, sel, sky6, T, k, B, seed, 0)
        bargs = (o, d, g, sel, sky6, dcol, T, k, B, seed, 0)
        col, grads = rpk.replay_fwd(*fargs), rpk.replay_bwd(*bargs)
        print(f"max_depth {B}: {cs.warp_slabs(g, sel, B)}", flush=True)
        fwd_bytes = cs.replay_work(sel, table, T)[0][0]
        moved = forward_sectors(sel, table, T)
        print(f"  forward: {fwd_bytes / 1e6:.1f} MB counted by the bound, {moved / 1e6:.1f} MB "
              f"in the 32-byte sectors its loads and stores touch ({moved / fwd_bytes:.2f} "
              f"times), {moved / cs.HBM_BYTES_PER_S * 1e3:.4f} ms at the bound's rate",
              flush=True)
        for name, (fwd, bwd) in pairs.items():
            v_col, v_grads = fwd(*fargs), bwd(*bargs)
            if name == "forward floor":
                cs.check(all(torch.equal(a, b) for a, b in zip(v_grads[:3], grads[:3])),
                         "replay forward floor: other gradients")
                continue
            if name == "with FMA":
                want = rpk.replay_fwd_reference(*fargs)
                err = (v_col - want).abs()
                print(f"  with FMA: colour max_abs_err {float(err.max()):.3e} against the "
                      f"plain version, {int((err > cs.REPLAY_FWD_ATOL).any(1).sum())} of {R} "
                      f"rays beyond {cs.REPLAY_FWD_ATOL:g} (shipped: "
                      f"{float((col - want).abs().max()):.3e})", flush=True)
                continue
            cs.check(torch.equal(v_col, col) and all(torch.equal(a, b) for a, b in
                                                     zip(v_grads[:3], grads[:3])),
                     f"replay {name}: other colour or gradients")
        for kind, i, args, reps in (("forward", 0, fargs, 20), ("backward", 1, bargs, 10)):
            fns = {"shipped": lambda i=i, args=args: shipped[i](*args)}
            fns.update({name: (lambda f=pair[i], args=args: f(*args))
                        for name, pair in pairs.items()})
            for _ in range(2):
                times = cs.in_turns(fns, reps)
                print(f"replay {kind}, demo at {W}x{H}, max_depth {B}, in turns: " + ", ".join(
                    f"{name} {ms:.4f} ms" for name, ms in times.items()) + f" [{card}]",
                    flush=True)
        del g, sel, grads, col

if __name__ == "__main__":
    main()
