// Culled megakernel for Hopper (sm_90a): the whole bounce loop of one sample
// over Morton-ordered 64-row leaves, in one launch.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/megakernel.py _mega_kernel
// (:237, launched at :1079). One thread per ray, `lanes` rays a block, the
// path state (o, d, colour, live) in registers across all bounces. The block
// only stages the sky into shared memory (a hit's material row is read in
// place, by index); from then on each warp runs on its own, with warp votes
// and no block barrier. Per
// bounce a warp walks the supertiles (8 leaves each) in ascending order:
// every live lane tests the supertile's union box against its own ray,
// bounded by its own closest hit so far (wave.cuh slab_pass_within, on the
// dilated cull boxes), and a supertile that no lane passes is skipped
// (__any_sync). In a supertile that some lane passes, every live lane tests
// each leaf's box the same way, and a ballot lists the lanes whose own ray
// passes it: only those rays are tested against the leaf's 64 rows. The
// warp tests them one ray at a time, two rows a lane, and takes the
// lexicographic (t, row) minimum (wave.cuh sweep_leaf_warp, which the
// wavefront's bounce kernel runs too: the result of sweep_leaf, strict t <
// best over ascending Morton rows, so ties go to the lowest row within a
// leaf and across the walk). A leaf that no lane passes costs the warp one
// box test. The compact rows (48 B, three 16-byte loads each) are read
// through L1/L2, not staged, each lane's two once a visit. Then, per
// lane, wave.cuh finish_bounce: spheres bounded by the best triangle, the
// winner's row read by index from global memory, its attributes re-derived,
// shading, the next ray. A warp stops at the first bounce none of its lanes
// reaches. The recording instantiation writes every bounce's winner as a
// unified-table row (-1 for a miss, a dead ray or a bounce never reached)
// into sel (B, R) int32.
//
// The winners are the first design's (the block's votes: every live thread
// of a block swept each leaf that some thread passed): the cull is
// conservative (wavefront.CULL_PAD_REL), so a ray that fails a box test
// bounded by its closest hit cannot find a closer accepted row in it. The
// row test and the finish are the wavefront bounce kernel's device
// functions, so this kernel and the wavefront compute the same arithmetic.
//
// What bounds it on this card: float32 ALU work in the row tests (64 for each
// (ray, leaf) pair the ray passes) and the walk's box tests. The bytes are
// small: 24 B a ray in, 12 B (+ 4 B a bounce) out, and the leaf tables (0.8
// MB of compact rows, 2.1 MB of 32-float rows at 16,256 rows) stay in the
// 50 MB L2. On config 4 (16,140 triangles + 2 spheres, 1920x1080, max_depth
// 5; NVIDIA H100 80GB HBM3, 700 W) the rays pass 9.8 M (ray, leaf) pairs.
// The first design's block votes made all 256 threads sweep every leaf one
// ray passed, 79.9 M pairs, 24.2-24.3 ms a recording sample. Sweeping each
// passing ray on its own lane (the warp visits a leaf that any lane passes,
// 30.5 M lane slots, a third of them busy) took 10.8-11.1 ms; spreading the
// rows over the lanes keeps every lane busy in the row tests: 2.9 ms
// (chip_ablations.py times both). With
// `stats` given, a separate instantiation also counts the live ray-bounces,
// the supertile and leaf box tests made, the (ray, leaf) pairs whose box the
// ray itself passes and the (live lane, leaf) slots of the warps' visits; a
// launch without `stats` counts nothing.
//
// Not carried over from the TPU kernel: the (56, lanes) VMEM scratch (the
// state lives in registers), the one-hot MXU gathers of the winner (a direct
// row read), f32 row indices (int32 here), the hardware PRNG (Philox keyed
// (seed, ray, sample, draw), or external uniforms), the triangle table
// padded to whole supertiles (only the box table is) and the
// zero-initialised (4B, lanes) selection block.

#include <cuda_runtime.h>

#include "wave.cuh"

namespace ptre {

// The counters of the stats instantiation (megakernel.CULLED_STATS), in order.
enum : int { kRayBounces, kSuperTests, kLeafTests, kPairsPassed, kPairsVisited };

template <bool kRecord, bool kStats>
__global__ void __launch_bounds__(kMaxLanes)
    mega_kernel(const MegaParams p, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ urand,
                const float* __restrict__ tris, const float* __restrict__ rows,
                const float* __restrict__ boxes,
                const float* __restrict__ boxes2,
                const float* __restrict__ sphs, const float* __restrict__ mats,
                const float* __restrict__ sky, float* __restrict__ color,
                int32_t* __restrict__ sel, unsigned long long* __restrict__ stats) {
  __shared__ float s_sky[8];

  const int tid = threadIdx.x;
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + tid;
  const bool valid = ray < p.w.n_rays;  // the ragged last block
  WaveRay r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = valid ? o[3 * ray + k] : 0.0f;
    r.d[k] = valid ? d[3 * ray + k] : 0.0f;
    r.c[k] = 1.0f;
  }
  r.act = valid ? 1.0f : 0.0f;
  if (tid < 8) s_sky[tid] = sky[tid];
  __syncthreads();  // the block's only barrier

  WaveParams wp = p.w;
  const SceneTables sc = {tris, sphs, mats, s_sky, 0, wp.n_sph, wp.num_mats};
  // warp-uniform counts (kStats only), in the order of the enum above
  unsigned long long n_bounces = 0, n_super = 0, n_leaf = 0, n_passed = 0, n_visited = 0;
  int bounce = 0;
  // every lane of a warp, dead or ragged, reaches every vote below: the loop
  // bounds and the votes' results are uniform over the warp
  for (; bounce < p.max_depth; ++bounce) {
    const bool live = r.act > 0.5f;
    const unsigned live_lanes = __ballot_sync(kFullWarp, live);
    if (live_lanes == 0) break;  // no ray of the warp goes on
    const int n_live = __popc(live_lanes);
    wp.bounce = bounce;
    TriBest best = {kBig, 0, false};
    if (kStats) n_bounces += n_live;
    if (p.cull) {
      const float iv[3] = {slab_inv(r.d[0]), slab_inv(r.d[1]), slab_inv(r.d[2])};
      for (int js = 0; js < p.n_super; ++js) {
        if (kStats) n_super += n_live;
        if (!__any_sync(kFullWarp, live && slab_pass_within(boxes2 + js * kBoxStride, r.o, iv,
                                                            wp.t_min, best.t))) {
          continue;
        }
        const int end = min((js + 1) * kSuper, wp.n_leaf);
        for (int leaf = js * kSuper; leaf < end; ++leaf) {
          const unsigned passed = __ballot_sync(
              kFullWarp,
              live && slab_pass_within(boxes + leaf * kBoxStride, r.o, iv, wp.t_min, best.t));
          if (kStats) {
            n_leaf += n_live;
            n_passed += __popc(passed);
            n_visited += passed != 0 ? n_live : 0;
          }
          if (passed != 0) {
            sweep_leaf_warp(rows + (int64_t)leaf * kLeafFloats, leaf, passed, r, wp, best);
          }
        }
      }
    } else {
      for (int leaf = 0; leaf < wp.n_leaf; ++leaf) {
        sweep_leaf_warp(rows + (int64_t)leaf * kLeafFloats, leaf, live_lanes, r, wp, best);
      }
    }
    if (live) {
      if (kRecord) {
        const WinnerWriter rec = {sel_slot(sel, wp, bounce, (int32_t)ray)};
        finish_bounce_at(wp, sc, best, (int32_t)ray, urand, rec, r);
      } else {
        finish_bounce_at(wp, sc, best, (int32_t)ray, urand, NoWinner(), r);
      }
    } else if (kRecord && valid) {
      *sel_slot(sel, wp, bounce, (int32_t)ray) = -1;
    }
  }
  if (kStats && (tid & 31) == 0) {
    atomicAdd(stats + kRayBounces, n_bounces);
    atomicAdd(stats + kSuperTests, n_super);
    atomicAdd(stats + kLeafTests, n_leaf);
    atomicAdd(stats + kPairsPassed, n_passed);
    atomicAdd(stats + kPairsVisited, n_visited);
  }
  if (valid) {
    if (kRecord) {
      for (; bounce < p.max_depth; ++bounce) *sel_slot(sel, wp, bounce, (int32_t)ray) = -1;
    }
    for (int k = 0; k < 3; ++k) color[3 * ray + k] = r.c[k];
  }
}

template <bool kRecord>
void launch_mega(int n_blocks, int lanes, cudaStream_t st, const MegaParams& p, const float* o,
                 const float* d, const float* urand, const float* tris, const float* rows,
                 const float* boxes, const float* boxes2, const float* sphs, const float* mats,
                 const float* sky, float* color, int32_t* sel, unsigned long long* stats) {
  if (stats != nullptr) {
    mega_kernel<kRecord, true><<<n_blocks, lanes, 0, st>>>(
        p, o, d, urand, tris, rows, boxes, boxes2, sphs, mats, sky, color, sel, stats);
  } else {
    mega_kernel<kRecord, false><<<n_blocks, lanes, 0, st>>>(
        p, o, d, urand, tris, rows, boxes, boxes2, sphs, mats, sky, color, sel, stats);
  }
}

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// o, d, color are (n_rays, 3); tris (n_leaf * 64, 32) and rows (n_leaf * 64,
// 12) hold the same leaves; boxes (n_super * 8, 8) and boxes2 (n_super, 8)
// are read only with `cull`; with `sel` (max_depth, n_rays) int32 the
// recording instantiation runs; stats: null (nothing counted) or 5 uint64
// counters that the launch adds to (megakernel.py CULLED_STATS). `lanes`
// rays per block.
extern "C" int ptre_trace_culled(const ptre::MegaParams* params, const float* o,
                                 const float* d, const float* urand,
                                 const float* tris, const float* rows,
                                 const float* boxes,
                                 const float* boxes2, const float* sphs,
                                 const float* mats, const float* sky,
                                 float* color, int32_t* sel,
                                 unsigned long long* stats, int lanes,
                                 void* stream) {
  const ptre::MegaParams p = *params;
  if (p.w.n_rays < 1 || p.w.n_leaf < 0 || p.w.n_sph < 0 ||
      p.w.num_mats > ptre::kMaxMaterials || p.max_depth < 1 || lanes < 32 ||
      lanes > ptre::kMaxLanes || lanes % 32 != 0 ||
      (p.cull && (p.n_super * ptre::kSuper < p.w.n_leaf || boxes == nullptr ||
                  boxes2 == nullptr)) ||
      (p.w.external_rng && urand == nullptr) ||
      (sel != nullptr && (p.w.n_sel != p.w.n_rays || p.w.sph_offset < 0)) ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_blocks = (p.w.n_rays + lanes - 1) / lanes;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sel != nullptr) {
    ptre::launch_mega<true>(n_blocks, lanes, st, p, o, d, urand, tris, rows, boxes, boxes2,
                            sphs, mats, sky, color, sel, stats);
  } else {
    ptre::launch_mega<false>(n_blocks, lanes, st, p, o, d, urand, tris, rows, boxes, boxes2,
                             sphs, mats, sky, color, sel, stats);
  }
  return (int)cudaGetLastError();
}
