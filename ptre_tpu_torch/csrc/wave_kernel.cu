// Wavefront bounce kernel for Hopper (sm_90a): one bounce of a sorted ray
// block, each ray swept only against the leaves of the block's shortlist
// whose box it passes itself, the warp sweeping the passing rays one at a
// time.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/wavefront.py _wave_kernel (:209,
// launched at :486). One CUDA block per ray block, one thread per ray. Each
// warp walks the block's shortlist (leaf ids, ascending, from the mask kernel:
// some ray of the block passes the leaf's box) on its own, with warp votes and
// no block barrier. For a listed leaf every live lane runs the slab test of its
// own ray against the leaf's box, bounded by its closest hit so far
// (slab_pass_within, on the dilated cull boxes), and a ballot lists the lanes
// that pass; a warp with no passing lane skips the leaf. The warp then tests
// the listed rays one at a time against the leaf's 64 compact rows, two rows a
// lane (48 B each, loaded once a visit, three 16-byte loads through L1/L2), and
// takes the lexicographic (t, row) minimum by a REDUX of order keys and two
// ballots, which the ray's lane merges with strict t < best (wave.cuh
// sweep_leaf_warp, the culled megakernel's sweep): ties go to the lowest Morton
// row, within a leaf and across the ascending list, as sweep_leaf's per-ray
// loop gives them. Then, per thread (wave.cuh finish_bounce): spheres bounded
// by the best triangle, the winner's 32-float row read by index from global
// memory, its attributes re-derived, shading (trace.cuh scatter_shade /
// sky_color: the material row by index, from shared memory up to 8 materials,
// else from the table in global memory) and the next state. Dead rays pass
// through unchanged; a block without a live ray copies its state and stops, and
// a warp without one walks nothing. The recording instantiation
// (wavefront.py:345-349, `record_sel`) also writes each live ray's winner, as a
// unified-table row or -1, straight to the ray's slot of this bounce's
// selection row by its original id: the ids already ride the sort, so nothing
// else has to (the TPU let four selection rows per bounce ride every later sort
// and scattered once at the end). With `stats` given, a separate instantiation
// also counts the live rays, the (live ray, listed leaf) box tests, the pairs
// whose box the ray passes, the (warp, leaf) visits with a passing lane and the
// live lanes of those visits (wavefront.BOUNCE_STATS); a launch without `stats`
// counts nothing.
//
// What bounds it on this card: float32 ALU work in the row tests, not DRAM.
// The first design made every live thread test all 64 rows of every listed leaf
// (4.61-4.71 ms at config 4's bounce-1 state, 1920x1080, NVIDIA H100 80GB HBM3,
// 700.00 W). The ray's own box test leaves 16 % of the listed (ray, leaf)
// pairs; the design before this one swept each such pair on the ray's own lane
// from rows staged in shared memory by cp.async, one block barrier a leaf (2.16
// ms; csrc/baseline/wave_lane/), so in most warp visits a few lanes ran 64
// serial row tests while the others waited. Spreading the rows over the lanes
// keeps every lane busy in the row tests, as it did for the culled megakernel
// (10.8 -> 2.9 ms a sample); loading a lane's rows once a visit, not once a
// ray, and the REDUX in place of a butterfly of shuffles keep the coherent
// primary rays (29 passing rays a warp visit at bounce 0) faster than the
// per-lane sweep was there (chip_ablations.py bounce). The table (48 B a row,
// 0.8 MB at config 4) and the 32-float rows stay in the 50 MB L2; the state is
// 40 B a ray in and out. The selection equals the per-lane designs': the box
// dilation makes the per-ray cull conservative (wavefront.CULL_PAD_REL), and
// the warp's (t, row) minimum is sweep_leaf's.
//
// Not carried over from the TPU kernel: the (12, lanes) transposed state,
// groups of 4 leaves per accumulator round trip, the trailing all-invalid
// pad leaf, f32 ids (ids are int32 here), 2B rows of uniforms riding the
// sort (Philox regenerates them from the ray id), and the one-hot MXU
// gathers of the winner (a direct row read).

#include <cuda_runtime.h>

#include "wave.cuh"

namespace ptre {

// The counters of the stats instantiation (wavefront.BOUNCE_STATS), in order.
enum : int { kRayBounces, kListedTests, kOwnPairs, kWarpVisits, kLaneSlots };

template <bool kRecord, bool kStats>
__global__ void __launch_bounds__(kMaxLanes)
    wave_bounce_kernel(const WaveParams p, const float* __restrict__ state,
                       const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ shortlist,
                       const int32_t* __restrict__ counts,
                       const float* __restrict__ tris,
                       const float* __restrict__ rows,
                       const float* __restrict__ boxes,
                       const float* __restrict__ sphs,
                       const float* __restrict__ mats,
                       const float* __restrict__ sky,
                       const float* __restrict__ urand, float* __restrict__ out,
                       int32_t* __restrict__ sel, unsigned long long* __restrict__ stats) {
  __shared__ float s_mat[kStagedMats * kMatStride];
  __shared__ float s_sky[8];

  const int tid = threadIdx.x;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + tid;
  WaveRay r = load_ray(state, col, p.r_pad);
  const bool live = r.act > 0.5f;
  if (!__syncthreads_or(live)) {  // uniform over the block
    store_ray(out, col, p.r_pad, r);
    return;
  }
  const bool staged = p.num_mats <= kStagedMats;  // else read in place
  if (staged) {
    for (int i = tid; i < kStagedMats * kMatStride; i += blockDim.x) s_mat[i] = mats[i];
  }
  if (tid < 8) s_sky[tid] = sky[tid];
  // s_mat, s_sky staged; from here on each warp runs on its own
  __syncthreads();

  TriBest best = {kBig, 0, false};
  const unsigned live_lanes = __ballot_sync(kFullWarp, live);
  if (live_lanes != 0) {  // uniform over the warp
    const float iv[3] = {slab_inv(r.d[0]), slab_inv(r.d[1]), slab_inv(r.d[2])};
    const int n = counts[blockIdx.x];
    const int32_t* list = shortlist + (int64_t)blockIdx.x * p.list_stride;
    // warp-uniform counts (kStats only), in the order of the enum above
    unsigned long long n_own = 0, n_visits = 0;
    for (int k = 0; k < n; ++k) {
      const int leaf = list[k];
      // the rays' own culls; a leaf that no lane passes costs one box test
      const unsigned passed = __ballot_sync(
          kFullWarp,
          live && slab_pass_within(boxes + leaf * kBoxStride, r.o, iv, p.t_min, best.t));
      if (kStats) {
        n_own += __popc(passed);
        n_visits += passed != 0;
      }
      if (passed != 0) {
        sweep_leaf_warp(rows + (int64_t)leaf * kLeafFloats, leaf, passed, r, p, best);
      }
    }
    if (kStats && (tid & 31) == 0) {
      const unsigned long long n_live = __popc(live_lanes);
      atomicAdd(stats + kRayBounces, n_live);
      atomicAdd(stats + kListedTests, n_live * n);
      atomicAdd(stats + kOwnPairs, n_own);
      atomicAdd(stats + kWarpVisits, n_visits);
      atomicAdd(stats + kLaneSlots, n_live * n_visits);
    }
  }

  if (live) {
    // the winner's row is read from the table in global memory (and L2)
    const SceneTables sc = {tris, sphs, staged ? s_mat : mats, s_sky, 0, p.n_sph, p.num_mats};
    const int32_t id = ids[col];
    if (kRecord) {
      const WinnerWriter rec = {sel_slot(sel, p, p.bounce, id)};
      finish_bounce_at(p, sc, best, id, urand, rec, r);
    } else {
      finish_bounce_at(p, sc, best, id, urand, NoWinner(), r);
    }
  }
  store_ray(out, col, p.r_pad, r);
}

template <bool kStats>
void launch_bounce(const WaveParams& p, const float* state, const int32_t* ids,
                   const int32_t* shortlist, const int32_t* counts, const float* tris,
                   const float* rows, const float* boxes, const float* sphs, const float* mats,
                   const float* sky, const float* urand, float* out, int32_t* sel,
                   unsigned long long* stats, int lanes, void* stream) {
  if (sel != nullptr) {
    wave_bounce_kernel<true, kStats><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats, sky, urand, out,
        sel, stats);
  } else {
    wave_bounce_kernel<false, kStats><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats, sky, urand, out,
        sel, stats);
  }
}

// Whether the C interface takes these arguments (cudaSuccess) or refuses
// them (cudaErrorInvalidValue).
int check_bounce(const WaveParams& p, const float* rows, const float* urand, int32_t* sel,
                 int lanes) {
  if (p.n_leaf < 0 || p.n_sph < 0 || p.num_mats > kMaxMaterials || lanes < 32 ||
      lanes > kMaxLanes || lanes % 32 != 0 || p.r_pad % lanes != 0 ||
      (p.external_rng && urand == nullptr) ||
      (sel != nullptr && (p.n_sel < 1 || p.sph_offset < 0 || p.bounce < 0)) ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// `lanes` rays per block; r_pad must be a whole number of blocks. `tris`
// (n_leaf * 64, 32) and `rows` (n_leaf * 64, 12) hold the same leaves,
// `boxes` at least n_leaf cull boxes; `rows` 16-byte aligned. With `sel`
// (max_depth, n_sel) int32 the recording instantiation runs and writes row
// `bounce` of it for the live rays.
extern "C" int ptre_wave_bounce(const ptre::WaveParams* params,
                                const float* state, const int32_t* ids,
                                const int32_t* shortlist, const int32_t* counts,
                                const float* tris, const float* rows,
                                const float* boxes, const float* sphs,
                                const float* mats, const float* sky,
                                const float* urand, float* out, int32_t* sel,
                                int lanes, void* stream) {
  const ptre::WaveParams p = *params;
  const int rc = ptre::check_bounce(p, rows, urand, sel, lanes);
  if (rc != 0) return rc;
  ptre::launch_bounce<false>(p, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats,
                             sky, urand, out, sel, nullptr, lanes, stream);
  return (int)cudaGetLastError();
}

// ptre_wave_bounce through the counting instantiation: the same outputs, and
// 5 uint64 counters that the launch adds to (wavefront.BOUNCE_STATS).
extern "C" int ptre_wave_bounce_counted(const ptre::WaveParams* params,
                                        const float* state, const int32_t* ids,
                                        const int32_t* shortlist, const int32_t* counts,
                                        const float* tris, const float* rows,
                                        const float* boxes, const float* sphs,
                                        const float* mats, const float* sky,
                                        const float* urand, float* out, int32_t* sel,
                                        unsigned long long* stats, int lanes, void* stream) {
  const ptre::WaveParams p = *params;
  const int rc = ptre::check_bounce(p, rows, urand, sel, lanes);
  if (rc != 0 || stats == nullptr) return rc != 0 ? rc : (int)cudaErrorInvalidValue;
  ptre::launch_bounce<true>(p, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats,
                            sky, urand, out, sel, stats, lanes, stream);
  return (int)cudaGetLastError();
}
