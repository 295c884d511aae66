// Wavefront bounce kernel for Hopper (sm_90a): one bounce of a sorted ray
// block, sweeping only the leaves on the block's shortlist.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/wavefront.py _wave_kernel
// (:209, launched at :486). One CUDA block per ray block, one thread per
// ray. The block walks its shortlist (leaf ids, ascending); for each leaf
// all threads stage its 64 rows x 32 floats (8 KB) into shared memory with
// 16-byte loads, then every live thread runs Moller-Trumbore over the 64
// rows, keeping strict t < best (so ties go to the lowest Morton row, within
// a leaf and across the ascending list). Then, per thread (wave.cuh
// finish_bounce): spheres bounded by the best triangle, the winner's row
// read by index from global memory, its attributes re-derived, shading
// (trace.cuh scatter_shade / sky_color) and the next state. Dead rays pass
// through unchanged; a block without a live ray copies its state and stops.
// The recording instantiation (wavefront.py:345-349, `record_sel`) also
// writes each live ray's winner, as a unified-table row or -1, straight to
// the ray's slot of this bounce's selection row by its original id: the ids
// already ride the sort, so nothing else has to (the TPU let four selection
// rows per bounce ride every later sort and scattered once at the end).
//
// What bounds it on this card: divergent float32 ALU work in the sweep, not
// bytes. A leaf costs each live ray 64 triangle tests (~40 flops each) for
// 8 KB read once per block from L2 (the 2.1 MB triangle table of config 4
// fits in the 50 MB L2); the state is 40 B a ray in and out. The design
// keeps the table in global memory and L2 and stages one leaf at a time, so
// shared memory (8 KB a block) does not limit occupancy — the 48 registers
// a thread do, at 5 blocks of 256 threads per SM; the sorted ray
// blocks keep a warp's rays on similar shortlists and similar path lengths
// (measured 3.2-4.7 ms a bounce at config 4, 1920x1080, NVIDIA H100 80GB
// HBM3, 700.00 W). Every thread, dead or ragged, takes part in every
// staging barrier.
//
// Not carried over from the TPU kernel: the (12, lanes) transposed state,
// groups of 4 leaves per accumulator round trip, the trailing all-invalid
// pad leaf, f32 ids (ids are int32 here), 2B rows of uniforms riding the
// sort (Philox regenerates them from the ray id), and the one-hot MXU
// gathers of the winner (a direct row read).

#include <cuda_runtime.h>

#include "wave.cuh"

namespace ptre {

template <bool kRecord>
__global__ void __launch_bounds__(kMaxLanes)
    wave_bounce_kernel(const WaveParams p, const float* __restrict__ state,
                       const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ shortlist,
                       const int32_t* __restrict__ counts,
                       const float* __restrict__ tris,
                       const float* __restrict__ sphs,
                       const float* __restrict__ mats,
                       const float* __restrict__ sky,
                       const float* __restrict__ urand, float* __restrict__ out,
                       int32_t* __restrict__ sel) {
  __shared__ __align__(16) float s_leaf[kLeaf * kTriStride];
  __shared__ float s_mat[kMaxMats * kMatStride];
  __shared__ float s_sky[8];

  const int tid = threadIdx.x;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + tid;
  WaveRay r = load_ray(state, col, p.r_pad);
  const bool live = r.act > 0.5f;
  if (!__syncthreads_or(live)) {  // uniform over the block
    store_ray(out, col, p.r_pad, r);
    return;
  }
  for (int i = tid; i < kMaxMats * kMatStride; i += blockDim.x) s_mat[i] = mats[i];
  if (tid < 8) s_sky[tid] = sky[tid];

  TriBest best = {kBig, 0, false};
  const int n = counts[blockIdx.x];
  const int32_t* list = shortlist + (int64_t)blockIdx.x * p.list_stride;
  float4* dst = reinterpret_cast<float4*>(s_leaf);
  for (int k = 0; k < n; ++k) {
    const int leaf = list[k];
    const float4* src =
        reinterpret_cast<const float4*>(tris + (int64_t)leaf * kLeaf * kTriStride);
    __syncthreads();  // every thread is done with the previous leaf
    for (int i = tid; i < kLeaf * kTriStride / 4; i += blockDim.x) dst[i] = __ldg(src + i);
    __syncthreads();
    if (live) sweep_leaf(s_leaf, leaf, r, p, best);
  }
  __syncthreads();  // s_mat, s_sky staged (also when the list is empty)

  if (live) {
    // the winner's row is read from the table in global memory (and L2)
    const SceneTables sc = {tris, sphs, s_mat, s_sky, 0, p.n_sph, p.num_mats};
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

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// `lanes` rays per block; r_pad must be a whole number of blocks. With `sel`
// (max_depth, n_sel) int32 the recording instantiation runs and writes row
// `bounce` of it for the live rays.
extern "C" int ptre_wave_bounce(const ptre::WaveParams* params,
                                const float* state, const int32_t* ids,
                                const int32_t* shortlist, const int32_t* counts,
                                const float* tris, const float* sphs,
                                const float* mats, const float* sky,
                                const float* urand, float* out, int32_t* sel,
                                int lanes, void* stream) {
  const ptre::WaveParams p = *params;
  if (p.n_leaf < 0 || p.n_sph < 0 || p.num_mats > ptre::kMaxMats || lanes < 32 ||
      lanes > ptre::kMaxLanes || lanes % 32 != 0 || p.r_pad % lanes != 0 ||
      (p.external_rng && urand == nullptr) ||
      (sel != nullptr && (p.n_sel < 1 || p.sph_offset < 0 || p.bounce < 0)) ||
      reinterpret_cast<uintptr_t>(tris) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (sel != nullptr) {
    ptre::wave_bounce_kernel<true><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, ids, shortlist, counts, tris, sphs, mats, sky, urand, out, sel);
  } else {
    ptre::wave_bounce_kernel<false><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, ids, shortlist, counts, tris, sphs, mats, sky, urand, out, sel);
  }
  return (int)cudaGetLastError();
}
