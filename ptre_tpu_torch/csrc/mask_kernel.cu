// Wavefront cull-mask kernel for Hopper (sm_90a): for each (ray block, leaf)
// the slab verdict, ORed over the block's live rays.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/wavefront.py _mask_kernel
// (:102, launched at :164). One CUDA block per ray block of `lanes` rays,
// one thread per ray of the sorted state. A block with no live ray reads no
// box and writes zeros. Otherwise the leaf boxes of pack_tile_boxes (n_leaf
// x 8 floats, ~8 KB for a 16k-triangle scene) are staged into shared memory
// and the block forms there the union box of every supertile of kSuper = 8
// Morton-consecutive leaves (wave.cuh super_union). Each warp then walks
// two levels for its own 32 rays: a supertile's box, and the leaves of a
// supertile that some live lane passes; a leaf's verdict is the warp's
// __any_sync over its live lanes. A warp keeps its verdicts as a bit mask
// in a register, one 32-leaf word at a time, and merges a word into the
// block's shared bit mask by atomicOr when it moves to the next; it skips a
// supertile whose leaves are all listed already and a leaf that is, by
// itself or another warp (the verdict is an OR, so the result does not
// depend on the order). A warp with no live ray tests nothing. After one
// barrier the block writes its n_leaf bytes, coalesced. Output: the dense
// (nb, n_leaf) uint8 mask that PyTorch compacts into shortlists
// (wavefront.shortlists_from_mask).
//
// Why the verdicts are the plain version's (wavefront.wave_mask_reference,
// every leaf for every live ray): a supertile's box contains each of its
// leaf boxes (the min and max of their corners), slab_inv is finite and
// non-zero, and the slab test subtracts and multiplies with no a*b+c, each
// rounded to nearest, which is monotone: on every axis the wider box gives a
// t_near no later and a t_far no earlier. So a ray that passes a leaf passes
// its supertile, and skipping the leaves of a supertile no live lane passes
// drops no verdict. tests/test_torch_csrc_host.py holds csrc/host_wave.cpp's
// copy of this walk to the plain version on adversarial rays (+-0 direction
// components, origins on a face and inside a box, zero-thickness and empty
// leaves, t_min at a box's exit).
//
// What bounds it on this card: the ray state read once (o, d, active: 28 B
// a ray) against the slab tests the verdicts need — every live ray's
// supertile tests and the leaf tests of the supertiles its warp passes; in
// practice the warps' chains of votes (a supertile's test, then its
// leaves', one after another). The first design tested every (live ray,
// leaf) pair, with one block barrier and a one-byte store a leaf. Three
// other designs measured no faster in sum over a config-4 sample (PERF.md
// §6): the live rays compacted and walked by the first warps only;
// warps owning supertiles over chunks of the compacted rays; and the
// (chunk, supertile) pairs shared by the block's live count. With `stats`
// given, a separate instantiation counts the supertile and leaf tests made
// (each times the warp's live rays) and the live rays, for chip_smoke.py's
// bound; a launch without `stats` counts nothing.
//
// Not carried over from the TPU kernel: the transposed 16-column state,
// 8-ray sublane chunks, 128-lane verdict groups and the f32 verdicts.

#include <cuda_runtime.h>

#include "wave.cuh"

namespace ptre {

constexpr int kMaxMaskLeaves = 1024;  // with the supertiles' boxes 36 KB of shared memory
constexpr int kMaskWords = kMaxMaskLeaves / 32;
constexpr int kMaxMaskSupers = kMaxMaskLeaves / kSuper;
constexpr unsigned kMaskFull = 0xffffffffu;

// slab_pass of a 16-byte aligned box row in shared memory, read as two
// 16-byte words (the same six values, the same arithmetic).
__device__ __forceinline__ bool box_pass(const float* box, const float o[3],
                                         const float iv[3], float t_min) {
  const float4 a = reinterpret_cast<const float4*>(box)[0];
  const float4 b = reinterpret_cast<const float4*>(box)[1];
  const float lohi[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
  return slab_pass(lohi, o, iv, t_min);
}

template <bool kStats>
__global__ void __launch_bounds__(kMaxLanes)
    wave_mask_kernel(const MaskParams p, const float* __restrict__ state,
                     const float* __restrict__ boxes, uint8_t* __restrict__ mask,
                     unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float s_box[kMaxMaskLeaves * kBoxStride];
  __shared__ __align__(16) float s_sup[kMaxMaskSupers * kBoxStride];
  __shared__ unsigned s_bits[kMaskWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_super = (p.n_leaf + kSuper - 1) / kSuper;

  const int64_t col = (int64_t)blockIdx.x * blockDim.x + tid;
  const bool live = state[9 * (int64_t)p.r_pad + col] > 0.5f;
  uint8_t* row = mask + (int64_t)blockIdx.x * p.n_leaf;
  // a block with no live ray reads no box
  if (!__syncthreads_or(live)) {
    for (int l = tid; l < p.n_leaf; l += blockDim.x) row[l] = 0;
    return;
  }
  float o[3], dir[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = state[k * (int64_t)p.r_pad + col];
    dir[k] = state[(3 + k) * (int64_t)p.r_pad + col];
  }
  for (int i = tid; i < p.n_leaf * kBoxStride; i += blockDim.x) s_box[i] = boxes[i];
  for (int i = tid; i < kMaskWords; i += blockDim.x) s_bits[i] = 0u;
  __syncthreads();
  for (int s = tid; s < n_super; s += blockDim.x)
    super_union(s_box, p.n_leaf, s, s_sup + s * kBoxStride);
  __syncthreads();

  const unsigned live_lanes = __ballot_sync(kMaskFull, live);
  if (live_lanes != 0u) {  // warp-uniform: a warp with no live ray tests nothing
    const float iv[3] = {slab_inv(dir[0]), slab_inv(dir[1]), slab_inv(dir[2])};
    unsigned long long n_sup_tests = 0, n_leaf_tests = 0;
    unsigned word = 0u;  // this warp's verdicts of the leaves of word `w`
    int w = 0;
    for (int s = 0; s < n_super; ++s) {
      const int l0 = s * kSuper;
      if ((l0 >> 5) != w) {
        if (lane == 0 && word != 0u) atomicOr(&s_bits[w], word);
        word = 0u;
        w = l0 >> 5;
      }
      const int n_in = min(kSuper, p.n_leaf - l0);
      const unsigned own = ((1u << n_in) - 1u) << (l0 & 31);
      // the leaves listed already, by this warp or another: one read, the
      // same value in every lane
      const unsigned done =
          (word | __shfl_sync(kMaskFull, *(volatile unsigned*)&s_bits[w], 0)) & own;
      if (done == own) continue;
      if (kStats) ++n_sup_tests;
      if (!__any_sync(kMaskFull, live && box_pass(s_sup + s * kBoxStride, o, iv, p.t_min)))
        continue;
      for (int j = 0; j < n_in; ++j) {
        const unsigned bit = 1u << ((l0 + j) & 31);
        if ((done & bit) != 0u) continue;
        if (kStats) ++n_leaf_tests;
        if (__any_sync(kMaskFull,
                       live && box_pass(s_box + (l0 + j) * kBoxStride, o, iv, p.t_min))) {
          word |= bit;
        }
      }
    }
    if (lane == 0 && word != 0u) atomicOr(&s_bits[w], word);
    if (kStats && lane == 0) {
      const unsigned long long n_live = __popc(live_lanes);
      atomicAdd(&stats[0], n_sup_tests * n_live);
      atomicAdd(&stats[1], n_leaf_tests * n_live);
      atomicAdd(&stats[2], n_live);
    }
  }
  __syncthreads();
  for (int l = tid; l < p.n_leaf; l += blockDim.x) row[l] = (s_bits[l >> 5] >> (l & 31)) & 1u;
}

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// `lanes` rays per block; r_pad must be a whole number of blocks. `stats`:
// null, or three zeroed uint64 counters (the counting instantiation): the
// supertile tests and the leaf tests, each times the warp's live rays, and
// the live rays.
extern "C" int ptre_wave_mask(const ptre::MaskParams* params, const float* state,
                              const float* boxes, uint8_t* mask,
                              unsigned long long* stats, int lanes, void* stream) {
  const ptre::MaskParams p = *params;
  if (p.n_leaf < 1 || p.n_leaf > ptre::kMaxMaskLeaves || lanes < 32 ||
      lanes > ptre::kMaxLanes || lanes % 32 != 0 || p.r_pad % lanes != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (stats != nullptr) {
    ptre::wave_mask_kernel<true><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, boxes, mask, stats);
  } else {
    ptre::wave_mask_kernel<false><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, boxes, mask, nullptr);
  }
  return (int)cudaGetLastError();
}
