// Wavefront cull-mask kernel for Hopper (sm_90a): for each (ray block, leaf)
// the slab verdict, ORed over the block's live rays.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/wavefront.py _mask_kernel
// (:102, launched at :164). One CUDA block per ray block of `lanes` rays,
// one thread per ray of the sorted state. A block with no live ray reads no
// box. Each warp walks two levels for its own 32 rays: the
// union box of every supertile of kSuper = 8 Morton-consecutive leaves
// (wave.cuh super_union), and the leaves of a supertile that some live lane
// passes; a leaf's verdict is the warp's __any_sync over its live lanes. A
// warp keeps its verdicts as a bit mask in a register, one 32-leaf word at a
// time, and merges a word into the block's shared bit mask by atomicOr when
// it moves to the next; it skips a supertile whose leaves are all listed
// already and a leaf that is, by itself or another warp (the verdict is an
// OR, so the result does not depend on the order). A warp with no live ray
// tests nothing. After one barrier the block writes its verdicts in one of
// two forms (template flag kLists): its shortlist, the ascending ids of the
// listed leaves, and their count (wave.cuh bits_to_list: a scan of the
// words' popcounts, then each word's bits at its offset), which the bounce
// kernel reads (ptre_wave_mask_lists, wavefront.wave_mask_lists); or the
// dense (nb, n_leaf) byte row, coalesced (ptre_wave_mask, wavefront.
// wave_mask), for the checks that compare verdicts. A block with no live ray
// writes a count of 0, or n_leaf zero bytes. shortlist_rows_kernel runs the
// same routine on a dense bool mask made elsewhere (bounce 0's screen
// binning, wavefront.shortlists_from_mask), a row a block.
//
// Two instantiations of that walk, by where the boxes are read:
//   * staged, n_leaf <= kMaxMaskLeaves: the block stages the leaf boxes of
//     pack_tile_boxes (n_leaf x 8 floats, ~8 KB for a 16k-triangle scene)
//     into static shared memory and forms there the supertiles' boxes;
//   * global, any n_leaf: the leaf boxes and the supertile boxes, formed
//     once a scene (wavefront.prepare_scene's mask_supers,
//     megakernel.pack_super_boxes), are read through L1/L2, as the sweep,
//     the bounce kernel's cull and the culled megakernel read theirs; only
//     the bit mask, n_leaf / 8 bytes, is in (dynamic) shared memory, so a
//     block needs 512 B at 4,080 leaves and the 227 KB an sm_90 block may
//     opt in to at wavefront.MAX_MASK_LEAVES (1,859,584 leaves). Staging
//     the boxes in dynamic shared memory instead (chip_ablations.py mask)
//     copies 32 B a leaf into every block, where a block reads only the
//     supertiles' boxes and the leaves of those its warps pass.
//
// Why the verdicts are the plain version's (wavefront.wave_mask_reference,
// every leaf for every live ray): a supertile's box contains each of its
// leaf boxes (the min and max of their corners), slab_inv is finite and
// non-zero, and the slab test subtracts and multiplies with no a*b+c, each
// rounded to nearest, which is monotone: on every axis the wider box gives a
// t_near no later and a t_far no earlier. So a ray that passes a leaf passes
// its supertile, and skipping the leaves of a supertile no live lane passes
// drops no verdict. tests/test_torch_csrc_host.py holds csrc/host_wave.cpp's
// copy of this walk (both sources of the supertile boxes) to the plain
// version on adversarial rays (+-0 direction components, origins on a face
// and inside a box, zero-thickness and empty leaves, t_min at a box's exit),
// past kMaxMaskLeaves too.
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
// 8-ray sublane chunks, 128-lane verdict groups, the f32 verdicts and the
// whole box table resident in every block (the reference's VMEM budget).

#include <cuda_runtime.h>

#include <algorithm>

#include "wave.cuh"

namespace ptre {

// the staged instantiation: with the supertiles' boxes 36 KB of static
// shared memory
constexpr int kMaxMaskLeaves = 1024;
constexpr int kMaskWords = kMaxMaskLeaves / 32;
constexpr int kMaxMaskSupers = kMaxMaskLeaves / kSuper;
constexpr unsigned kMaskFull = 0xffffffffu;

// slab_pass of a 16-byte aligned box row in shared or global memory, read as
// two 16-byte words (the same six values, the same arithmetic).
__device__ __forceinline__ bool box_pass(const float* box, const float o[3],
                                         const float iv[3], float t_min) {
  const float4 a = reinterpret_cast<const float4*>(box)[0];
  const float4 b = reinterpret_cast<const float4*>(box)[1];
  const float lohi[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
  return slab_pass(lohi, o, iv, t_min);
}

// One warp's two-level walk over the supertiles for its live lanes, into
// the block's bit mask `bits`: `leaf_boxes` (n_leaf rows) and `super_boxes`
// (n_super rows) of kBoxStride floats, 16-byte aligned, in shared or global
// memory. Every lane of the warp calls it; the votes are uniform over it.
template <bool kStats>
__device__ __forceinline__ void mask_walk(const MaskParams& p, int n_super,
                                          const float* leaf_boxes,
                                          const float* super_boxes, unsigned* bits,
                                          bool live, const float o[3], const float dir[3],
                                          unsigned long long* stats) {
  const int lane = threadIdx.x & 31;
  const unsigned live_lanes = __ballot_sync(kMaskFull, live);
  if (live_lanes == 0u) return;  // warp-uniform: a warp with no live ray tests nothing
  const float iv[3] = {slab_inv(dir[0]), slab_inv(dir[1]), slab_inv(dir[2])};
  unsigned long long n_sup_tests = 0, n_leaf_tests = 0;
  unsigned word = 0u;  // this warp's verdicts of the leaves of word `w`
  int w = 0;
  for (int s = 0; s < n_super; ++s) {
    const int l0 = s * kSuper;
    if ((l0 >> 5) != w) {
      if (lane == 0 && word != 0u) atomicOr(&bits[w], word);
      word = 0u;
      w = l0 >> 5;
    }
    const int n_in = min(kSuper, p.n_leaf - l0);
    const unsigned own = ((1u << n_in) - 1u) << (l0 & 31);
    // the leaves listed already, by this warp or another: one read, the
    // same value in every lane
    const unsigned done =
        (word | __shfl_sync(kMaskFull, *(volatile unsigned*)&bits[w], 0)) & own;
    if (done == own) continue;
    if (kStats) ++n_sup_tests;
    if (!__any_sync(kMaskFull,
                    live && box_pass(super_boxes + s * kBoxStride, o, iv, p.t_min))) {
      continue;
    }
    for (int j = 0; j < n_in; ++j) {
      const unsigned bit = 1u << ((l0 + j) & 31);
      if ((done & bit) != 0u) continue;
      if (kStats) ++n_leaf_tests;
      if (__any_sync(kMaskFull,
                     live && box_pass(leaf_boxes + (l0 + j) * kBoxStride, o, iv, p.t_min))) {
        word |= bit;
      }
    }
  }
  if (lane == 0 && word != 0u) atomicOr(&bits[w], word);
  if (kStats && lane == 0) {
    const unsigned long long n_live = __popc(live_lanes);
    atomicAdd(&stats[0], n_sup_tests * n_live);
    atomicAdd(&stats[1], n_leaf_tests * n_live);
    atomicAdd(&stats[2], n_live);
  }
}

// Where a launch writes the verdicts: `mask`, (nb, n_leaf) bytes, or, with
// kLists, `list` (nb, n_leaf) int32 (row b's [0, count[b]) written) and
// `count` (nb,).
struct MaskOut {
  uint8_t* mask;
  int32_t* list;
  int32_t* count;
};

// The block's verdicts, its bit mask `bits` (at least kListScratch words),
// written as `out` asks; a block with no live ray passes null `bits`. Every
// thread of the block calls it.
template <bool kLists>
__device__ __forceinline__ void write_verdicts(const MaskParams& p, unsigned* bits,
                                               const MaskOut& out) {
  const int tid = threadIdx.x;
  if (kLists) {
    if (bits == nullptr) {
      if (tid == 0) out.count[blockIdx.x] = 0;
      return;
    }
    bits_to_list(bits, (p.n_leaf + 31) / 32, out.list + (int64_t)blockIdx.x * p.n_leaf,
                 out.count + blockIdx.x);
    return;
  }
  uint8_t* row = out.mask + (int64_t)blockIdx.x * p.n_leaf;
  for (int l = tid; l < p.n_leaf; l += blockDim.x)
    row[l] = bits == nullptr ? 0 : (bits[l >> 5] >> (l & 31)) & 1u;
}

// The staged instantiation: n_leaf <= kMaxMaskLeaves.
template <bool kStats, bool kLists>
__global__ void __launch_bounds__(kMaxLanes)
    wave_mask_kernel(const MaskParams p, const float* __restrict__ state,
                     const float* __restrict__ boxes, const MaskOut out,
                     unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float s_box[kMaxMaskLeaves * kBoxStride];
  __shared__ __align__(16) float s_sup[kMaxMaskSupers * kBoxStride];
  __shared__ unsigned s_bits[kMaskWords];
  static_assert(kMaskWords >= kListScratch, "the shortlist's scratch");
  const int tid = threadIdx.x;
  const int n_super = (p.n_leaf + kSuper - 1) / kSuper;

  const int64_t col = (int64_t)blockIdx.x * blockDim.x + tid;
  const bool live = state[9 * (int64_t)p.r_pad + col] > 0.5f;
  // a block with no live ray reads no box
  if (!__syncthreads_or(live)) {
    write_verdicts<kLists>(p, nullptr, out);
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

  mask_walk<kStats>(p, n_super, s_box, s_sup, s_bits, live, o, dir, stats);
  __syncthreads();
  write_verdicts<kLists>(p, s_bits, out);
}

// The global instantiation: any n_leaf past kMaxMaskLeaves. `supers` holds
// the n_super = ceil(n_leaf / kSuper) supertile boxes of `boxes`; the
// dynamic shared memory, ceil(n_leaf / 32) words, the block's bit mask.
template <bool kStats, bool kLists>
__global__ void __launch_bounds__(kMaxLanes)
    wave_mask_global_kernel(const MaskParams p, const float* __restrict__ state,
                            const float* __restrict__ boxes,
                            const float* __restrict__ supers, const MaskOut out,
                            unsigned long long* __restrict__ stats) {
  extern __shared__ unsigned s_words[];
  const int tid = threadIdx.x;
  const int n_super = (p.n_leaf + kSuper - 1) / kSuper;
  const int n_words = (p.n_leaf + 31) / 32;

  const int64_t col = (int64_t)blockIdx.x * blockDim.x + tid;
  const bool live = state[9 * (int64_t)p.r_pad + col] > 0.5f;
  if (!__syncthreads_or(live)) {
    write_verdicts<kLists>(p, nullptr, out);
    return;
  }
  float o[3], dir[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = state[k * (int64_t)p.r_pad + col];
    dir[k] = state[(3 + k) * (int64_t)p.r_pad + col];
  }
  for (int i = tid; i < n_words; i += blockDim.x) s_words[i] = 0u;
  __syncthreads();

  mask_walk<kStats>(p, n_super, boxes, supers, s_words, live, o, dir, stats);
  __syncthreads();
  write_verdicts<kLists>(p, s_words, out);
}

// Launches the global instantiation with its bit mask's words of dynamic
// shared memory, opting in past the 48 KB a launch gets without asking.
template <bool kStats, bool kLists>
cudaError_t launch_mask_global(int n_blocks, int lanes, cudaStream_t st, const MaskParams& p,
                               const float* state, const float* boxes, const float* supers,
                               const MaskOut& out, unsigned long long* stats) {
  const size_t bytes = sizeof(unsigned) * (size_t)((p.n_leaf + 31) / 32);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wave_mask_global_kernel<kStats, kLists>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (rc != cudaSuccess) return rc;
  }
  wave_mask_global_kernel<kStats, kLists><<<n_blocks, lanes, bytes, st>>>(p, state, boxes,
                                                                          supers, out, stats);
  return cudaGetLastError();
}

// One launch of either instantiation, by n_leaf, with or without counting.
template <bool kLists>
int launch_mask(const MaskParams* params, const float* state, const float* boxes,
                const float* supers, const MaskOut& out, unsigned long long* stats, int lanes,
                void* stream) {
  const MaskParams p = *params;
  if (p.n_leaf < 1 || lanes < 32 || lanes > kMaxLanes || lanes % 32 != 0 ||
      p.r_pad % lanes != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_blocks = p.r_pad / lanes;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.n_leaf > kMaxMaskLeaves) {
    if (supers == nullptr || reinterpret_cast<uintptr_t>(supers) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(boxes) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    return (int)(stats != nullptr
                     ? launch_mask_global<true, kLists>(n_blocks, lanes, st, p, state, boxes,
                                                        supers, out, stats)
                     : launch_mask_global<false, kLists>(n_blocks, lanes, st, p, state, boxes,
                                                         supers, out, nullptr));
  }
  if (stats != nullptr) {
    wave_mask_kernel<true, kLists><<<n_blocks, lanes, 0, st>>>(p, state, boxes, out, stats);
  } else {
    wave_mask_kernel<false, kLists><<<n_blocks, lanes, 0, st>>>(p, state, boxes, out, nullptr);
  }
  return (int)cudaGetLastError();
}

// The shortlist of each row of a dense (nb, n_leaf) bool mask, a block of
// kMaxLanes threads a row: a warp reads 32 consecutive bytes and its ballot
// is the row's word, then bits_to_list. The dynamic shared memory holds
// max(ceil(n_leaf / 32), kListScratch) words.
__global__ void __launch_bounds__(kMaxLanes)
    shortlist_rows_kernel(const uint8_t* __restrict__ mask, int n_leaf,
                          int32_t* __restrict__ list, int32_t* __restrict__ count) {
  extern __shared__ unsigned s_words[];
  const int n_words = (n_leaf + 31) / 32;
  const uint8_t* row = mask + (int64_t)blockIdx.x * n_leaf;
  for (int l0 = 0; l0 < n_words * 32; l0 += blockDim.x) {
    const int l = l0 + threadIdx.x;
    const unsigned word = __ballot_sync(kFullWarp, l < n_leaf && row[l] != 0);
    if ((threadIdx.x & 31) == 0 && l < n_words * 32) s_words[l >> 5] = word;
  }
  __syncthreads();
  bits_to_list(s_words, n_words, list + (int64_t)blockIdx.x * n_leaf, count + blockIdx.x);
}

}  // namespace ptre

// Leaves the staged instantiation takes (kMaxMaskLeaves); more take the
// global one (wavefront.py counts those launches in mask_launches_global).
extern "C" int ptre_wave_mask_max_staged_leaves() { return ptre::kMaxMaskLeaves; }

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// `lanes` rays per block; r_pad must be a whole number of blocks. `supers`:
// the ceil(n_leaf / 8) supertile boxes of `boxes` (megakernel.
// pack_super_boxes), read past kMaxMaskLeaves leaves, where it and `boxes`
// must be 16-byte aligned; may be null at or below it. `stats`: null, or
// three zeroed uint64 counters (the counting instantiation): the supertile
// tests and the leaf tests, each times the warp's live rays, and the live
// rays. ptre_wave_mask writes the dense (r_pad / lanes, n_leaf) byte mask.
extern "C" int ptre_wave_mask(const ptre::MaskParams* params, const float* state,
                              const float* boxes, const float* supers, uint8_t* mask,
                              unsigned long long* stats, int lanes, void* stream) {
  const ptre::MaskOut out = {mask, nullptr, nullptr};
  return ptre::launch_mask<false>(params, state, boxes, supers, out, stats, lanes, stream);
}

// The same launch writing each block's shortlist instead: row b of `list`
// ((r_pad / lanes, n_leaf) int32) holds the ascending ids of the leaves
// block b lists in [0, count[b]) and is not written past them.
extern "C" int ptre_wave_mask_lists(const ptre::MaskParams* params, const float* state,
                                    const float* boxes, const float* supers, int32_t* list,
                                    int32_t* count, unsigned long long* stats, int lanes,
                                    void* stream) {
  const ptre::MaskOut out = {nullptr, list, count};
  return ptre::launch_mask<true>(params, state, boxes, supers, out, stats, lanes, stream);
}

// The shortlists of the nb rows of a dense (nb, n_leaf) bool mask (one byte,
// 0 or 1, a leaf), as ptre_wave_mask_lists writes them. n_leaf at most
// wavefront.MAX_MASK_LEAVES (the words in a block's shared memory).
extern "C" int ptre_shortlists(const uint8_t* mask, int nb, int n_leaf, int32_t* list,
                               int32_t* count, void* stream) {
  if (nb < 0 || n_leaf < 1) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const size_t bytes =
      sizeof(unsigned) * (size_t)std::max((n_leaf + 31) / 32, ptre::kListScratch);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ptre::shortlist_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  ptre::shortlist_rows_kernel<<<nb, ptre::kMaxLanes, bytes, (cudaStream_t)stream>>>(
      mask, n_leaf, list, count);
  return (int)cudaGetLastError();
}
