// Wavefront bounce kernel for Hopper (sm_90a): one bounce of a sorted ray
// block, each ray sweeping only the leaves of the block's shortlist whose box
// it passes itself.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/wavefront.py _wave_kernel
// (:209, launched at :486). One CUDA block per ray block, one thread per
// ray. The block walks its shortlist (leaf ids, ascending, from the mask
// kernel: some ray of the block passes the leaf's box). Each leaf's 64
// compact intersection rows (3 KB: v0, e1, e2, valid; wave.cuh kRowStride)
// are staged into one of two shared buffers with cp.async while the leaf
// before it is swept, one barrier a leaf. Before a leaf's rows, each live
// thread runs the slab test of its own ray against the leaf's box, bounded
// by its closest hit so far (slab_pass_within, on the dilated cull boxes),
// and only a ray that passes runs the 64 tests; a warp whose lanes all fail
// skips the leaf. Tests keep strict t < best (ties go to the lowest Morton
// row, within a leaf and across the ascending list). Then, per thread
// (wave.cuh finish_bounce): spheres bounded by the best triangle, the
// winner's 32-float row read by index from global memory, its attributes
// re-derived, shading (trace.cuh scatter_shade / sky_color: the material
// row by index, from shared memory up to 8 materials, else from the table
// in global memory) and the next state. Dead rays pass through unchanged;
// a block without a live ray copies its state and stops. The recording
// instantiation (wavefront.py:345-349, `record_sel`) also writes each live
// ray's winner, as a unified-table row or -1, straight to the ray's slot of
// this bounce's selection row by its original id: the ids already ride the
// sort, so nothing else has to (the TPU let four selection rows per bounce
// ride every later sort and scattered once at the end).
//
// What bounds it on this card: divergent float32 ALU work in the sweep, not
// bytes. The shortlist is a block verdict; the first design made every live
// thread test all 64 rows of every listed leaf (measured 4.61-4.71 ms a
// bounce at config 4's bounce-1 state, 1920x1080, NVIDIA H100 80GB HBM3,
// 700.00 W). The ray's own box test removes the (ray, leaf) pairs whose box
// the ray misses or meets only beyond its closest hit, for one slab test a
// pair; staging the 12-float rows instead of the 32-float ones moves 3 KB a
// leaf instead of 8 KB, and the double buffer hides it behind the previous
// leaf's tests. The table (48 B a row, 0.8 MB at config 4) and the 32-float
// rows stay in the 50 MB L2; the state is 40 B a ray in and out. Every
// thread, dead or ragged, takes part in every staging barrier. The selection
// equals the first design's: the box dilation makes the per-ray cull
// conservative (wavefront.CULL_PAD_REL).
//
// Not carried over from the TPU kernel: the (12, lanes) transposed state,
// groups of 4 leaves per accumulator round trip, the trailing all-invalid
// pad leaf, f32 ids (ids are int32 here), 2B rows of uniforms riding the
// sort (Philox regenerates them from the ray id), and the one-hot MXU
// gathers of the winner (a direct row read).

#include <cuda_runtime.h>

#include "wave.cuh"

namespace ptre {

// Asynchronous staging of a leaf's rows from global to shared memory
// (cp.async): a copy is issued, overlaps the sweep of the leaf staged
// before it, and is waited for before its rows are read.
//
// Copy 16 bytes global -> shared without passing through registers; both
// addresses 16-byte aligned. Cached in L2 only (.cg): a leaf is read once a
// block, and the table stays in L2.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// Close the copies this thread issued since the last commit into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` of this thread's groups are still in flight.
// Another thread's copies are visible only after a barrier that follows it.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage `n16` 16-byte chunks from `src` to `dst`, chunk k by thread k modulo
// `n_threads`, as one committed group (possibly empty) per thread.
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n16, int tid,
                                            int n_threads) {
  for (int k = tid; k < n16; k += n_threads) cp_async16(dst + 4 * k, src + 4 * k);
  cp_async_commit();
}

template <bool kRecord>
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
                       int32_t* __restrict__ sel) {
  constexpr int kLeafFloats = kLeaf * kRowStride;
  __shared__ __align__(16) float s_rows[2][kLeafFloats];
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

  TriBest best = {kBig, 0, false};
  const float iv[3] = {slab_inv(r.d[0]), slab_inv(r.d[1]), slab_inv(r.d[2])};
  const int n = counts[blockIdx.x];
  const int32_t* list = shortlist + (int64_t)blockIdx.x * p.list_stride;
  if (n > 0) {
    stage_async(s_rows[0], rows + (int64_t)list[0] * kLeafFloats, kLeafFloats / 4, tid,
                blockDim.x);
  }
  for (int k = 0; k < n; ++k) {
    const int leaf = list[k];
    cp_async_wait<0>();
    // leaf k's rows are visible to every thread, and every thread is done
    // with leaf k - 1's buffer, which the next copy overwrites
    __syncthreads();
    if (k + 1 < n) {
      stage_async(s_rows[(k + 1) & 1], rows + (int64_t)list[k + 1] * kLeafFloats,
                  kLeafFloats / 4, tid, blockDim.x);
    }
    // the ray's own cull; a warp whose lanes all fail skips the 64 tests
    if (live && slab_pass_within(boxes + leaf * kBoxStride, r.o, iv, p.t_min, best.t)) {
      sweep_leaf(s_rows[k & 1], leaf, r, p, best);
    }
  }
  __syncthreads();  // s_mat, s_sky staged (also when the list is empty)

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
  if (p.n_leaf < 0 || p.n_sph < 0 || p.num_mats > ptre::kMaxMaterials || lanes < 32 ||
      lanes > ptre::kMaxLanes || lanes % 32 != 0 || p.r_pad % lanes != 0 ||
      (p.external_rng && urand == nullptr) ||
      (sel != nullptr && (p.n_sel < 1 || p.sph_offset < 0 || p.bounce < 0)) ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (sel != nullptr) {
    ptre::wave_bounce_kernel<true><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats, sky, urand, out,
        sel);
  } else {
    ptre::wave_bounce_kernel<false><<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
        p, state, ids, shortlist, counts, tris, rows, boxes, sphs, mats, sky, urand, out,
        sel);
  }
  return (int)cudaGetLastError();
}
