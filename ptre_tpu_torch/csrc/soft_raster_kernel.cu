// SoftRas forward and backward kernels for Hopper (sm_90a).
//
// Replace the TPU kernels ptre_tpu/ops/pallas/soft_raster.py
// _soft_fwd_kernel (:144, launched at :354) and _soft_bwd_kernel (:251,
// launched at :376). Both use the hard kernel's tiling: one CUDA block per
// 16 x 16 tile of window samples, one thread per sample, every chunk of the
// Morton-sorted soft table gated by its box dilated 14 sigma against the
// tile (raster.cuh chunk_hits, block-uniform), a passing chunk's 64 rows
// staged in shared memory (8 KB).
//
// Forward: each thread keeps its online-softmax state (m, D, W, Nr, Ng, Nb)
// in registers and takes the chunk's rows 8 at a time (raster.cuh
// soft_group, the reference's group update with its empty-state guards), then
// writes the image and the six residual planes. A skipped chunk adds nothing
// to a sample: its pairs are below the coverage threshold, and a group that
// adds nothing leaves the state bit for bit as it was.
//
// Backward: the same chunks again. Each thread rebuilds its softmax terms
// from the residuals and the image cotangent once, then per row of a staged
// chunk recomputes the pair terms and applies the hand-written adjoint
// (raster.cuh pair_backward). The 26 gradient columns of the row are summed
// over the warp by shuffles (a warp with no pair above the threshold skips
// them, __any_sync), lane 0 adds the warp's sums into a shared accumulator
// for the chunk (64 x 26 floats), and after the chunk the block adds each
// non-zero accumulator entry into d(table) with one global atomicAdd. This
// replaces the TPU's carry of d(table) across its sequential grid
// (:268-270, :338), which blocks running in parallel do not have; the float
// atomics sum in no fixed order, so d(table) varies from run to run at float
// rounding.
//
// Built with -fmad=false. With a*b+c contracted, at 150x90 samples of the
// demo scene the d(inverse squared edge length) of a few sliver triangles
// put d(table) 23 % (relative L2) off the plain version and the image 1.4e-5
// off (1.2e-4 at 2560x1440); uncontracted, 1e-5 and 1.2e-7 at 150x90.
//
// What bounds them on this card. The functions are bound by bytes: 9 planes
// x 4 B per sample written (forward) or read (backward) outweigh the pairs
// their inputs need (a sample inside the row's box dilated 14 sigma: ~7.0 M
// pairs on the 1,932-triangle demo scene at 2560 x 1440, ~3.2 M of them
// above the coverage threshold). These kernels are bound instead by float32
// ALU work: a forward pair costs ~150 operations (three edge distances with
// a square root each, an exponential, a sigmoid, a normalisation), a
// backward pair ~400 plus the warp reduction, and they evaluate all
// 256 x 64 pairs of a visited (block, chunk) pair, ~2 % of which lie inside
// the row's dilated box on that scene. The design spends registers on the
// per-sample state and the pair's intermediates instead of shared memory
// (16 KB a block), and keeps the global atomics to one per non-zero
// (row, column) per block and chunk.

#include <cuda_runtime.h>

#include "raster.cuh"

namespace ptre {
namespace rast {

constexpr int kThreads = kTile * kTile;

__global__ void __launch_bounds__(kThreads)
    soft_fwd_kernel(const RasterParams p, const float* __restrict__ tris,
                    const float* __restrict__ cbox, float* __restrict__ img,
                    float* __restrict__ res) {
  __shared__ __align__(16) float s_rows[kChunk * kRow];
  const BlockTile t = block_tile(p);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const SoftScal<float> k = soft_scal<float>(p.scal);

  SoftState st = soft_state_init();
  for (int kc = 0; kc < p.n_chunks; ++kc) {
    if (!chunk_hits(cbox + kc * kBoxStride, t.x_lo, t.x_hi, t.y_first, t.y_last)) continue;
    __syncthreads();
    stage_chunk(s_rows, tris, kc, tid);
    __syncthreads();
    if (t.in) soft_sweep(s_rows, t.px, t.py, k, st);
  }
  if (!t.in) return;

  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  const int64_t s = (int64_t)t.r * p.width_ss + t.x;
  float rgb[3];
  soft_color(st, p.scal, rgb);
  for (int c = 0; c < 3; ++c) img[c * plane + s] = rgb[c];
  res[s] = st.m;
  res[plane + s] = st.D;
  res[2 * plane + s] = st.W;
  for (int c = 0; c < 3; ++c) res[(3 + c) * plane + s] = st.N[c];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    soft_bwd_kernel(const RasterParams p, const float* __restrict__ tris,
                    const float* __restrict__ cbox, const float* __restrict__ res,
                    const float* __restrict__ dimg, float* __restrict__ dtab) {
  __shared__ __align__(16) float s_rows[kChunk * kRow];
  __shared__ float s_acc[kChunk * kGradCols];
  const BlockTile t = block_tile(p);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31;
  const SoftScal<float> k = soft_scal<float>(p.scal);

  SoftRowState<float> st = {};
  if (t.in) {
    const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
    const int64_t s = (int64_t)t.r * p.width_ss + t.x;
    float rv[6], gv[3];
    for (int c = 0; c < 6; ++c) rv[c] = res[c * plane + s];
    for (int c = 0; c < 3; ++c) gv[c] = dimg[c * plane + s];
    st = soft_row_state(rv, gv, p.scal);
  }

  for (int kc = 0; kc < p.n_chunks; ++kc) {
    if (!chunk_hits(cbox + kc * kBoxStride, t.x_lo, t.x_hi, t.y_first, t.y_last)) continue;
    __syncthreads();  // the previous chunk's accumulator is flushed
    stage_chunk(s_rows, tris, kc, tid);
    for (int i = tid; i < kChunk * kGradCols; i += kThreads) s_acc[i] = 0.0f;
    __syncthreads();
    for (int i = 0; i < kChunk; ++i) {
      const float* c = s_rows + i * kRow;
      if (!(c[12] > 0.5f)) continue;  // a dropped row: uniform over the block
      float g[kRow] = {};
      const bool live = t.in && pair_backward(c, t.px, t.py, k, st, g);
      if (!__any_sync(0xffffffffu, live)) continue;
#pragma unroll
      for (int j = 0; j < kGradCols; ++j) {
        const float v = warp_sum(live ? g[grad_col(j)] : 0.0f);
        if (lane == 0 && v != 0.0f) atomicAdd(&s_acc[i * kGradCols + j], v);
      }
    }
    __syncthreads();
    float* dst = dtab + (int64_t)kc * kChunk * kRow;
    for (int i = tid; i < kChunk * kGradCols; i += kThreads) {
      const float v = s_acc[i];
      if (v != 0.0f) atomicAdd(&dst[(i / kGradCols) * kRow + grad_col(i % kGradCols)], v);
    }
  }
}

}  // namespace rast
}  // namespace ptre

// C interfaces for ctypes. Launch on the caller's stream, allocate nothing,
// do not synchronise; return cudaGetLastError() of the launch. `dtab` must
// be zeroed by the caller (the kernel adds into it).
extern "C" int ptre_soft_fwd(const ptre::rast::RasterParams* params, const float* tris,
                             const float* cbox, float* img, float* res, void* stream) {
  using namespace ptre::rast;
  const RasterParams p = *params;
  if (const int rc = check_launch(p, tris)) return rc;
  soft_fwd_kernel<<<tile_grid(p), dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(
      p, tris, cbox, img, res);
  return (int)cudaGetLastError();
}

extern "C" int ptre_soft_bwd(const ptre::rast::RasterParams* params, const float* tris,
                             const float* cbox, const float* res, const float* dimg,
                             float* dtab, void* stream) {
  using namespace ptre::rast;
  const RasterParams p = *params;
  if (const int rc = check_launch(p, tris)) return rc;
  soft_bwd_kernel<<<tile_grid(p), dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(
      p, tris, cbox, res, dimg, dtab);
  return (int)cudaGetLastError();
}
