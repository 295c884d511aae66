// SoftRas forward and backward kernels for Hopper (sm_90a).
//
// Replace the TPU kernels ptre_tpu/ops/pallas/soft_raster.py
// _soft_fwd_kernel (:144, launched at :354) and _soft_bwd_kernel (:251,
// launched at :376). Both use the hard kernel's tiling: one CUDA block per
// 16 x 16 tile of window samples, one thread per sample, every chunk of the
// Morton-sorted soft table gated by its box dilated 14 sigma against the
// tile (raster.cuh chunk_hits, 32 chunks a ballot, block-uniform).
//
// Then a row gate per visited (tile, chunk) (gate_rows): threads 0-63 test
// one row each, keep and its gate box (the row's screen box, cols 23-26,
// dilated by 14 sigma from the 1/sigma scalar and grown by raster.cuh
// kGatePadRel) against the tile's extent, store the box in shared memory,
// and two ballots make the chunk's 64-bit row mask. A chunk whose mask is
// empty is not swept. Past the gate each thread evaluates a mask row only
// where the row's gate box holds its own sample: beyond it a pair's coverage
// is below the 1e-6 threshold (raster.cuh), so the pair adds nothing. Rows
// are read through L1/L2, not staged.
//
// Forward: each thread keeps its online-softmax state (m, D, W, Nr, Ng, Nb)
// in registers and takes the mask's rows 8 at a time, in the reference's
// groups and order (raster.cuh soft_sweep / soft_group); a row it does not
// evaluate enters its group as lm = -BIG, e = 0, exactly as the plain version
// computes it, and a group with no pair above the threshold leaves the state
// bit for bit as it was. The image and the six residual planes are those of
// an ungated sweep, bit for bit.
//
// Backward: the same chunks and masks again. Each thread rebuilds its softmax
// terms from the residuals and the image cotangent once, then per mask row
// whose gate box holds its sample recomputes the pair terms and applies the
// hand-written adjoint (raster.cuh pair_backward). The 26 gradient columns of
// the row are summed over the warp by shuffles (a warp with no pair above the
// threshold skips them, __any_sync), lane 0 adds the warp's sums into a
// shared accumulator for the chunk (64 x 26 floats), and after the chunk the
// block adds each non-zero accumulator entry into d(table) with one global
// atomicAdd, clearing it for the next chunk. This replaces the TPU's carry of
// d(table) across its sequential grid (:268-270, :338), which blocks running
// in parallel do not have; the float atomics sum in no fixed order, so
// d(table) varies from run to run at float rounding.
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
// above the coverage threshold), 0.040 ms. Without the row gate the kernels
// were bound by float32 ALU work instead: they evaluated all 256 x 64 pairs
// of every visited (block, chunk), 295 M on that scene, ~2.4 % of them in
// the row's dilated box, at ~170 operations a pair (three edge distances
// with a square root each, an exponential, a sigmoid, a normalisation) and
// the backward's adjoint (~270) on top: 3.14 and 4.55 ms (NVIDIA H100 80GB
// HBM3, 700 W). With the gate they evaluate 6.96 M pairs and take 0.22 and
// 0.45 ms. What is left: the pair math in IEEE square roots and divisions
// on warps whose samples straddle a box edge, each block's serial chain of
// chunk visits (two barriers around each row gate; testing the chunk boxes
// 32 at a time by ballot took ~19 % off both kernels), and the backward's
// warp sums and atomics. Staging the mask's rows in shared memory by
// cp.async measured slower (backward 1.22 against 0.68 ms). With `stats`
// given, a separate instantiation also counts the visited (block, chunk)
// pairs, the rows that pass the gate, the pairs evaluated and those above
// the threshold; a launch without `stats` counts nothing.

#include <cuda_runtime.h>

#include "raster.cuh"

namespace ptre {
namespace rast {

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
    soft_fwd_kernel(const RasterParams p, const float* __restrict__ tris,
                    const float* __restrict__ cbox, float* __restrict__ img,
                    float* __restrict__ res, unsigned long long* __restrict__ stats) {
  __shared__ GateBox s_box[kChunk];
  __shared__ unsigned s_mask[2];
  const BlockTile t = block_tile(p);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const SoftScal<float> k = soft_scal<float>(p.scal);
  const float dil = kDilateSigma / p.scal[12];
  unsigned long long visits = 0, rows_passed = 0;
  uint32_t n_eval = 0, n_inc = 0;

  SoftState st = soft_state_init();
  for_each_chunk(p, cbox, t, tid, [&](int kc) {
    const float* rows = tris + (int64_t)kc * kChunk * kRow;
    const uint64_t mask =
        gate_rows(rows, t, tid, s_box, s_mask, [&](const float* c) { return gate_box(c, dil); });
    if (kStats) {
      ++visits;
      rows_passed += __popcll(mask);
    }
    if (mask != 0 && t.in) soft_sweep(rows, s_box, mask, t.px, t.py, k, st, n_eval, n_inc);
  });
  if (kStats) add_stats(stats, tid, visits, rows_passed, n_eval, n_inc);
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
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Three blocks an SM: capped at 80 registers (180 B of spills) it ran 20 %
// faster than at 128 registers and two blocks an SM (chip_smoke.py phase
// 14, PERF.md section 6).
template <bool kStats>
__global__ void __launch_bounds__(kThreads, 3)
    soft_bwd_kernel(const RasterParams p, const float* __restrict__ tris,
                    const float* __restrict__ cbox, const float* __restrict__ res,
                    const float* __restrict__ dimg, float* __restrict__ dtab,
                    unsigned long long* __restrict__ stats) {
  __shared__ GateBox s_box[kChunk];
  __shared__ unsigned s_mask[2];
  __shared__ float s_acc[kChunk * kGradCols];
  const BlockTile t = block_tile(p);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31;
  const SoftScal<float> k = soft_scal<float>(p.scal);
  const float dil = kDilateSigma / p.scal[12];
  unsigned long long visits = 0, rows_passed = 0;
  uint32_t n_eval = 0, n_inc = 0;

  SoftRowState<float> st = {};
  if (t.in) {
    const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
    const int64_t s = (int64_t)t.r * p.width_ss + t.x;
    float rv[6], gv[3];
    for (int c = 0; c < 6; ++c) rv[c] = res[c * plane + s];
    for (int c = 0; c < 3; ++c) gv[c] = dimg[c * plane + s];
    st = soft_row_state(rv, gv, p.scal);
  }
  for (int i = tid; i < kChunk * kGradCols; i += kThreads) s_acc[i] = 0.0f;

  for_each_chunk(p, cbox, t, tid, [&](int kc) {
    const float* rows = tris + (int64_t)kc * kChunk * kRow;
    const uint64_t mask =
        gate_rows(rows, t, tid, s_box, s_mask, [&](const float* c) { return gate_box(c, dil); });
    if (kStats) {
      ++visits;
      rows_passed += __popcll(mask);
    }
    if (mask == 0) return;
    for (uint64_t m = mask; m != 0; m &= m - 1) {
      const int i = __ffsll((long long)m) - 1;
      float g[kRow] = {};
      bool live = false;
      if (t.in && box_holds(s_box[i], t.px, t.py)) {
        live = pair_backward(rows + i * kRow, t.px, t.py, k, st, g);
        ++n_eval;
        n_inc += live;
      }
      if (!__any_sync(kFull, live)) continue;
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
      if (v != 0.0f) {
        atomicAdd(&dst[(i / kGradCols) * kRow + grad_col(i % kGradCols)], v);
        s_acc[i] = 0.0f;
      }
    }
  });
  if (kStats) add_stats(stats, tid, visits, rows_passed, n_eval, n_inc);
}

}  // namespace rast
}  // namespace ptre

// C interfaces for ctypes. Launch on the caller's stream, allocate nothing,
// do not synchronise; return cudaGetLastError() of the launch. `dtab` must
// be zeroed by the caller (the kernel adds into it). `stats`: null (nothing
// counted) or 4 uint64 counters that the launch adds to (soft_raster.STATS).
extern "C" int ptre_soft_fwd(const ptre::rast::RasterParams* params, const float* tris,
                             const float* cbox, float* img, float* res,
                             unsigned long long* stats, void* stream) {
  using namespace ptre::rast;
  const RasterParams p = *params;
  if (const int rc = check_launch(p, tris)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stats != nullptr) {
    soft_fwd_kernel<true><<<tile_grid(p), dim3(kTile, kTile), 0, st>>>(p, tris, cbox, img, res,
                                                                       stats);
  } else {
    soft_fwd_kernel<false><<<tile_grid(p), dim3(kTile, kTile), 0, st>>>(p, tris, cbox, img,
                                                                        res, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int ptre_soft_bwd(const ptre::rast::RasterParams* params, const float* tris,
                             const float* cbox, const float* res, const float* dimg,
                             float* dtab, unsigned long long* stats, void* stream) {
  using namespace ptre::rast;
  const RasterParams p = *params;
  if (const int rc = check_launch(p, tris)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stats != nullptr) {
    soft_bwd_kernel<true><<<tile_grid(p), dim3(kTile, kTile), 0, st>>>(p, tris, cbox, res,
                                                                       dimg, dtab, stats);
  } else {
    soft_bwd_kernel<false><<<tile_grid(p), dim3(kTile, kTile), 0, st>>>(p, tris, cbox, res,
                                                                        dimg, dtab, stats);
  }
  return (int)cudaGetLastError();
}
