// A yardstick, not part of the kernel library (ops/cuda/build.py builds
// the units of csrc/ only): the fused backward's first design — 27 scalar
// row loads, the saved states in the stack frame, a warp sum only when
// every live lane hit one row, one 256-thread block an SM (184 and 182
// registers) — kept as it was shipped, with the headers it was shipped
// with (frozen copies in this directory), so that chip_smoke.py can build
// it, hold the shipped kernel to it bit for bit in d(o) and d(d) and time
// the two in turns on the same inputs.
//
// Fused backward of the gradient path for Hopper (sm_90a): the whole
// reverse pass in one launch.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/fused_grad.py
// _fused_bwd_kernel (:112, launched at :315) and, as its helper, the chain
// replay_kernel._chain_bounce (:54-238) whose jax.vjp it traces in-kernel;
// here the adjoint is written by hand (replay.cuh). Per ray (one thread):
//   1. load o, d, the selections and the color cotangent; the uniforms come
//      from the external rows or are regenerated by Philox;
//   2. run the chain forward, keeping o, d, c, active at each bounce
//      boundary (fused_grad.py:227-236);
//   3. for b = B-1 .. 0 recompute bounce b from its saved state and apply
//      chain_bounce_adjoint: d(o), d(d), d(c), the 27 d(row), d(sky);
//   4. add d(row) into the block's shared d(table) at the winner's row; a
//      bounce with index -1 gathers and scatters nothing (:154-156).
// Each block then writes its partial d(table) and d(sky); the wrapper sums
// the partials with one plain reduction, as the reference reduces its
// kernel's outputs outside it (fused_grad.py:372-373).
//
// Design: the (P, 27) table (P <= 192 in the dense class, <= 21 KB) and the
// sky are staged in shared memory, beside a shared d(table) accumulator of
// the same size. The grid is persistent (a few blocks per SM, each striding
// over rays) so the partials stay small. Accumulation is warp-aggregated:
// when every live lane of a warp hit the same row — the common case, rays
// of a warp are neighbouring pixels — the warp sums each column with
// shuffles and one lane adds it with a shared-memory atomic; otherwise each
// lane adds its own. Atomics from different warps land in no fixed order,
// so d(table) and d(sky) vary from run to run at float rounding (the block
// partials are summed in a fixed order); d(o) and d(d) are per ray and
// deterministic. Contention on a few hot rows (all rays of a block hitting
// one sphere) is later work.
//
// A second instantiation takes tables past kMaxRows (triangle-scale scenes:
// 16,264 rows x 27 x 4 B = 1.76 MB at BASELINE config 4, against 227 KB of
// shared memory). Its table stays in global memory (and the 50 MB L2): each
// bounce reads its winner's 108-byte row with __ldg. d(table) is ONE zeroed
// (P, 27) buffer that the warp-aggregated row sums reach by global
// atomicAdd, so no per-block partial of the triangle rows exists. The sphere
// rows are the hot ones (a ground sphere takes most hits of most bounces,
// and millions of same-address global atomics would serialise in L2): when
// the table has at most kMaxSphAcc of them they keep a shared-memory
// accumulator and per-block partials, as the dense instantiation's whole
// table does. The table source and the accumulator's destination are
// policies of the shared per-ray code, so the dense instantiation's code is
// what it was.
//
// What bounds it on this card: float32 ALU work and divergence (about three
// chain evaluations per bounce per ray, forward, recompute, adjoint) plus
// the per-thread saved states, which live in local memory; the bytes (about
// 64 a ray) are small.

#include <cuda_runtime.h>

#include "replay.cuh"
#include "trace.cuh"

namespace ptre {

constexpr int kBwdBlock = 256;
constexpr int kMaxRows = 192;  // dense class: 128 padded triangle rows + 64 spheres
constexpr int kMaxSphAcc = 64;  // global-table class: sphere rows accumulated in shared memory

// Where a row's cotangent is accumulated. SharedRows: the block's (n_rows,
// 27) accumulator in shared memory.
struct SharedRows {
  float* s_acc;
  __device__ float* at(int idx) const { return s_acc + idx * kRowStride; }
};

// GlobalRows: the one (n_rows, 27) d(table) in global memory, except the
// n_sph_acc sphere rows from sph_offset on, which go to the block's shared
// accumulator.
struct GlobalRows {
  float* dtable;
  float* s_sph;
  int sph_offset, n_sph_acc;
  __device__ float* at(int idx) const {
    const int s = idx - sph_offset;
    return s >= 0 && s < n_sph_acc ? s_sph + s * kRowStride
                                   : dtable + (int64_t)idx * kRowStride;
  }
};

// The table read from global memory through the read-only path.
struct GlobalTable {
  const float* rows;  // (n_rows, 27)
  __device__ const float* row(int idx, int, float* buf) const {
    const float* src = rows + (int64_t)idx * kRowStride;
    for (int i = 0; i < kRowStride; ++i) buf[i] = __ldg(src + i);
    return buf;
  }
};

// Warp-aggregated accumulation of one bounce's row cotangent (the bounce
// itself is not needed: rows are addressed by index).
// Every lane of the warp calls add_row the same number of times (the bounce
// loop is uniform, idle lanes pass idx = -1), so the warp may synchronise.
template <class Rows>
struct WarpRowAccumulator {
  Rows rows;

  __device__ void add_row(int idx, int, const float dg[kRowStride]) {
    const unsigned full = 0xffffffffu;
    const unsigned live = __ballot_sync(full, idx >= 0);
    if (live == 0u) return;
    const int leader = __ffs(live) - 1;
    const int lead_idx = __shfl_sync(full, idx, leader);
    if (__all_sync(full, idx < 0 || idx == lead_idx)) {
      const int lane = threadIdx.x & 31;
      float* dst = rows.at(lead_idx);
      for (int k = 0; k < kRowStride; ++k) {
        float v = idx >= 0 ? dg[k] : 0.0f;
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(full, v, off);
        if (lane == 0) atomicAdd(dst + k, v);
      }
    } else if (idx >= 0) {
      float* dst = rows.at(idx);
      for (int k = 0; k < kRowStride; ++k) atomicAdd(dst + k, dg[k]);
    }
  }
};

// Every ray of the block's persistent grid-stride loop, then the block's
// d(sky) into s_dsky: the part both instantiations share.
template <class Table, class Rows>
__device__ __forceinline__ void backward_rays(
    const TraceParams& p, const Table& tab, const float* s_sky, float* s_dsky,
    WarpRowAccumulator<Rows>& acc, const float* __restrict__ o,
    const float* __restrict__ d, const int32_t* __restrict__ sel,
    const float* __restrict__ urand, const float* __restrict__ dcol,
    float* __restrict__ d_o, float* __restrict__ d_d) {
  const ChainConsts<float> k = {p.t_min, p.shadow_eps, p.pdf_eps};
  float dsky[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // the trip count is uniform over the block, so idle lanes (ray >= n_rays)
  // still reach every warp operation
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < p.n_rays;
       base += stride) {
    const int64_t ray = base + threadIdx.x;
    const bool valid = ray < p.n_rays;
    const int64_t r = valid ? ray : 0;
    float go[3], gd[3];
    if (p.external_rng) {
      ExternalUniforms un = {urand, r, p.n_rays};
      ray_backward(p.max_depth, p.sph_offset, p.n_rows, tab, s_sky, k, valid,
                   o + 3 * r, d + 3 * r, sel + r, p.n_rays, un, dcol + 3 * r,
                   go, gd, dsky, acc);
    } else {
      PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)r, p.sample);
      ray_backward(p.max_depth, p.sph_offset, p.n_rows, tab, s_sky, k, valid,
                   o + 3 * r, d + 3 * r, sel + r, p.n_rays, un, dcol + 3 * r,
                   go, gd, dsky, acc);
    }
    if (valid) {
      for (int i = 0; i < 3; ++i) {
        d_o[3 * ray + i] = go[i];
        d_d[3 * ray + i] = gd[i];
      }
    }
  }

  // d(sky): warp sums, then one shared atomic per warp and column
  const unsigned full = 0xffffffffu;
  for (int i = 0; i < 6; ++i) {
    float v = dsky[i];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(full, v, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(&s_dsky[i], v);
  }
}

// Dense class: table and d(table) accumulator staged in shared memory.
__global__ void __launch_bounds__(kBwdBlock)
    fused_bwd_kernel(const TraceParams p, const float* __restrict__ table,
                     const float* __restrict__ sky, const float* __restrict__ o,
                     const float* __restrict__ d,
                     const int32_t* __restrict__ sel,
                     const float* __restrict__ urand,
                     const float* __restrict__ dcol, float* __restrict__ d_o,
                     float* __restrict__ d_d, float* __restrict__ dtab_part,
                     float* __restrict__ dsky_part) {
  __shared__ float s_tab[kMaxRows * kRowStride];
  __shared__ float s_acc[kMaxRows * kRowStride];
  __shared__ float s_sky[8];
  __shared__ float s_dsky[8];

  const int n_tab = p.n_rows * kRowStride;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) {
    s_tab[i] = table[i];
    s_acc[i] = 0.0f;
  }
  if (threadIdx.x < 8) {
    s_sky[threadIdx.x] = threadIdx.x < 6 ? sky[threadIdx.x] : 0.0f;
    s_dsky[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  const PointerTable tab = {s_tab};
  WarpRowAccumulator<SharedRows> acc = {{s_acc}};
  backward_rays(p, tab, s_sky, s_dsky, acc, o, d, sel, urand, dcol, d_o, d_d);
  __syncthreads();
  float* part = dtab_part + (int64_t)blockIdx.x * n_tab;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) part[i] = s_acc[i];
  if (threadIdx.x < 8) dsky_part[blockIdx.x * 8 + threadIdx.x] = s_dsky[threadIdx.x];
}

// Any table: rows read from global memory, d(table) by global atomics into
// the caller's zeroed buffer, the n_sph_acc sphere rows (0, or every sphere
// row when there are at most kMaxSphAcc) through a shared accumulator into
// dsph_part (n_blocks, n_sph_acc, 27).
__global__ void __launch_bounds__(kBwdBlock)
    fused_bwd_global_kernel(const TraceParams p, int n_sph_acc,
                            const float* __restrict__ table,
                            const float* __restrict__ sky,
                            const float* __restrict__ o,
                            const float* __restrict__ d,
                            const int32_t* __restrict__ sel,
                            const float* __restrict__ urand,
                            const float* __restrict__ dcol,
                            float* __restrict__ d_o, float* __restrict__ d_d,
                            float* __restrict__ dtable,
                            float* __restrict__ dsph_part,
                            float* __restrict__ dsky_part) {
  __shared__ float s_sph[kMaxSphAcc * kRowStride];
  __shared__ float s_sky[8];
  __shared__ float s_dsky[8];

  const int n_acc = n_sph_acc * kRowStride;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) s_sph[i] = 0.0f;
  if (threadIdx.x < 8) {
    s_sky[threadIdx.x] = threadIdx.x < 6 ? sky[threadIdx.x] : 0.0f;
    s_dsky[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  const GlobalTable tab = {table};
  WarpRowAccumulator<GlobalRows> acc = {{dtable, s_sph, p.sph_offset, n_sph_acc}};
  backward_rays(p, tab, s_sky, s_dsky, acc, o, d, sel, urand, dcol, d_o, d_d);
  __syncthreads();
  float* part = dsph_part + (int64_t)blockIdx.x * n_acc;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) part[i] = s_sph[i];
  if (threadIdx.x < 8) dsky_part[blockIdx.x * 8 + threadIdx.x] = s_dsky[threadIdx.x];
}

}  // namespace ptre

// Persistent grid size for n_rays: as many blocks as are resident at once
// on the current device (at most one per 256 rays), of the dense kernel or,
// with `global_table`, of the global-table one.
extern "C" int ptre_fused_bwd_blocks(int n_rays, int global_table) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      (global_table
           ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, ptre::fused_bwd_global_kernel, ptre::kBwdBlock, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, ptre::fused_bwd_kernel, ptre::kBwdBlock, 0)) !=
          cudaSuccess) {
    return -1;
  }
  const int need = (n_rays + ptre::kBwdBlock - 1) / ptre::kBwdBlock;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  return need < resident ? need : resident;
}

// C interface for ctypes. ``n_blocks`` persistent blocks write
// (n_blocks, n_rows, 27) and (n_blocks, 8) partials for the caller to sum.
// Launches on the caller's stream, allocates nothing, does not synchronise;
// returns cudaGetLastError() of the launch.
extern "C" int ptre_fused_bwd(const ptre::TraceParams* params,
                              const float* table, const float* sky,
                              const float* o, const float* d,
                              const int32_t* sel, const float* urand,
                              const float* dcol, float* d_o, float* d_d,
                              float* dtab_part, float* dsky_part, int n_blocks,
                              void* stream) {
  const ptre::TraceParams p = *params;
  if (p.n_rays < 1 || p.n_rows < 1 || p.n_rows > ptre::kMaxRows ||
      p.sph_offset < 0 || p.max_depth < 1 || p.max_depth > ptre::kMaxDepth ||
      n_blocks < 1 || (p.external_rng && urand == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  ptre::fused_bwd_kernel<<<n_blocks, ptre::kBwdBlock, 0,
                           (cudaStream_t)stream>>>(
      p, table, sky, o, d, sel, urand, dcol, d_o, d_d, dtab_part, dsky_part);
  return (int)cudaGetLastError();
}

// The global-table instantiation: any n_rows. ``dtable`` (n_rows, 27) must
// be zeroed by the caller and receives every row but the n_sph_acc sphere
// rows from sph_offset on, whose (n_blocks, n_sph_acc, 27) partials land in
// ``dsph_part`` for the caller to sum and add.
extern "C" int ptre_fused_bwd_global(const ptre::TraceParams* params,
                                     const float* table, const float* sky,
                                     const float* o, const float* d,
                                     const int32_t* sel, const float* urand,
                                     const float* dcol, float* d_o, float* d_d,
                                     float* dtable, float* dsph_part,
                                     float* dsky_part, int n_blocks,
                                     int n_sph_acc, void* stream) {
  const ptre::TraceParams p = *params;
  if (p.n_rays < 1 || p.n_rows < 1 || p.sph_offset < 0 || p.max_depth < 1 ||
      p.max_depth > ptre::kMaxDepth || n_blocks < 1 || n_sph_acc < 0 ||
      n_sph_acc > ptre::kMaxSphAcc || p.sph_offset + n_sph_acc > p.n_rows ||
      (p.external_rng && urand == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  ptre::fused_bwd_global_kernel<<<n_blocks, ptre::kBwdBlock, 0,
                                  (cudaStream_t)stream>>>(
      p, n_sph_acc, table, sky, o, d, sel, urand, dcol, d_o, d_d, dtable,
      dsph_part, dsky_part);
  return (int)cudaGetLastError();
}
