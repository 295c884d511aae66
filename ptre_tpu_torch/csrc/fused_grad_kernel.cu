// Fused backward of the gradient path for Hopper (sm_90a): the whole
// reverse pass in one launch.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/fused_grad.py
// _fused_bwd_kernel (:112, launched at :315) and, as its helper, the chain
// replay_kernel._chain_bounce (:54-238) whose jax.vjp it traces in-kernel;
// here the adjoint is written by hand (replay.cuh). Per ray (one thread):
//   1. load o, d, the selections and the color cotangent; the uniforms come
//      from the external rows or are regenerated by Philox;
//   2. run the chain forward, keeping o, d, c and the uniforms at each
//      bounce boundary (fused_grad.py:227-236);
//   3. for b = B-1 .. 0 recompute bounce b from its saved state and apply
//      chain_bounce_adjoint: d(o), d(d), d(c), the 27 d(row), d(sky);
//   4. add d(row) into d(table) at the winner's row; a bounce with index -1
//      gathers and scatters nothing (:154-156).
// The wrapper sums the per-block partials with one plain reduction, as the
// reference reduces its kernel's outputs outside it (fused_grad.py:372-373).
//
// Two instantiations share the per-ray code (replay.cuh ray_backward). The
// dense class (P <= kMaxRows = 192 rows, <= 21 KB) stages the (P, 27) table
// and the sky in shared memory beside a shared d(table) accumulator; each
// persistent block writes its partial. Any larger table (triangle-scale
// scenes: 16,264 rows at BASELINE config 4) is read from a (P, 28) copy in
// global memory (and the 50 MB L2), one row as seven 16-byte loads
// (replay.cuh PaddedTable), and its triangle rows' cotangents go by global
// float4 atomics into one zeroed (P, 28) d(table); the sphere rows, the hot
// ones (a ground sphere takes most hits of most bounces), keep a shared
// accumulator and per-block partials when there are at most kMaxSphAcc.
//
// What bounds it on this card, and what the design does about it (times in
// turns with the first design, csrc/baseline/, and with edited copies of
// this unit, on chip_smoke.py's phase 7 and 17 inputs at max_depth 5;
// NVIDIA H100 80GB HBM3, 700.00 W):
//   * accumulation. With every row addition made a no-op the first design
//     ran 1.4831 -> 0.7305 ms (dense) and 3.3682 -> 1.4682 ms (global): it
//     took a warp sum only when every live lane hit one row, and 27 scalar
//     atomics a lane otherwise, the common case after bounce 0, where lanes
//     on a hot row serialise. Now the lanes of a warp are grouped by row
//     (__match_any_sync): a lane alone adds its own row; a group of two or
//     more writes its rows of 28 into the warp's slice of shared memory and
//     lanes 0-6 each sum four columns over the group's rows and add them
//     once (float4 atomics for global rows, sm_90). Summing a group by a
//     butterfly of shuffles per column measured 19 % and 31 % slower;
//   * latency of a long dependent float32 chain per hit bounce (forward,
//     recompute and adjoint: IEEE divisions and square roots, sin/cos,
//     without FMA contraction) over lanes that diverge (miss, emitter,
//     triangle, sphere; paths of other lengths); what hides it is warps.
//     The first design used 184 registers, one 256-thread block an SM; the
//     launch bounds now ask for two (128 registers, ~300 B of spills; one
//     block of 189-199 registers measured 41 % and 28 % slower, 128-thread
//     blocks four an SM 21 % and 4 % slower), and the saved states
//     leave the stack frame (replay.cuh StridedStates: o, d, c, u of each
//     bounce in a [bounce][field][thread] slice of dynamic shared memory,
//     the row index read again from the selections, `active` one bit a
//     bounce; in the stack frame, 1-2 % slower). A block's shared memory
//     grows by 11 KB a bounce (and 216 B a dense row), so two blocks fit
//     an SM only up to max_depth 7 (global) or while the dense total
//     stays under ~113 KB; past that one block runs, at 128 registers
//     with spills: at max_depth 8 dense 1.17 against the first design's
//     1.63 ms, global 2.21 against 3.73 ms.
// Dense 1.4513 -> 0.7040 ms, global 3.4072 -> 1.3921 ms at these inputs;
// the bytes bound is ~0.05 ms. Atomics land in no fixed order, so d(table)
// and d(sky) vary from run to run at float rounding; d(o) and d(d) are per
// ray, deterministic, and equal bit for bit to the first design's (no
// operation of the chain or its adjoint is reordered; the unit is built
// with -fmad=false).

#include <cuda_runtime.h>

#include "replay.cuh"
#include "trace.cuh"

namespace ptre {

constexpr int kBwdBlock = 256;
constexpr int kBwdMinBlocks = 2;
constexpr int kMaxRows = 192;  // dense class: 128 padded triangle rows + 64 spheres
constexpr int kMaxSphAcc = 64;  // global-table class: sphere rows accumulated in shared memory
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of one block, in floats: the warps' (32, 28)
// reduction slices (first, 16-byte aligned), the StridedStates slice, then,
// for the dense instantiation, its staged table and d(table) accumulator
// (`n_tab` floats each).
constexpr size_t kRedFloats = (size_t)kBwdBlock * kPadStride;
__host__ __device__ inline size_t states_floats(int max_depth) {
  return (size_t)kStateFields * max_depth * kBwdBlock;
}
inline size_t dyn_bytes(int max_depth, int n_tab) {
  return sizeof(float) * (kRedFloats + states_floats(max_depth) + 2 * (size_t)n_tab);
}

// Where a row's cotangent is added: `add(idx, v)` the 27 values, `add4(idx,
// q, s)` columns 4q .. 4q + 3 of them (column 27 is 0). SharedRows: the
// block's (n_rows, 27) accumulator in shared memory.
struct SharedRows {
  float* s_acc;
  __device__ void add(int idx, const float v[kRowStride]) const {
    float* dst = s_acc + idx * kRowStride;
    for (int k = 0; k < kRowStride; ++k) atomicAdd(dst + k, v[k]);
  }
  __device__ void add4(int idx, int q, float4 s) const {
    float* dst = s_acc + idx * kRowStride + 4 * q;
    atomicAdd(dst, s.x);
    atomicAdd(dst + 1, s.y);
    atomicAdd(dst + 2, s.z);
    if (q < 6) atomicAdd(dst + 3, s.w);
  }
};

// GlobalRows: the one (n_rows, kPadStride) d(table) in global memory, by
// float4 atomics (sm_90), except the n_sph_acc sphere rows from sph_offset
// on, which go to the block's shared (n_sph_acc, 27) accumulator.
struct GlobalRows {
  float* dtable;
  SharedRows sph;  // s_acc: sphere row sph_offset's accumulator
  int sph_offset, n_sph_acc;
  __device__ void add(int idx, const float v[kRowStride]) const {
    const int s = idx - sph_offset;
    if (s >= 0 && s < n_sph_acc) return sph.add(s, v);
    float4* dst = reinterpret_cast<float4*>(dtable + (int64_t)idx * kPadStride);
    for (int q = 0; q < 6; ++q)
      atomicAdd(dst + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    atomicAdd(dst + 6, make_float4(v[24], v[25], v[26], 0.0f));
  }
  __device__ void add4(int idx, int q, float4 s) const {
    const int si = idx - sph_offset;
    if (si >= 0 && si < n_sph_acc) return sph.add4(si, q, s);
    atomicAdd(reinterpret_cast<float4*>(dtable + (int64_t)idx * kPadStride) + q, s);
  }
};

// Row-grouped accumulation of one bounce's row cotangent (the bounce itself
// is not needed: rows are addressed by index). The lanes of a warp are
// grouped by row (__match_any_sync); a lane alone adds its own 27 values, a
// group of two or more sums them and adds once. Every lane of the warp
// calls add_row the same number of times (the bounce loop is uniform, idle
// lanes pass idx = -1), so the warp may synchronise.
template <class Rows>
struct GroupedRowAccumulator {
  Rows rows;
  float* s_red;  // this warp's (32, kPadStride) slice of shared memory

  __device__ void add_row(int idx, int, const float dg[kRowStride]) {
    if (__ballot_sync(kFull, idx >= 0) == 0u) return;
    const int lane = threadIdx.x & 31;
    const unsigned group = __match_any_sync(kFull, idx);  // lanes on my row
    const bool alone = __popc(group) == 1;
    const bool grouped = idx >= 0 && !alone;
    if (idx >= 0 && alone) rows.add(idx, dg);
    // the leaders (lowest lanes) of the groups of two or more live lanes
    const unsigned leaders = __ballot_sync(kFull, grouped && lowest_lane(group) == lane);
    if (leaders == 0u) return;
    // a grouped lane's row of 28 into the warp's slice; then, group by
    // group, lanes 0-6 sum four columns each over the group's rows and add
    // (replay.cuh put_group_row, group_sum4: the host build's code too)
    if (grouped) put_group_row(s_red, lane, dg);
    __syncwarp();
    for (unsigned todo = leaders; todo != 0u; todo &= todo - 1u) {
      const int leader = lowest_lane(todo);
      const unsigned grp = __shfl_sync(kFull, group, leader);
      const int row = __shfl_sync(kFull, idx, leader);
      if (lane < kPadStride / 4) {
        float s[4];
        group_sum4(s_red, grp, lane, s);
        rows.add4(row, lane, make_float4(s[0], s[1], s[2], s[3]));
      }
    }
    __syncwarp();  // the slice is written again by the next bounce
  }
};

// Every ray of the block's persistent grid-stride loop, then the block's
// d(sky) into s_dsky: the part both instantiations share.
template <class Table, class Rows>
__device__ __forceinline__ void backward_rays(
    const TraceParams& p, const Table& tab, const float* s_sky, float* s_dsky,
    float* s_states, GroupedRowAccumulator<Rows>& acc,
    const float* __restrict__ o, const float* __restrict__ d,
    const int32_t* __restrict__ sel, const float* __restrict__ urand,
    const float* __restrict__ dcol, float* __restrict__ d_o,
    float* __restrict__ d_d) {
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
    StridedStates st = {s_states + threadIdx.x, (int)blockDim.x, sel + r, p.n_rays,
                        p.n_rows, valid, 0u};
    if (p.external_rng) {
      ExternalUniforms un = {urand, r, p.n_rays};
      ray_backward(p.max_depth, p.sph_offset, p.n_rows, tab, s_sky, k, valid,
                   o + 3 * r, d + 3 * r, sel + r, p.n_rays, un, dcol + 3 * r, go,
                   gd, dsky, acc, st);
    } else {
      PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)r, p.sample);
      ray_backward(p.max_depth, p.sph_offset, p.n_rows, tab, s_sky, k, valid,
                   o + 3 * r, d + 3 * r, sel + r, p.n_rays, un, dcol + 3 * r, go,
                   gd, dsky, acc, st);
    }
    if (valid) {
      for (int i = 0; i < 3; ++i) {
        d_o[3 * ray + i] = go[i];
        d_d[3 * ray + i] = gd[i];
      }
    }
  }

  // d(sky): warp sums, then one shared atomic per warp and column
  for (int i = 0; i < 6; ++i) {
    float v = dsky[i];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(&s_dsky[i], v);
  }
}

// Dense class: table and d(table) accumulator staged in (dynamic) shared
// memory.
__global__ void __launch_bounds__(kBwdBlock, kBwdMinBlocks)
    fused_bwd_kernel(const TraceParams p, const float* __restrict__ table,
                     const float* __restrict__ sky, const float* __restrict__ o,
                     const float* __restrict__ d,
                     const int32_t* __restrict__ sel,
                     const float* __restrict__ urand,
                     const float* __restrict__ dcol, float* __restrict__ d_o,
                     float* __restrict__ d_d, float* __restrict__ dtab_part,
                     float* __restrict__ dsky_part) {
  __shared__ float s_sky[8];
  __shared__ float s_dsky[8];
  extern __shared__ float4 s_dyn[];  // 16-byte aligned: the reduction slices
  const int n_tab = p.n_rows * kRowStride;
  float* s_red = reinterpret_cast<float*>(s_dyn);
  float* s_states = s_red + kRedFloats;
  float* s_tab = s_states + states_floats(p.max_depth);
  float* s_acc = s_tab + n_tab;

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
  GroupedRowAccumulator<SharedRows> acc = {{s_acc},
                                           s_red + (threadIdx.x >> 5) * 32 * kPadStride};
  backward_rays(p, tab, s_sky, s_dsky, s_states, acc, o, d, sel, urand, dcol,
                d_o, d_d);
  __syncthreads();
  float* part = dtab_part + (int64_t)blockIdx.x * n_tab;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) part[i] = s_acc[i];
  if (threadIdx.x < 8) dsky_part[blockIdx.x * 8 + threadIdx.x] = s_dsky[threadIdx.x];
}

// Any table: rows read from the padded copy in global memory, d(table) by
// global atomics into the caller's zeroed (n_rows, 28) buffer, the
// n_sph_acc sphere rows (0, or every sphere row when there are at most
// kMaxSphAcc) through a shared accumulator into dsph_part (n_blocks,
// n_sph_acc, 27).
__global__ void __launch_bounds__(kBwdBlock, kBwdMinBlocks)
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
  extern __shared__ float4 s_dyn[];  // 16-byte aligned: the reduction slices
  float* s_red = reinterpret_cast<float*>(s_dyn);
  float* s_states = s_red + kRedFloats;

  const int n_acc = n_sph_acc * kRowStride;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) s_sph[i] = 0.0f;
  if (threadIdx.x < 8) {
    s_sky[threadIdx.x] = threadIdx.x < 6 ? sky[threadIdx.x] : 0.0f;
    s_dsky[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  const PaddedTable tab = {table};
  GroupedRowAccumulator<GlobalRows> acc = {{dtable, {s_sph}, p.sph_offset, n_sph_acc},
                                           s_red + (threadIdx.x >> 5) * 32 * kPadStride};
  backward_rays(p, tab, s_sky, s_dsky, s_states, acc, o, d, sel, urand, dcol,
                d_o, d_d);
  __syncthreads();
  float* part = dsph_part + (int64_t)blockIdx.x * n_acc;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) part[i] = s_sph[i];
  if (threadIdx.x < 8) dsky_part[blockIdx.x * 8 + threadIdx.x] = s_dsky[threadIdx.x];
}

// Lets the kernel take `bytes` of dynamic shared memory.
template <class Kernel>
cudaError_t allow_dyn(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ptre

// Persistent grid size for n_rays at max_depth: as many blocks as are
// resident at once on the current device (at most one per kBwdBlock rays),
// of the dense kernel for a table of n_rows or, with `global_table`, of the
// global-table one.
extern "C" int ptre_fused_bwd_blocks(int n_rays, int global_table, int max_depth,
                                     int n_rows) {
  int dev = 0, sms = 0, per_sm = 0;
  if (max_depth < 1 || max_depth > ptre::kMaxDepth || n_rows < 1 ||
      (!global_table && n_rows > ptre::kMaxRows)) {
    return -1;
  }
  const size_t dyn = ptre::dyn_bytes(max_depth, global_table ? 0 : n_rows * ptre::kRowStride);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return -1;
  }
  cudaError_t rc;
  if (global_table) {
    rc = ptre::allow_dyn(ptre::fused_bwd_global_kernel, dyn);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ptre::fused_bwd_global_kernel, ptre::kBwdBlock, dyn);
  } else {
    rc = ptre::allow_dyn(ptre::fused_bwd_kernel, dyn);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ptre::fused_bwd_kernel,
                                                         ptre::kBwdBlock, dyn);
  }
  if (rc != cudaSuccess) return -1;
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
  const size_t dyn = ptre::dyn_bytes(p.max_depth, p.n_rows * ptre::kRowStride);
  const cudaError_t rc = ptre::allow_dyn(ptre::fused_bwd_kernel, dyn);
  if (rc != cudaSuccess) return (int)rc;
  ptre::fused_bwd_kernel<<<n_blocks, ptre::kBwdBlock, dyn, (cudaStream_t)stream>>>(
      p, table, sky, o, d, sel, urand, dcol, d_o, d_d, dtab_part, dsky_part);
  return (int)cudaGetLastError();
}

// The global-table instantiation: any n_rows. ``table`` is the (n_rows, 28)
// padded copy (column 27 zero, 16-byte aligned); ``dtable`` (n_rows, 28)
// must be zeroed by the caller and receives every row but the n_sph_acc
// sphere rows from sph_offset on, whose (n_blocks, n_sph_acc, 27) partials
// land in ``dsph_part`` for the caller to sum and add.
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
      (p.external_rng && urand == nullptr) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dtable) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t dyn = ptre::dyn_bytes(p.max_depth, 0);
  const cudaError_t rc = ptre::allow_dyn(ptre::fused_bwd_global_kernel, dyn);
  if (rc != cudaSuccess) return (int)rc;
  ptre::fused_bwd_global_kernel<<<n_blocks, ptre::kBwdBlock, dyn,
                                  (cudaStream_t)stream>>>(
      p, n_sph_acc, table, sky, o, d, sel, urand, dcol, d_o, d_d, dtable,
      dsph_part, dsky_part);
  return (int)cudaGetLastError();
}
