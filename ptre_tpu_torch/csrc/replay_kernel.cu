// The replay pair of the planar replay route for Hopper (sm_90a): the bounce
// chain over winner rows gathered outside the kernel, forward and backward.
//
// Replaces the TPU kernels ptre_tpu/ops/pallas/replay_kernel.py _fwd_kernel
// (:277, launched at :333) and _bwd_kernel (:289, launched at :356), the
// forward and backward of replay_core's custom_vjp (_make_core, :383). One
// thread a ray; a warp owns 32 consecutive rays:
//   * forward: the chain (replay.cuh replay_step) from the primary ray over
//     ray r's gathered rows g[b, r, :] -> colour (R, 3);
//   * backward: the chain recomputed, its state kept at each bounce boundary
//     and reversed with the hand-written adjoint (replay.cuh replay_unstep;
//     on the TPU a jax.vjp traced inside the kernel) -> d(o), d(d) (R, 3),
//     d(g) (B, R, 27), zeros where a bounce was not live or did not hit, and
//     d(sky) as one partial per block, summed from its warps in a fixed
//     order (the TPU writes six per-ray rows and sums them outside; both
//     are deterministic). d(sel) and d(urand) are none.
// d(table) is the gather's own backward outside the kernel, as on the TPU
// (path_replay.py:231-249). Uniforms: the external rows (2 + 2B, R), or
// Philox regenerated from (seed, ray, sample, draw) as the recording kernel
// drew them — the TPU's urand rows (2 per bounce). The planar (8, 8, L)
// blocks, lane padding and padded-lane masking of the TPU
// (path_replay.py:215-268) are layout matters of its vector unit and have
// no counterpart here.
//
// Built without FMA contraction (ops/cuda/build.py UNIT_FLAGS), unlike
// fused_grad_kernel.cu: the chain has near-singular terms (Oren-Nayar's tan
// at grazing incidence, rays grazing the ground sphere's horizon) that a
// contracted a*b+c moves far beyond rounding on some rays; uncontracted,
// the forward equals the plain version bit for bit.
//
// What bounds it on this card, and what the design does about it. The
// backward must write d(g) whole, B * R * 108 bytes (1.12 GB at 1920x1080
// and max_depth 5, ~84 % of it zeros: the custom_vjp's contract), and both
// kernels run a long dependent float32 chain per hit bounce (IEEE
// divisions and square roots, sin/cos, no FMA) over lanes that diverge.
// The first design (csrc/baseline/replay_pair/) wrote each thread's 27
// floats at a 108-byte stride (32 sectors a warp store), kept the saved
// states in the stack frame, ran one 256-thread block an SM at 149
// registers and every bounce on every lane. Here:
//   * d(g) goes out as slabs: at bounce b a warp's 32 rays own 3,456
//     contiguous bytes at (b * R + r0) * 27 floats, 16-byte aligned when R
//     % 4 == 0. Each lane puts its row cotangent into the warp's (32, 27)
//     shared slice, and the warp stores the slab as 216 float4s; a warp
//     where no lane hit stores zeros without staging; a ragged warp, R % 4
//     != 0 or an unaligned d(g) take coalesced scalar stores instead;
//   * the saved states live in a [bounce][field][thread] slice of dynamic
//     shared memory (replay.cuh StridedStates, as the fused backward);
//   * dead tails: entering each bounce the warp votes, and once no lane's
//     path is alive the recompute stops; the reverse pass skips those
//     bounces' adjoints and writes their zero slabs (the forward stops
//     there too). At 1920x1080 and max_depth 5, 59 % of the warp-bounces;
//   * occupancy: blocks of 128 threads; the backward's launch bounds ask
//     for 3 an SM (168 registers, no spills), which its shared memory
//     allows to max_depth 8 (12 warps at every depth). Four (16 warps) cap
//     it at 128 registers, which spill ~400 B and run slower; the forward
//     asks for 8 (64 registers, 32 warps);
//   * rows are read as each lane's own columns through L1/L2, and o, d,
//     d(colour), the colour, d(o), d(d) by each lane's own loads and
//     stores: staging a warp's rows, or its 384 contiguous bytes of rays,
//     through shared memory measured slower (chip_ablations.py).
// Every operation of the chain and its adjoint is the first design's in
// the same order, so the colour, d(o), d(d) and d(g) equal its bit for bit
// (chip_smoke.py phase 21, tests/test_torch_replay_pair_warp.py on the
// host); d(sky) sums 4 warps a block instead of 8.

#include <cuda_runtime.h>

#include <mutex>

#include "replay.cuh"
#include "trace.cuh"

namespace ptre {

constexpr int kReplayMinBlocks = 3;  // backward blocks an SM: 168 registers
constexpr int kFwdMinBlocks = 8;     // forward blocks an SM: 64 registers
constexpr int kReplayWarps = kReplayBlock / 32;
constexpr int kSlab = 32 * kRowStride;  // floats of a warp's (32, 27) slice
constexpr unsigned kFull = 0xffffffffu;

// A warp's rays: r0 (a multiple of 32), how many of them exist (0 for a
// warp past the rays), the lane, and whether its d(g) slabs are whole and
// 16-byte aligned (float4 stores).
struct WarpRays {
  int64_t r0;
  int n, lane;
  bool vec;
};

__device__ __forceinline__ bool is16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

__device__ __forceinline__ WarpRays warp_rays(const TraceParams& p, const float* d_g) {
  WarpRays w;
  w.lane = threadIdx.x & 31;
  w.r0 = (int64_t)blockIdx.x * kReplayBlock + (threadIdx.x & ~31);
  const int64_t left = p.n_rays - w.r0;
  w.n = left < 32 ? (int)(left > 0 ? left : 0) : 32;
  w.vec = w.n == 32 && p.n_rays % 4 == 0 && d_g != nullptr && is16(d_g);
  return w;
}

// Lane l's 3 values of v (R, 3) at ray r0 + l (0 past the rays), and back.
__device__ __forceinline__ void load3(const float* __restrict__ v, const WarpRays& w,
                                      float out[3]) {
  for (int i = 0; i < 3; ++i) out[i] = w.lane < w.n ? __ldg(v + 3 * (w.r0 + w.lane) + i) : 0.0f;
}

__device__ __forceinline__ void store3(float* __restrict__ v, const WarpRays& w,
                                       const float in[3]) {
  if (w.lane < w.n)
    for (int i = 0; i < 3; ++i) v[3 * (w.r0 + w.lane) + i] = in[i];
}

// The warp's slab of bounce b: rows r0 .. r0 + n - 1 of plane b of a (B, R,
// 27) tensor, n * 27 contiguous floats.
__device__ __forceinline__ int64_t slab_offset(const TraceParams& p, int b, const WarpRays& w) {
  return ((int64_t)b * p.n_rays + w.r0) * kRowStride;
}

// The slice (lane l's 27 values at l * 27) -> the slab.
__device__ __forceinline__ void store_slab(float* __restrict__ dst, const WarpRays& w,
                                           const float* slice) {
  if (w.vec) {
    const float4* src = reinterpret_cast<const float4*>(slice);
    float4* out = reinterpret_cast<float4*>(dst);
    for (int q = w.lane; q < kSlab / 4; q += 32) out[q] = src[q];
  } else {
    for (int i = w.lane; i < w.n * kRowStride; i += 32) dst[i] = slice[i];
  }
}

// Zeros -> the slab, without staging.
__device__ __forceinline__ void zero_slab(float* __restrict__ dst, const WarpRays& w) {
  if (w.vec) {
    float4* out = reinterpret_cast<float4*>(dst);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = w.lane; q < kSlab / 4; q += 32) out[q] = z;
  } else {
    for (int i = w.lane; i < w.n * kRowStride; i += 32) dst[i] = 0.0f;
  }
}

// The row of bounce b a lane reads, where `need` (its path is alive and
// idx >= 0): its own columns of g, loaded through L1/L2 as the chain uses
// them.
__device__ __forceinline__ const float* bounce_row(const TraceParams& p, const float* g,
                                                   int b, const WarpRays& w, bool need) {
  return need ? g + ((int64_t)b * p.n_rays + w.r0 + w.lane) * kRowStride : nullptr;
}

// The lane's primary ray and its chain state entering bounce 0.
__device__ __forceinline__ ReplayLane<float> start_lane(const float* o, const float* d,
                                                        const WarpRays& w) {
  ReplayLane<float> ln;
  load3(o, w, ln.o);
  load3(d, w, ln.d);
  for (int i = 0; i < 3; ++i) ln.c[i] = 1.0f;
  ln.act = w.lane < w.n;
  return ln;
}

template <class Uniforms>
__device__ __forceinline__ void forward_warp(const TraceParams& p, const float* g,
                                             const float sky[6], const int32_t* sel,
                                             const WarpRays& w, Uniforms& un,
                                             ReplayLane<float>& ln) {
  const ChainConsts<float> k = {p.t_min, p.shadow_eps, p.pdf_eps};
  const int64_t ray = w.r0 + w.lane;
  StridedStatesT<float>* none = nullptr;
  for (int b = 0; b < p.max_depth; ++b) {
    if (__ballot_sync(kFull, ln.act) == 0u) break;  // the warp's dead tail
    const int idx = replay_idx(p, sel, b, ray, w.lane < w.n);
    const float* row = bounce_row(p, g, b, w, ln.act && idx >= 0);
    replay_step(b, idx, row, p.sph_offset, un, sky, k, ln, none);
  }
}

// Recompute with the states kept in `st`, then reverse: every bounce's
// d(g) slab written, the lane's d(o), d(d) into gO, gD, its d(sky) into
// dsky.
template <class Uniforms>
__device__ __forceinline__ void backward_warp(const TraceParams& p, const float* g,
                                              const float sky[6], const int32_t* sel,
                                              const WarpRays& w, Uniforms& un,
                                              ReplayLane<float>& ln, StridedStates& st,
                                              float gO[3], float gD[3], float gC[3],
                                              float* __restrict__ d_g, float dsky[6],
                                              float* slice) {
  const ChainConsts<float> k = {p.t_min, p.shadow_eps, p.pdf_eps};
  const int64_t ray = w.r0 + w.lane;
  int live = p.max_depth;  // bounces entered by some path of the warp
  for (int b = 0; b < p.max_depth; ++b) {
    if (__ballot_sync(kFull, ln.act) == 0u) {
      live = b;
      break;
    }
    const int idx = replay_idx(p, sel, b, ray, w.lane < w.n);
    const float* row = bounce_row(p, g, b, w, ln.act && idx >= 0);
    replay_step(b, idx, row, p.sph_offset, un, sky, k, ln, &st);
  }
  for (int b = p.max_depth - 1; b >= 0; --b) {
    float* dst = d_g + slab_offset(p, b, w);
    if (b >= live) {
      zero_slab(dst, w);
      continue;
    }
    const BounceState<float> s = st.load(b);
    const float* row = bounce_row(p, g, b, w, s.act && s.idx >= 0);
    float dg[kRowStride];
    replay_unstep(s, row, p.sph_offset, sky, k, gO, gD, gC, dg, dsky);
    if (__ballot_sync(kFull, s.idx >= 0) == 0u) {  // no lane hit: all zeros
      zero_slab(dst, w);
      continue;
    }
    for (int i = 0; i < kRowStride; ++i) slice[w.lane * kRowStride + i] = dg[i];
    __syncwarp();
    store_slab(dst, w, slice);
    __syncwarp();  // the slice is written again by the next staged bounce
  }
}

__global__ void __launch_bounds__(kReplayBlock, kFwdMinBlocks)
    replay_fwd_kernel(const TraceParams p, const float* __restrict__ g,
                      const float* __restrict__ sky,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const int32_t* __restrict__ sel,
                      const float* __restrict__ urand,
                      float* __restrict__ color) {
  const WarpRays w = warp_rays(p, nullptr);  // no slabs
  if (w.n == 0) return;  // a whole warp past the rays (warp-uniform)
  float s[6];
  for (int i = 0; i < 6; ++i) s[i] = __ldg(sky + i);
  ReplayLane<float> ln = start_lane(o, d, w);
  const int64_t ray = w.r0 + w.lane;
  if (p.external_rng) {
    ExternalUniforms un = {urand, ray, p.n_rays};
    forward_warp(p, g, s, sel, w, un, ln);
  } else {
    PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)ray, p.sample);
    forward_warp(p, g, s, sel, w, un, ln);
  }
  store3(color, w, ln.c);
}

// Dynamic shared memory of a backward block, in floats: the warps' (32, 27)
// slices (first, 16-byte aligned), then the StridedStates slice.
__host__ __device__ inline size_t replay_bwd_floats(int max_depth) {
  return (size_t)kReplayWarps * kSlab + (size_t)kStateFields * max_depth * kReplayBlock;
}

__global__ void __launch_bounds__(kReplayBlock, kReplayMinBlocks)
    replay_bwd_kernel(const TraceParams p, const float* __restrict__ g,
                      const float* __restrict__ sky,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const int32_t* __restrict__ sel,
                      const float* __restrict__ urand,
                      const float* __restrict__ dcol, float* __restrict__ d_o,
                      float* __restrict__ d_d, float* __restrict__ d_g,
                      float* __restrict__ dsky_part) {
  __shared__ float s_part[kReplayWarps][6];
  extern __shared__ float4 s_dyn[];
  const int warp = threadIdx.x >> 5;
  float* slice = reinterpret_cast<float*>(s_dyn) + warp * kSlab;
  float* states = reinterpret_cast<float*>(s_dyn) + kReplayWarps * kSlab;
  const WarpRays w = warp_rays(p, d_g);
  float s[6];
  for (int i = 0; i < 6; ++i) s[i] = __ldg(sky + i);
  float dsky[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (w.n > 0) {  // warp-uniform: a whole warp past the rays stays for the sums
    ReplayLane<float> ln = start_lane(o, d, w);
    float gO[3] = {0.0f, 0.0f, 0.0f}, gD[3] = {0.0f, 0.0f, 0.0f}, gC[3];
    load3(dcol, w, gC);
    const int64_t ray = w.r0 + w.lane;
    const bool valid = w.lane < w.n;
    StridedStates st = {states + threadIdx.x, kReplayBlock, sel + (valid ? ray : w.r0),
                        p.n_rays, p.n_rows, valid, 0u};
    if (p.external_rng) {
      ExternalUniforms un = {urand, ray, p.n_rays};
      backward_warp(p, g, s, sel, w, un, ln, st, gO, gD, gC, d_g, dsky, slice);
    } else {
      PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)ray, p.sample);
      backward_warp(p, g, s, sel, w, un, ln, st, gO, gD, gC, d_g, dsky, slice);
    }
    store3(d_o, w, gO);
    store3(d_d, w, gD);
  }

  // d(sky): warp sums, then the block's warps in order
  for (int i = 0; i < 6; ++i) {
    float v = dsky[i];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if ((threadIdx.x & 31) == 0) s_part[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    float v = 0.0f;
    if (threadIdx.x < 6)
      for (int i = 0; i < kReplayWarps; ++i) v += s_part[i][threadIdx.x];
    dsky_part[(int64_t)blockIdx.x * 8 + threadIdx.x] = v;
  }
}

}  // namespace ptre

namespace {

bool replay_params_ok(const ptre::TraceParams& p, const float* urand) {
  return p.n_rays >= 1 && p.sph_offset >= 0 && p.max_depth >= 1 &&
         p.max_depth <= ptre::kMaxDepth && !(p.external_rng && urand == nullptr);
}

size_t replay_bwd_bytes(int max_depth) {
  return sizeof(float) * ptre::replay_bwd_floats(max_depth);
}

// The backward's dynamic shared-memory limit, raised once a device to what
// the deepest chain (kMaxDepth) needs; every launch and occupancy query
// asks for no more.
cudaError_t replay_bwd_shared_ready() {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t rc[kDevices];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    rc[dev] = cudaFuncSetAttribute(ptre::replay_bwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)replay_bwd_bytes(ptre::kMaxDepth));
  });
  return rc[dev];
}

}  // namespace

// Blocks of both replay kernels for n_rays (one thread a ray): the rows of
// the backward's (n_blocks, 8) d(sky) partials.
extern "C" int ptre_replay_blocks(int n_rays) {
  return (n_rays + ptre::kReplayBlock - 1) / ptre::kReplayBlock;
}

// Resident blocks an SM of the forward and the backward kernel at
// max_depth, and the backward's dynamic shared memory a block (bytes);
// returns a cudaError_t.
extern "C" int ptre_replay_occupancy(int max_depth, int* fwd_blocks, int* bwd_blocks,
                                     int* bwd_dyn_bytes) {
  if (max_depth < 1 || max_depth > ptre::kMaxDepth) return (int)cudaErrorInvalidValue;
  const size_t dyn = replay_bwd_bytes(max_depth);
  *bwd_dyn_bytes = (int)dyn;
  cudaError_t rc = replay_bwd_shared_ready();
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(fwd_blocks, ptre::replay_fwd_kernel,
                                                       ptre::kReplayBlock, 0);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(bwd_blocks, ptre::replay_bwd_kernel,
                                                       ptre::kReplayBlock, dyn);
  return (int)rc;
}

// C interface for ctypes. g is (max_depth, n_rays, 27); sel (max_depth,
// n_rays) int32; colour (n_rays, 3). Launches on the caller's stream,
// allocates nothing, does not synchronise; returns cudaGetLastError() of the
// launch.
extern "C" int ptre_replay_fwd(const ptre::TraceParams* params, const float* g,
                               const float* sky, const float* o,
                               const float* d, const int32_t* sel,
                               const float* urand, float* color,
                               void* stream) {
  const ptre::TraceParams p = *params;
  if (!replay_params_ok(p, urand)) return (int)cudaErrorInvalidValue;
  ptre::replay_fwd_kernel<<<ptre_replay_blocks(p.n_rays), ptre::kReplayBlock,
                            0, (cudaStream_t)stream>>>(p, g, sky, o, d, sel,
                                                       urand, color);
  return (int)cudaGetLastError();
}

// d_g (max_depth, n_rays, 27) is written whole; dsky_part is
// (ptre_replay_blocks(n_rays), 8), columns 0-5 the block's d(sky).
extern "C" int ptre_replay_bwd(const ptre::TraceParams* params, const float* g,
                               const float* sky, const float* o,
                               const float* d, const int32_t* sel,
                               const float* urand, const float* dcol,
                               float* d_o, float* d_d, float* d_g,
                               float* dsky_part, void* stream) {
  const ptre::TraceParams p = *params;
  if (!replay_params_ok(p, urand)) return (int)cudaErrorInvalidValue;
  const cudaError_t rc = replay_bwd_shared_ready();
  if (rc != cudaSuccess) return (int)rc;
  ptre::replay_bwd_kernel<<<ptre_replay_blocks(p.n_rays), ptre::kReplayBlock,
                            replay_bwd_bytes(p.max_depth), (cudaStream_t)stream>>>(
      p, g, sky, o, d, sel, urand, dcol, d_o, d_d, d_g, dsky_part);
  return (int)cudaGetLastError();
}
