// A yardstick, not part of the kernel library (ops/cuda/build.py builds
// the units of csrc/ only): the replay pair's first design — one thread a
// ray, rows read as scalar columns at a 108-byte stride, the saved states
// in the thread's stack frame (LocalStates), d(g) written by each thread
// at a 108-byte stride, every bounce run by every lane — kept as it was
// shipped, with the headers it was shipped with (frozen copies in this
// directory), so that chip_smoke.py can build it, hold the shipped
// kernels' colour, d(o), d(d) and d(g) to it bit for bit and time the two
// in turns on the same inputs.
//
// The replay pair of the planar replay route for Hopper (sm_90a): the bounce
// chain over winner rows gathered outside the kernel, forward and backward.
//
// Replaces the TPU kernels ptre_tpu/ops/pallas/replay_kernel.py _fwd_kernel
// (:277, launched at :333) and _bwd_kernel (:289, launched at :356), the
// forward and backward of replay_core's custom_vjp (_make_core, :383). One
// thread per ray, rows read straight from global memory:
//   * forward: the chain (replay.cuh ray_forward) from the primary ray over
//     ray r's gathered rows g[b, r, :] -> colour (R, 3);
//   * backward: the chain recomputed, its state kept at each bounce boundary
//     and reversed with the hand-written adjoint (replay.cuh ray_backward;
//     on the TPU a jax.vjp traced inside the kernel) -> d(o), d(d) (R, 3),
//     d(g) (B, R, 27), zeros where a bounce was not live or did not hit, and
//     d(sky) as one partial per block, summed from its warps in a fixed
//     order (the TPU writes six per-ray rows and sums them outside; both
//     are deterministic). d(sel) and d(urand) are none.
// d(table) is the gather's own backward outside the kernel, as on the TPU
// (path_replay.py:231-249). The selections say only whether a bounce hit
// (idx >= 0) and which class (idx >= sph_offset); the rows are addressed by
// (bounce, ray). Uniforms: the external rows (2 + 2B, R), or Philox
// regenerated from (seed, ray, sample, draw) as the recording kernel drew
// them — the TPU's urand rows (2 per bounce). The planar (8, 8, L) blocks,
// lane padding and padded-lane masking of the TPU (path_replay.py:215-268)
// are layout matters of its vector unit and have no counterpart here.
//
// Built without FMA contraction (ops/cuda/build.py UNIT_FLAGS), unlike
// fused_grad_kernel.cu: the chain has near-singular terms (Oren-Nayar's tan
// at grazing incidence, rays grazing the ground sphere's horizon) that a
// contracted a*b+c moves far beyond rounding on some rays; uncontracted,
// the forward equals the plain version bit for bit. What bounds it on this
// card: the rows (108 B per hit read, B * 108 B a ray of d(g) written, each
// thread's 27 floats at a 108-byte stride) and the chain's float32 work,
// about three evaluations a bounce in the backward; the saved states live
// in local memory.

#include <cuda_runtime.h>

#include "replay.cuh"
#include "trace.cuh"

namespace ptre {

constexpr int kReplayBlock = 256;
constexpr int kReplayWarps = kReplayBlock / 32;

__global__ void __launch_bounds__(kReplayBlock)
    replay_fwd_kernel(const TraceParams p, const float* __restrict__ g,
                      const float* __restrict__ sky,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const int32_t* __restrict__ sel,
                      const float* __restrict__ urand,
                      float* __restrict__ color) {
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= p.n_rays) return;  // ragged end
  float s[6];
  for (int i = 0; i < 6; ++i) s[i] = __ldg(sky + i);
  replay_ray_forward(p, g, s, o, d, sel, urand, ray, color);
}

__global__ void __launch_bounds__(kReplayBlock)
    replay_bwd_kernel(const TraceParams p, const float* __restrict__ g,
                      const float* __restrict__ sky,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const int32_t* __restrict__ sel,
                      const float* __restrict__ urand,
                      const float* __restrict__ dcol, float* __restrict__ d_o,
                      float* __restrict__ d_d, float* __restrict__ d_g,
                      float* __restrict__ dsky_part) {
  __shared__ float s_part[kReplayWarps][6];
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float s[6];
  for (int i = 0; i < 6; ++i) s[i] = __ldg(sky + i);
  float dsky[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // the ragged end's lanes stay for the warp sums below
  if (ray < p.n_rays)
    replay_ray_backward(p, g, s, o, d, sel, urand, dcol, ray, d_o, d_d, d_g,
                        dsky);

  // d(sky): warp sums, then the block's warps in order
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < 6; ++i) {
    float v = dsky[i];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(full, v, off);
    if ((threadIdx.x & 31) == 0) s_part[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    float v = 0.0f;
    if (threadIdx.x < 6)
      for (int w = 0; w < kReplayWarps; ++w) v += s_part[w][threadIdx.x];
    dsky_part[(int64_t)blockIdx.x * 8 + threadIdx.x] = v;
  }
}

}  // namespace ptre

namespace {

bool replay_params_ok(const ptre::TraceParams& p, const float* urand) {
  return p.n_rays >= 1 && p.sph_offset >= 0 && p.max_depth >= 1 &&
         p.max_depth <= ptre::kMaxDepth && !(p.external_rng && urand == nullptr);
}

}  // namespace

// Blocks of both replay kernels for n_rays (one thread a ray): the rows of
// the backward's (n_blocks, 8) d(sky) partials.
extern "C" int ptre_replay_blocks(int n_rays) {
  return (n_rays + ptre::kReplayBlock - 1) / ptre::kReplayBlock;
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
  ptre::replay_bwd_kernel<<<ptre_replay_blocks(p.n_rays), ptre::kReplayBlock,
                            0, (cudaStream_t)stream>>>(
      p, g, sky, o, d, sel, urand, dcol, d_o, d_d, d_g, dsky_part);
  return (int)cudaGetLastError();
}
