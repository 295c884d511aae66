// Recording forward of the gradient path for Hopper (sm_90a): rays in,
// unclamped color and per-bounce winner selections out.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/megakernel.py
// _mega_kernel_dense (:734, launched at :1025) in its recording mode
// (record_sel, and record_ur for the hardware PRNG), as
// trace_fused_sel(..., planar="color", hw_rng=True) calls it (:1132-1222).
// One thread per ray over a 1-D grid: the bounce loop of trace.cuh with the
// SelRecorder policy; no accumulation, no clamp.
//
// Selections are (max_depth, R) int32 unified-table rows: triangle j -> j,
// sphere s -> T + s, -1 where the bounce did not hit or the path had ended.
// That is 20 bytes a ray at max_depth 5, against the TPU's four float rows
// per bounce (80 bytes): the fused backward only ever needs the index
// (fused_grad.py:157-170). The uniforms are not recorded: Philox is
// counter-based, so the backward regenerates them from (seed, ray, sample,
// draw) — 2 * max_depth floats a ray the TPU has to store because its
// hardware PRNG cannot be replayed.
//
// What bounds it on this card: as the render kernel, divergent float32 ALU
// work in the serial primitive sweep; the bytes (24 in, 12 + 4B out a ray)
// take microseconds. Scene tables are staged in shared memory once per block
// and read as broadcasts; a path that ends breaks out per thread.

#include <cuda_runtime.h>

#include "trace.cuh"

namespace ptre {

constexpr int kRecordBlock = 256;

__global__ void __launch_bounds__(kRecordBlock)
    trace_record_kernel(const TraceParams p, const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ urand,
                        const float* __restrict__ tris,
                        const float* __restrict__ sphs,
                        const float* __restrict__ mats,
                        const float* __restrict__ sky,
                        float* __restrict__ color, int32_t* __restrict__ sel) {
  __shared__ float s_tri[kMaxTri * kTriStride];
  __shared__ float s_sph[kMaxSph * kSphStride];
  __shared__ float s_mat[kMaxMats * kMatStride];
  __shared__ float s_sky[8];

  const int tid = threadIdx.x;
  for (int i = tid; i < p.n_tri * kTriStride; i += blockDim.x) s_tri[i] = tris[i];
  for (int i = tid; i < p.n_sph * kSphStride; i += blockDim.x) s_sph[i] = sphs[i];
  for (int i = tid; i < kMaxMats * kMatStride; i += blockDim.x) s_mat[i] = mats[i];
  if (tid < 8) s_sky[tid] = sky[tid];
  __syncthreads();

  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + tid;
  if (ray >= p.n_rays) return;  // ragged end
  const SceneTables sc = {s_tri, s_sph, s_mat, s_sky,
                          p.n_tri, p.n_sph, p.num_mats};
  record_ray(p, sc, ray, o, d, urand, color, sel);
}

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int ptre_trace_record(const ptre::TraceParams* params,
                                 const float* o, const float* d,
                                 const float* urand, const float* tris,
                                 const float* sphs, const float* mats,
                                 const float* sky, float* color, int32_t* sel,
                                 void* stream) {
  const ptre::TraceParams p = *params;
  if (p.n_rays < 1 || p.n_tri < 1 || p.n_tri > ptre::kMaxTri ||
      p.n_sph < 1 || p.n_sph > ptre::kMaxSph || p.num_mats > ptre::kMaxMats ||
      p.max_depth < 1 || p.max_depth > ptre::kMaxDepth ||
      (p.external_rng && urand == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (p.n_rays + ptre::kRecordBlock - 1) / ptre::kRecordBlock;
  ptre::trace_record_kernel<<<grid, ptre::kRecordBlock, 0,
                              (cudaStream_t)stream>>>(
      p, o, d, urand, tris, sphs, mats, sky, color, sel);
  return (int)cudaGetLastError();
}
