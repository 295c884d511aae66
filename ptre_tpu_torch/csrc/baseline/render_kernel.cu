// A yardstick, not part of the kernel library (ops/cuda/build.py builds
// the units of csrc/ only): the render kernel's first design — one thread a
// pixel in 16x16 blocks, a per-thread break where a path ends, the scene's
// triangle rows re-read and their edges re-derived by every ray at every
// bounce — kept as it was shipped, with the headers it was shipped with
// (frozen copies in this directory), so that chip_smoke.py can build it,
// hold the shipped kernel's image to it pixel for pixel and time the two in
// turns on the same inputs.
//
// Whole-sample render kernel for Hopper (sm_90a): one progressive sample of
// the path tracer in one launch.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/render_kernel.py
// _render_kernel (:79, launched at :192), which inlines megakernel.py
// _trace_block (:811), _scatter_shade (:611) and _u01 (:226). Each thread
// owns one pixel: jitter, closed-form camera ray, up to max_depth bounces
// over the dense scene (<= 64 triangles, <= 64 spheres, <= 8 materials),
// clamp + non-finite scrub, and the running average on the public (H, W, 3)
// accumulator, updated in place.
//
// What bounds it on this card: divergent float32 ALU work, not bytes. For
// the demo scene a sample reads and writes the 25 MB accumulator at 1080p
// once (microseconds at 3.35 TB/s), while every bounce runs a serial sweep
// of ~14 primitives per ray, and paths end at different bounces. The design:
//   * the scene tables (8 KB of triangles, the spheres, 8x8 materials, sky)
//     are staged into shared memory at block start; every thread of a warp
//     then reads triangle j at the same address, a broadcast — what the TPU
//     got from SMEM scalars;
//   * 16x16 pixel blocks keep a warp's rays spatially coherent (similar
//     primitives, similar path lengths), and a dead path leaves the loop
//     with a per-thread break instead of the TPU's per-block skip;
//   * the ragged image edge is masked (1080 is not a multiple of 16); no
//     tile-size gate as on the TPU;
//   * random numbers come from Philox keyed by (seed, pixel, sample, draw),
//     or from an external uniform tensor for parity runs.
// No wgmma/TMA: there is no matrix product here. Making it fast is later work.

#include <cuda_runtime.h>

#include "trace.cuh"

namespace ptre {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

__global__ void __launch_bounds__(kBlockX* kBlockY)
    render_sample_kernel(const RenderParams p, float* __restrict__ accum,
                         const float* __restrict__ urand,
                         const float* __restrict__ tris,
                         const float* __restrict__ sphs,
                         const float* __restrict__ mats,
                         const float* __restrict__ sky) {
  __shared__ float s_tri[kMaxTri * kTriStride];
  __shared__ float s_sph[kMaxSph * kSphStride];
  __shared__ float s_mat[kMaxMats * kMatStride];
  __shared__ float s_sky[8];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int i = tid; i < p.n_tri * kTriStride; i += nthr) s_tri[i] = tris[i];
  for (int i = tid; i < p.n_sph * kSphStride; i += nthr) s_sph[i] = sphs[i];
  for (int i = tid; i < kMaxMats * kMatStride; i += nthr) s_mat[i] = mats[i];
  if (tid < 8) s_sky[tid] = sky[tid];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;  // ragged edge

  const SceneTables sc = {s_tri, s_sph, s_mat, s_sky,
                          p.n_tri, p.n_sph, p.num_mats};
  render_pixel_at(p, sc, x, y, urand, accum);
}

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int ptre_render_sample(const ptre::RenderParams* params,
                                  float* accum, const float* urand,
                                  const float* tris, const float* sphs,
                                  const float* mats, const float* sky,
                                  void* stream) {
  const ptre::RenderParams p = *params;
  if (p.n_tri < 1 || p.n_tri > ptre::kMaxTri || p.n_sph < 1 ||
      p.n_sph > ptre::kMaxSph || p.num_mats > ptre::kMaxMats ||
      (p.external_rng && urand == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(ptre::kBlockX, ptre::kBlockY);
  const dim3 grid((p.width + ptre::kBlockX - 1) / ptre::kBlockX,
                  (p.height + ptre::kBlockY - 1) / ptre::kBlockY);
  ptre::render_sample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      p, accum, urand, tris, sphs, mats, sky);
  return (int)cudaGetLastError();
}

extern "C" const char* ptre_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
