// Closest-hit sweep kernel for Hopper (sm_90a): the staged route's
// brute-force selection of each ray's winning triangle and sphere.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/intersect_kernel.py
// _sweep_kernel (:95, launched at :232). One thread per ray, 256-thread
// blocks. The block walks the triangle table in chunks of 256 rows: all
// threads stage a chunk (12 KB: world v0, e1, e2, valid) into shared memory
// with 16-byte loads, then every live thread runs Moller-Trumbore over the
// chunk, rows read as broadcasts (sweep.cuh test_triangle). The sphere table
// follows in the same way, bounded by the triangle winner's t. Outputs are
// selections only, (4, R) int32: i_tri, hit_tri, i_sph, hit_sph. The sweep
// is detached: gradients flow through the O(R) recompute of
// ops/intersect.closest_hit, so there is no adjoint.
//
// What bounds it on this card: float32 ALU work. Counted as written, a
// triangle test is 46 operations (9 for d x e2, 5 for det, 1 division, 3 + 6
// + 9 + 6 + 6 for tvec, u, qvec, v, t, 1 for u + v) and a sphere test 20,
// so R x (T_valid x 46 + S_valid x 20) operations against 67 TFLOP/s, with
// no FMA: this unit is built with -fmad=false so that its selections equal
// the plain version's exactly. The bytes are 24 B a ray in and 16 B out,
// plus the tables, read once per block from L2 (48 B a triangle row: 3.1 MB
// for 65,024 rows, inside the 50 MB L2). Shared memory (12 KB a block) does
// not limit occupancy; registers do. Every thread, ragged ones past R
// included, reaches every staging barrier.
//
// Not carried over from the TPU kernel: the (8, R) ray rows, the adaptive
// primitive tiles and lane widths, and the Python-unrolled static tiles
// (Mosaic could not slice the resident table dynamically): a plain loop over
// chunks does it here, for any T and S, 0 included.

#include <cuda_runtime.h>

#include "sweep.cuh"

namespace ptre {
namespace sweep {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // table rows staged per round

__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const SweepParams p, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ tris,
                 const float* __restrict__ sphs, int32_t* __restrict__ out) {
  __shared__ __align__(16) float s_rows[kChunk * kTriStride];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.n_rays;
  float ro[3] = {0.0f, 0.0f, 0.0f}, rd[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    for (int k = 0; k < 3; ++k) {
      ro[k] = o[3 * i + k];
      rd[k] = d[3 * i + k];
    }
  }
  float4* dst = reinterpret_cast<float4*>(s_rows);

  Best tri = {kBig, 0, false};
  for (int base = 0; base < p.n_tri; base += kChunk) {
    const int n = min(kChunk, p.n_tri - base);
    const float4* src = reinterpret_cast<const float4*>(tris + (int64_t)base * kTriStride);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = threadIdx.x; k < n * kTriStride / 4; k += blockDim.x) dst[k] = __ldg(src + k);
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) test_triangle(s_rows + j * kTriStride, base + j, ro, rd, p, tri);
    }
  }

  const float bound = sphere_bound(tri, p);
  Best sph = {kBig, 0, false};
  for (int base = 0; base < p.n_sph; base += kChunk) {
    const int n = min(kChunk, p.n_sph - base);
    const float4* src = reinterpret_cast<const float4*>(sphs + (int64_t)base * kSphStride);
    __syncthreads();
    for (int k = threadIdx.x; k < n * kSphStride / 4; k += blockDim.x) dst[k] = __ldg(src + k);
    __syncthreads();
    if (live) {
      for (int s = 0; s < n; ++s) test_sphere(s_rows + s * kSphStride, base + s, ro, rd, bound, p, sph);
    }
  }
  if (live) store(out, i, p.n_rays, tri, sph);
}

}  // namespace sweep
}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// o, d: (n_rays, 3) float32; tris (n_tri, 12), sphs (n_sph, 8) float32,
// 16-byte aligned; out (4, n_rays) int32.
extern "C" int ptre_sweep(const ptre::sweep::SweepParams* params, const float* o,
                          const float* d, const float* tris, const float* sphs,
                          int32_t* out, void* stream) {
  const ptre::sweep::SweepParams p = *params;
  if (p.n_rays < 0 || p.n_tri < 0 || p.n_sph < 0 ||
      reinterpret_cast<uintptr_t>(tris) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(sphs) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.n_rays == 0) return (int)cudaSuccess;
  const int blocks = (p.n_rays + ptre::sweep::kThreads - 1) / ptre::sweep::kThreads;
  ptre::sweep::sweep_kernel<<<blocks, ptre::sweep::kThreads, 0, (cudaStream_t)stream>>>(
      p, o, d, tris, sphs, out);
  return (int)cudaGetLastError();
}
