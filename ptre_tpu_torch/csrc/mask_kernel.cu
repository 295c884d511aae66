// Wavefront cull-mask kernel for Hopper (sm_90a): for each (ray block, leaf)
// the slab verdict, ORed over the block's live rays.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/wavefront.py _mask_kernel
// (:102, launched at :164). One CUDA block per ray block, one thread per ray
// of the sorted state; the leaf boxes of pack_tile_boxes (n_leaf x 8 floats,
// ~8 KB for a 16k-triangle scene) are staged into shared memory once per
// block, so every thread reads leaf l's box at one address (a broadcast).
// For each leaf the threads test their ray and __syncthreads_or gives the
// block's verdict; a block with no live ray writes zeros and stops. Output:
// the dense (nb, n_leaf) uint8 mask that PyTorch compacts into shortlists.
//
// What bounds it on this card: arithmetic, not bytes. The slab test is ~30
// float ops per (ray, leaf): 254 leaves at 2,073,600 rays is ~16 GFLOP a
// bounce, against 2 MB of mask written. The per-leaf block barrier (one
// __syncthreads_or per leaf) is the cost the design accepts for a verdict
// that needs no atomics and no second pass (measured 0.63 ms on config 4's
// bounce-1 state at 1920x1080, NVIDIA H100 80GB HBM3, 700.00 W). The slab
// test has no a*b+c, so the verdicts equal the plain version's exactly.
//
// Not carried over from the TPU kernel: the transposed 16-column state,
// 8-ray sublane chunks, 128-lane verdict groups and the f32 verdicts.

#include <cuda_runtime.h>

#include "wave.cuh"

namespace ptre {

constexpr int kMaxMaskLeaves = 1024;  // 32 KB of boxes: fits static shared memory

__global__ void __launch_bounds__(kMaxLanes)
    wave_mask_kernel(const MaskParams p, const float* __restrict__ state,
                     const float* __restrict__ boxes, uint8_t* __restrict__ mask) {
  __shared__ float s_box[kMaxMaskLeaves * kBoxStride];
  const int tid = threadIdx.x;
  for (int i = tid; i < p.n_leaf * kBoxStride; i += blockDim.x) s_box[i] = boxes[i];

  const int64_t col = (int64_t)blockIdx.x * blockDim.x + tid;
  const WaveRay r = load_ray(state, col, p.r_pad);
  const bool live = r.act > 0.5f;
  uint8_t* row = mask + (int64_t)blockIdx.x * p.n_leaf;
  // also the barrier after staging: every thread reaches it
  if (!__syncthreads_or(live)) {
    for (int l = tid; l < p.n_leaf; l += blockDim.x) row[l] = 0;
    return;
  }
  const float iv[3] = {slab_inv(r.d[0]), slab_inv(r.d[1]), slab_inv(r.d[2])};
  for (int l = 0; l < p.n_leaf; ++l) {
    const bool ok = live && slab_pass(s_box + l * kBoxStride, r.o, iv, p.t_min);
    const int any = __syncthreads_or(ok);
    if (tid == 0) row[l] = any ? 1 : 0;
  }
}

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// `lanes` rays per block; r_pad must be a whole number of blocks.
extern "C" int ptre_wave_mask(const ptre::MaskParams* params, const float* state,
                              const float* boxes, uint8_t* mask, int lanes,
                              void* stream) {
  const ptre::MaskParams p = *params;
  if (p.n_leaf < 1 || p.n_leaf > ptre::kMaxMaskLeaves || lanes < 32 ||
      lanes > ptre::kMaxLanes || lanes % 32 != 0 || p.r_pad % lanes != 0) {
    return (int)cudaErrorInvalidValue;
  }
  ptre::wave_mask_kernel<<<p.r_pad / lanes, lanes, 0, (cudaStream_t)stream>>>(
      p, state, boxes, mask);
  return (int)cudaGetLastError();
}
