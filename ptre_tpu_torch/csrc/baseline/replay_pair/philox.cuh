// Frozen header of the yardsticks in this directory (not the library's):
// csrc/philox.cuh as the first designs here (replay_kernel.cu: replay_fwd_kernel,
// replay_bwd_kernel) were shipped with it. They are built against this
// copy, so a later change to the shipped header shows as a difference from
// them instead of passing by construction. The copies one directory up
// belong to older yardsticks.
//
// Philox4x32-10 counter-based RNG (Salmon et al., SC'11; Random123's
// philox4x32_R), shared by the CUDA kernel and its host build.
//
// Bit-identical to ptre_tpu_torch/ops/rng.py: same counter layout, same key
// schedule, same word -> [0, 1) mapping. Replaces the TPU hardware PRNG of
// ptre_tpu/ops/pallas/render_kernel.py:111-128 (mapped by megakernel._u01,
// megakernel.py:226).
#pragma once

#include <stdint.h>

// Functions shared by the kernel (nvcc) and its host build (g++).
#ifndef PTRE_HD
#ifdef __CUDACC__
#define PTRE_HD __host__ __device__ __forceinline__
#else
#define PTRE_HD inline
#endif
#endif

namespace ptre {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

PTRE_HD uint32_t mulhilo32(uint32_t a, uint32_t b, uint32_t* hi) {
#ifdef __CUDA_ARCH__
  *hi = __umulhi(a, b);
  return a * b;
#else
  const uint64_t p = (uint64_t)a * (uint64_t)b;
  *hi = (uint32_t)(p >> 32);
  return (uint32_t)p;
#endif
}

struct Philox4 {
  uint32_t w[4];
};

// Ten rounds; the first uses the key as given, each later one bumps it.
PTRE_HD Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                              uint32_t c3, uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo32(kPhiloxM0, c0, &hi0);
    const uint32_t lo1 = mulhilo32(kPhiloxM1, c2, &hi1);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Philox4 out = {{c0, c1, c2, c3}};
  return out;
}

// 32-bit word -> float in [0, 1): (w >> 8) * 2^-24, exact in float32.
PTRE_HD float u01(uint32_t w) { return (float)(w >> 8) * 5.9604644775390625e-08f; }

// The render kernel's in-kernel uniforms. Draw pair k (k = 0 the pixel
// jitter, k = 1 + b bounce b's scatter pair) comes from the block with
// counter (pixel, sample, k >> 1, 0) and key (seed_lo, seed_hi): words 0-1
// for even k, 2-3 for odd k. Keyed by counter, never by call order, so a
// path that ends early skips draws without shifting any other.
struct PhiloxUniforms {
  uint32_t key0, key1, pixel, sample;
  int block_id;
  Philox4 block;

  PTRE_HD PhiloxUniforms() {}  // a lane's slot, filled when it takes a path
  PTRE_HD PhiloxUniforms(uint32_t k0, uint32_t k1, uint32_t pix, uint32_t smp)
      : key0(k0), key1(k1), pixel(pix), sample(smp), block_id(-1) {}

  PTRE_HD void pair(int k, float* u1, float* u2) {
    if ((k >> 1) != block_id) {
      block_id = k >> 1;
      block = philox4x32_10(pixel, sample, (uint32_t)block_id, 0u, key0, key1);
    }
    // selects, not a dynamic index: keeps the block in registers
    const bool odd = (k & 1) != 0;
    *u1 = u01(odd ? block.w[2] : block.w[0]);
    *u2 = u01(odd ? block.w[3] : block.w[1]);
  }
};

}  // namespace ptre
