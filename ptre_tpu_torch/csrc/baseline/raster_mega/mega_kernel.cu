// A yardstick, not part of the kernel library (ops/cuda/build.py builds
// the units of csrc/ only): the culled megakernel's first design — the
// block's votes (__syncthreads_or) on every supertile and leaf box, a
// passing leaf's rows staged into shared memory and swept by every live
// thread of the block — kept as it was shipped, with the headers it was
// shipped with (frozen copies in this directory), so that chip_smoke.py can
// build it, hold the shipped kernel's colours and selections to it ray for
// ray and time the two in turns on the same inputs.
//
// Culled megakernel for Hopper (sm_90a): the whole bounce loop of one sample
// over Morton-ordered 64-row leaves, in one launch.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/megakernel.py _mega_kernel
// (:237, launched at :1079). One CUDA block per 256 rays, one thread per
// ray, the path state (o, d, colour, live) in registers across all bounces.
// Per bounce the block walks the supertiles (8 leaves each) in ascending
// order: every live thread tests the supertile's union box against its own
// ray, bounded by its own closest hit so far (slab_pass_within), and
// __syncthreads_or is the block's vote; a supertile that passes is walked
// leaf by leaf with the same vote per leaf, and a passing leaf's 64 compact
// intersection rows (3 KB, wave.cuh kRowStride) are staged into shared memory
// with 16-byte loads and swept by every live thread (wave.cuh sweep_leaf:
// strict t < best, so ties go to the lowest Morton row within a leaf and
// across the ascending walk). The votes read the dilated cull boxes.
// Then, per thread, wave.cuh finish_bounce: spheres bounded by the best
// triangle, the winner's row read by index from global memory, its
// attributes re-derived, shading, the next ray. A block stops at the first
// bounce none of its rays reaches (one vote per bounce). The recording
// instantiation writes every bounce's winner as a unified-table row (-1 for
// a miss, a dead ray or a bounce never reached) into sel (B, R) int32.
//
// The sweep and the finish are the wavefront bounce kernel's device
// functions, so this kernel and the wavefront compute the same arithmetic:
// they differ only in which leaves a ray gets to see (both conservative).
//
// What bounds it on this card: divergent float32 ALU work. Rays are not
// re-sorted between bounces, so after bounce 0 the rays of a block diverge
// and the block's vote passes many more leaves than a sorted wavefront
// block's shortlist holds; every live thread sweeps each passing leaf. The
// bytes are small: 24 B a ray in, 12 B (+ 4 B a bounce) out, and the leaf
// tables (0.8 MB of compact rows, 2.1 MB of 32-float rows at 16,256 rows)
// stay in the 50 MB L2. The design spends no
// launch, host read or sort between bounces, which is what the wavefront
// pays for its tighter shortlists (measured, one sample at max_depth 5:
// 24.3-25.3 ms on 16,140 triangles + 2 spheres at 1920x1080, the live
// threads sweeping 8.1x the (ray, leaf) pairs the rays themselves pass;
// 1.78-1.87 ms on 16,128 triangles at 512x512; 48 registers, no spills;
// NVIDIA H100 80GB HBM3, 700.00 W).
//
// Not carried over from the TPU kernel: the (56, lanes) VMEM scratch (the
// state lives in registers), the one-hot MXU gathers of the winner (a direct
// row read), f32 row indices (int32 here), the hardware PRNG (Philox keyed
// (seed, ray, sample, draw), or external uniforms), the triangle table
// padded to whole supertiles (only the box table is: an empty box never
// passes, so its leaf is never staged) and the zero-initialised (4B, lanes)
// selection block.

#include <cuda_runtime.h>

#include "wave.cuh"

namespace ptre {

__device__ __forceinline__ void stage_leaf(float* s_leaf, const float* rows,
                                           int leaf, int tid, int n_threads) {
  const float4* src =
      reinterpret_cast<const float4*>(rows + (int64_t)leaf * kLeaf * kRowStride);
  float4* dst = reinterpret_cast<float4*>(s_leaf);
  for (int i = tid; i < kLeaf * kRowStride / 4; i += n_threads) dst[i] = __ldg(src + i);
}

template <bool kRecord>
__global__ void __launch_bounds__(kMaxLanes)
    mega_kernel(const MegaParams p, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ urand,
                const float* __restrict__ tris, const float* __restrict__ rows,
                const float* __restrict__ boxes,
                const float* __restrict__ boxes2,
                const float* __restrict__ sphs, const float* __restrict__ mats,
                const float* __restrict__ sky, float* __restrict__ color,
                int32_t* __restrict__ sel) {
  __shared__ __align__(16) float s_leaf[kLeaf * kRowStride];
  __shared__ float s_mat[kMaxMats * kMatStride];
  __shared__ float s_sky[8];

  const int tid = threadIdx.x;
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + tid;
  const bool valid = ray < p.w.n_rays;  // the ragged last block
  WaveRay r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = valid ? o[3 * ray + k] : 0.0f;
    r.d[k] = valid ? d[3 * ray + k] : 0.0f;
    r.c[k] = 1.0f;
  }
  r.act = valid ? 1.0f : 0.0f;
  for (int i = tid; i < kMaxMats * kMatStride; i += blockDim.x) s_mat[i] = mats[i];
  if (tid < 8) s_sky[tid] = sky[tid];
  __syncthreads();

  WaveParams wp = p.w;
  const SceneTables sc = {tris, sphs, s_mat, s_sky, 0, wp.n_sph, wp.num_mats};
  int bounce = 0;
  // every thread, dead or ragged, reaches every vote and barrier below: the
  // loop bounds and the votes' results are uniform over the block
  for (; bounce < p.max_depth; ++bounce) {
    const bool live = r.act > 0.5f;
    if (!__syncthreads_or(live)) break;  // no ray of the block goes on
    wp.bounce = bounce;
    TriBest best = {kBig, 0, false};
    if (p.cull) {
      const float iv[3] = {slab_inv(r.d[0]), slab_inv(r.d[1]), slab_inv(r.d[2])};
      for (int js = 0; js < p.n_super; ++js) {
        if (!__syncthreads_or(live && slab_pass_within(boxes2 + js * kBoxStride, r.o, iv,
                                                       wp.t_min, best.t))) {
          continue;
        }
        for (int jj = 0; jj < kSuper; ++jj) {
          const int leaf = js * kSuper + jj;
          // the vote is also the barrier after the previous leaf's sweep
          if (!__syncthreads_or(live && slab_pass_within(boxes + leaf * kBoxStride, r.o,
                                                         iv, wp.t_min, best.t))) {
            continue;
          }
          stage_leaf(s_leaf, rows, leaf, tid, blockDim.x);
          __syncthreads();
          if (live) sweep_leaf(s_leaf, leaf, r, wp, best);
        }
      }
    } else {
      for (int leaf = 0; leaf < wp.n_leaf; ++leaf) {
        __syncthreads();  // every thread is done with the previous leaf
        stage_leaf(s_leaf, rows, leaf, tid, blockDim.x);
        __syncthreads();
        if (live) sweep_leaf(s_leaf, leaf, r, wp, best);
      }
    }
    if (live) {
      if (kRecord) {
        const WinnerWriter rec = {sel_slot(sel, wp, bounce, (int32_t)ray)};
        finish_bounce_at(wp, sc, best, (int32_t)ray, urand, rec, r);
      } else {
        finish_bounce_at(wp, sc, best, (int32_t)ray, urand, NoWinner(), r);
      }
    } else if (kRecord && valid) {
      *sel_slot(sel, wp, bounce, (int32_t)ray) = -1;
    }
  }
  if (valid) {
    if (kRecord) {
      for (; bounce < p.max_depth; ++bounce) *sel_slot(sel, wp, bounce, (int32_t)ray) = -1;
    }
    for (int k = 0; k < 3; ++k) color[3 * ray + k] = r.c[k];
  }
}

}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// o, d, color are (n_rays, 3); tris (n_leaf * 64, 32) and rows (n_leaf * 64,
// 12) hold the same leaves; boxes (n_super * 8, 8) and boxes2 (n_super, 8)
// are read only with `cull`; with `sel` (max_depth, n_rays) int32 the
// recording instantiation runs. `lanes` rays per block.
extern "C" int ptre_trace_culled(const ptre::MegaParams* params, const float* o,
                                 const float* d, const float* urand,
                                 const float* tris, const float* rows,
                                 const float* boxes,
                                 const float* boxes2, const float* sphs,
                                 const float* mats, const float* sky,
                                 float* color, int32_t* sel, int lanes,
                                 void* stream) {
  const ptre::MegaParams p = *params;
  if (p.w.n_rays < 1 || p.w.n_leaf < 0 || p.w.n_sph < 0 ||
      p.w.num_mats > ptre::kMaxMats || p.max_depth < 1 || lanes < 32 ||
      lanes > ptre::kMaxLanes || lanes % 32 != 0 ||
      (p.cull && (p.n_super * ptre::kSuper < p.w.n_leaf || boxes == nullptr ||
                  boxes2 == nullptr)) ||
      (p.w.external_rng && urand == nullptr) ||
      (sel != nullptr && (p.w.n_sel != p.w.n_rays || p.w.sph_offset < 0)) ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_blocks = (p.w.n_rays + lanes - 1) / lanes;
  if (sel != nullptr) {
    ptre::mega_kernel<true><<<n_blocks, lanes, 0, (cudaStream_t)stream>>>(
        p, o, d, urand, tris, rows, boxes, boxes2, sphs, mats, sky, color, sel);
  } else {
    ptre::mega_kernel<false><<<n_blocks, lanes, 0, (cudaStream_t)stream>>>(
        p, o, d, urand, tris, rows, boxes, boxes2, sphs, mats, sky, color, sel);
  }
  return (int)cudaGetLastError();
}
