// Closest-hit sweep kernel for Hopper (sm_90a): the staged route's selection
// of each ray's winning triangle and sphere, culled per ray over Morton
// leaves.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/intersect_kernel.py
// _sweep_kernel (:95, launched at :232), which tests every ray against every
// row. One thread per ray, 256-thread blocks. Each warp walks the leaves of
// wavefront.prepare_scene in ascending Morton order: a supertile's union
// box, then its leaves' boxes (dilated, 32 B each), every test bounded by
// the lane's own closest hit so far; a leaf that no lane passes is skipped
// by the warp (votes), and within a visited leaf only the lanes whose own
// ray passes its box run the 64 Moller-Trumbore tests, on (t, packet row)
// so the brute force's winner comes out. A dead ray (the bounce's `active`
// mask) does no test and gets (0, false, 0, false). The spheres follow per
// lane, bounded by the triangle winner. Outputs are selections only, (4, R)
// int32: i_tri, hit_tri, i_sph, hit_sph, in the packet's rows. The sweep is
// detached: gradients flow through the O(R) recompute of
// ops/intersect.closest_hit, so there is no adjoint.
//
// The boxes and a visited leaf's rows (64 x 48 B) are read from global
// memory: a warp's box reads are uniform and its sweeping lanes read the
// same row at once, so each load is one broadcast from L1 or L2 (the 3.1 MB
// row table sits in the 50 MB L2). Two designs measured slower on the card
// and were dropped (PERF.md §6): the boxes loaded into shared memory
// once a block (36.6 KB a block for the 65,024-row mesh: 2.26 against
// 1.86 ms on its primary rays), and the rows staged per warp with cp.async,
// double-buffered.
//
// What bounds it on this card: float32 ALU work, and on incoherent rays the
// warp's visits (a warp sweeps a leaf when any of its lanes passes it). The
// brute force tested R x T rows at 46 operations each (329.86-332.71 ms on
// 2,073,600 rays x 65,024 rows, NVIDIA H100 80GB HBM3, 700.00 W); the walk
// tests a ray's ~127 supertile boxes, the leaf boxes of the supertiles it
// passes, and 64 rows per leaf whose box it passes. With `stats` given, a
// separate instantiation also counts the box tests made, the supertiles and
// the (ray, leaf) pairs whose box a ray itself passes, the pairs swept by
// the warps and the live rays, for the bound in chip_smoke.py; a launch
// without `stats` counts nothing. Every thread, dead or ragged, reaches
// every vote.
//
// Not carried over from the TPU kernel: the (8, R) ray rows, the adaptive
// primitive tiles and lane widths, and the Python-unrolled static tiles
// (Mosaic could not slice the resident table dynamically).

#include <cuda_runtime.h>

#include "sweep.cuh"

namespace ptre {
namespace sweep {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLeafFloats = kLeaf * kRowStride;  // 768 floats, 3 KB

// The 64 compact rows of one leaf, each read as three 16-byte loads through
// the read-only path.
__device__ __forceinline__ void sweep_leaf_rows(const float* rows, const float o[3],
                                                const float d[3], const SweepParams& p,
                                                Best& tri) {
  for (int j = 0; j < kLeaf; ++j) {
    const float4* q = reinterpret_cast<const float4*>(rows + j * kRowStride);
    const float4 a = __ldg(q);
    const float4 b = __ldg(q + 1);
    const float4 c = __ldg(q + 2);
    const float row[kRowStride] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                   c.x, c.y, c.z, c.w};
    test_row(row, o, d, p, tri);
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const SweepParams p, const float* __restrict__ o,
                 const float* __restrict__ d, const uint8_t* __restrict__ active,
                 const float* __restrict__ rows, const float* __restrict__ lb,
                 const float* __restrict__ sb, const float* __restrict__ sphs,
                 int32_t* __restrict__ out, unsigned long long* __restrict__ stats) {
  // lb: leaf boxes, sb: supertile boxes
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.n_rays && (active == nullptr || active[i] != 0);
  float ro[3] = {0.0f, 0.0f, 0.0f}, rd[3] = {0.0f, 0.0f, 1.0f};
  if (live) {
    for (int k = 0; k < 3; ++k) {
      ro[k] = o[3 * i + k];
      rd[k] = d[3 * i + k];
    }
  }
  const float iv[3] = {slab_inv(rd[0]), slab_inv(rd[1]), slab_inv(rd[2])};
  const int n_live = __popc(__ballot_sync(kFull, live));
  // warp-uniform counts (kStats only): box tests made, supertiles and leaves
  // whose box a lane's own ray passes, (lane, leaf) slots of the warps' visits
  unsigned long long n_box = 0, n_super_passed = 0, n_passed = 0, n_swept = 0;
  Best tri = {kBig, 0, false};

  // The first leaf at or after `l` that some live lane of the warp passes,
  // with the lanes' bounds as they stand; n_leaf if none.
  auto next_leaf = [&](int l) {
    while (l < p.n_leaf) {
      if (l % kSuper == 0) {  // entering a supertile: its union box first
        const unsigned ps = __ballot_sync(
            kFull, live && slab_pass_within(sb + (l / kSuper) * kBoxStride, ro, iv, p.t_min,
                                            tri.t));
        if (kStats) {
          n_box += n_live;
          n_super_passed += __popc(ps);
        }
        if (ps == 0) {
          l += kSuper;
          continue;
        }
      }
      if (kStats) n_box += n_live;
      if (__any_sync(kFull, live && slab_pass_within(lb + l * kBoxStride, ro, iv, p.t_min,
                                                     tri.t))) {
        return l;
      }
      ++l;
    }
    return p.n_leaf;
  };
  // The lanes whose own ray passes leaf `l`'s box now sweep its rows.
  auto own_pass = [&](int l) {
    const bool pass = live && slab_pass_within(lb + l * kBoxStride, ro, iv, p.t_min, tri.t);
    if (kStats) {
      n_passed += __popc(__ballot_sync(kFull, pass));
      n_swept += n_live;
    }
    return pass;
  };

  if (n_live > 0) {  // a warp of dead or ragged lanes walks nothing
    for (int l = next_leaf(0); l < p.n_leaf; l = next_leaf(l + 1)) {
      if (own_pass(l)) sweep_leaf_rows(rows + (int64_t)l * kLeafFloats, ro, rd, p, tri);
    }
  }

  if (kStats && lane == 0) {
    atomicAdd(stats, n_box);
    atomicAdd(stats + 1, n_super_passed);
    atomicAdd(stats + 2, n_passed);
    atomicAdd(stats + 3, n_swept);
    atomicAdd(stats + 4, (unsigned long long)n_live);
  }
  if (i < p.n_rays) {
    const Best sph = live ? sweep_spheres(sphs, ro, rd, tri, p) : Best{kBig, 0, false};
    store(out, i, p.n_rays, tri, sph);
  }
}

}  // namespace sweep
}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// o, d: (n_rays, 3) float32; active: (n_rays,) bytes or null (all live);
// rows (n_leaf * 64, 12), boxes (n_super * 8, 8), boxes2 (n_super, 8) and
// sphs (n_sph, 16) float32, 16-byte aligned; out (4, n_rays) int32; stats
// null (nothing counted) or 5 uint64 counters that the launch adds to
// (sweep_kernel.py STATS).
extern "C" int ptre_sweep(const ptre::sweep::SweepParams* params, const float* o,
                          const float* d, const uint8_t* active, const float* rows,
                          const float* boxes, const float* boxes2, const float* sphs,
                          int32_t* out, unsigned long long* stats, void* stream) {
  namespace sw = ptre::sweep;
  const sw::SweepParams p = *params;
  if (p.n_rays < 0 || p.n_leaf < 0 || p.n_sph < 0 || p.n_super * ptre::kSuper < p.n_leaf ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(boxes2) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.n_rays == 0) return (int)cudaSuccess;
  const int blocks = (p.n_rays + sw::kThreads - 1) / sw::kThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stats != nullptr) {
    sw::sweep_kernel<true><<<blocks, sw::kThreads, 0, st>>>(p, o, d, active, rows, boxes,
                                                            boxes2, sphs, out, stats);
  } else {
    sw::sweep_kernel<false><<<blocks, sw::kThreads, 0, st>>>(p, o, d, active, rows, boxes,
                                                             boxes2, sphs, out, stats);
  }
  return (int)cudaGetLastError();
}
