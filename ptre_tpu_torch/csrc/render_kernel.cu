// Whole-sample render kernel for Hopper (sm_90a): one progressive sample of
// the path tracer in one launch.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/render_kernel.py
// _render_kernel (:79, launched at :192), which inlines megakernel.py
// _trace_block (:811), _scatter_shade (:611) and _u01 (:226): jitter,
// closed-form camera ray, up to max_depth bounces over the dense scene
// (<= 64 triangles, <= 64 spheres, any number of materials), clamp +
// non-finite scrub, and the running average on the public (H, W, 3)
// accumulator, updated in place.
//
// What bounds it on this card: divergent float32 ALU work, not bytes. A
// sample reads and writes the 25 MB accumulator at 1080p once (microseconds
// at 3.35 TB/s), while every live ray-bounce sweeps the scene, and paths end
// at different bounces: most after one or two, against max_depth 5. The
// design (trace.cuh):
//   * lanes refilled with new paths: a warp owns a 16x4 pixel tile and
//     each lane one path, advanced a bounce at a time; a lane whose path
//     ended writes its pixel's running average, once, and takes the tile's
//     next pixel (a warp-uniform cursor, __ballot_sync / __popc), so a warp
//     no longer runs as many bounces as its longest path with its finished
//     lanes idle. No global atomics, no extra launch;
//   * scene rows derived once a block: warp 0 writes each valid triangle's
//     v0, edges, normals, material and index as five 16-byte vectors in
//     shared memory, ascending; the sweep skips a group of 8 rows whose
//     box the ray misses, reads three vectors a row, every lane of a warp
//     at the same address (a broadcast), and leaves a candidate as soon as
//     |det| or u decides it;
//   * a hit's material row is read by index (trace.cuh material_row) from
//     the table in global memory (32 B a row, through L1/L2), whatever its
//     size: no scan of the rows and no copy in shared memory;
//   * the ragged image edge shrinks the edge tiles (1080 is not a multiple
//     of 16): no lane takes a pixel outside the image;
//   * random numbers come from Philox keyed by (seed, pixel, sample, draw),
//     or from an external uniform tensor for parity runs.
// The kernel is trace.cuh's dense_kernel over RenderJob; with `stats` a
// separate instantiation counts the scheduler's work (trace.cuh kStats) and,
// with `lens`, writes each pixel's path length.
// No wgmma/TMA: there is no matrix product here.

#include <cuda_runtime.h>

#include "trace.cuh"

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// `cam`: the camera's 18 rows (render_kernel.camera_rows) on the card.
// `stats`: null, or kStats uint64 counters the counting instantiation adds
// to (trace.cuh); `lens`: null, or (H, W) int32 bounces a path, written by
// the counting instantiation.
extern "C" int ptre_render_sample(const ptre::RenderParams* params,
                                  const float* cam, float* accum, const float* urand,
                                  const float* tris, const float* sphs,
                                  const float* mats, const float* sky,
                                  unsigned long long* stats, int32_t* lens,
                                  void* stream) {
  const ptre::RenderParams p = *params;
  if (p.n_tri < 1 || p.n_tri > ptre::kMaxTri || p.n_sph < 1 ||
      p.n_sph > ptre::kMaxSph || p.num_mats > ptre::kMaxMaterials ||
      p.width < 1 || p.height < 1 || cam == nullptr ||
      (p.external_rng && urand == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const ptre::SceneTables tab = {tris, sphs, mats, sky, p.n_tri, p.n_sph, p.num_mats};
  if (p.external_rng) {
    const ptre::RenderJob<ptre::ExternalSource> job = {
        p, {urand, (int64_t)p.height * p.width}, accum, cam};
    return ptre::launch_dense(job, tab, stats, lens, stream);
  }
  const ptre::RenderJob<ptre::PhiloxSource> job = {
      p, {p.seed_lo, p.seed_hi, p.sample}, accum, cam};
  return ptre::launch_dense(job, tab, stats, lens, stream);
}

extern "C" const char* ptre_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
