// Recording forward of the gradient path for Hopper (sm_90a): rays in,
// unclamped color and per-bounce winner selections out.
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/megakernel.py
// _mega_kernel_dense (:734, launched at :1025) in its recording mode
// (record_sel, and record_ur for the hardware PRNG), as
// trace_fused_sel(..., planar="color", hw_rng=True) calls it (:1132-1222):
// the bounce loop of trace.cuh with the selection recorder; no
// accumulation, no clamp.
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
// work in the primitive sweep; the bytes (24 in, 12 + 4B out a ray) take
// microseconds. The design is the render kernel's (trace.cuh): a warp owns
// 64 consecutive rays, each lane one path, and a lane whose path ended
// writes its colour and the -1 selections after its last hit and takes the
// next ray of the tile; the scene's valid triangle rows are derived once a
// block into 16-byte vectors of shared memory, with a box a group of 8. The kernel is trace.cuh's
// dense_kernel over RecordJob; with `stats` a separate instantiation counts
// the scheduler's work (trace.cuh kStats) and, with `lens`, writes each ray's
// path length.

#include <cuda_runtime.h>

#include "trace.cuh"

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// `stats`: null, or kStats uint64 counters the counting instantiation adds
// to (trace.cuh); `lens`: null, or (R,) int32 bounces a path, written by the
// counting instantiation.
extern "C" int ptre_trace_record(const ptre::TraceParams* params,
                                 const float* o, const float* d,
                                 const float* urand, const float* tris,
                                 const float* sphs, const float* mats,
                                 const float* sky, float* color, int32_t* sel,
                                 unsigned long long* stats, int32_t* lens,
                                 void* stream) {
  const ptre::TraceParams p = *params;
  if (p.n_rays < 1 || p.n_tri < 1 || p.n_tri > ptre::kMaxTri ||
      p.n_sph < 1 || p.n_sph > ptre::kMaxSph || p.num_mats > ptre::kMaxMaterials ||
      p.max_depth < 1 || p.max_depth > ptre::kMaxDepth ||
      (p.external_rng && urand == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const ptre::SceneTables tab = {tris, sphs, mats, sky, p.n_tri, p.n_sph, p.num_mats};
  if (p.external_rng) {
    const ptre::RecordJob<ptre::ExternalSource> job = {p, {urand, p.n_rays}, o, d, color, sel};
    return ptre::launch_dense(job, tab, stats, lens, stream);
  }
  const ptre::RecordJob<ptre::PhiloxSource> job = {
      p, {p.seed_lo, p.seed_hi, p.sample}, o, d, color, sel};
  return ptre::launch_dense(job, tab, stats, lens, stream);
}
