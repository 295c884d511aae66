// Host build of the render kernel, for checks on machines without a GPU: the
// same derived rows, RenderJob and warp scheduler (trace.cuh, philox.cuh)
// that render_kernel.cu runs, each 16x4 tile's warp simulated lane by lane
// by host_dense.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host.so host_render.cpp
//
// tests/test_torch_csrc_host.py builds it this way and holds it against the
// plain PyTorch version and, bit for bit, against the first design's
// path-at-a-time loop (csrc/baseline/host_first.cpp).

#include "trace.cuh"

// `stats`: null, or ptre::kStats counters added to as the counting
// instantiation adds to them; `lens`: null, or (H, W) bounces a path;
// `cam`: the camera's 18 rows, as the kernel takes them.
extern "C" void ptre_render_sample_host(const ptre::RenderParams* params,
                                        const float* cam, float* accum, const float* urand,
                                        const float* tris, const float* sphs,
                                        const float* mats, const float* sky,
                                        uint64_t* stats, int32_t* lens) {
  const ptre::RenderParams& p = *params;
  const ptre::SceneTables tab = {tris, sphs, mats, sky, p.n_tri, p.n_sph, p.num_mats};
  if (p.external_rng) {
    const ptre::RenderJob<ptre::ExternalSource> job = {
        p, {urand, (int64_t)p.height * p.width}, accum, cam};
    ptre::host_dense(job, tab, stats, lens);
  } else {
    const ptre::RenderJob<ptre::PhiloxSource> job = {p, {p.seed_lo, p.seed_hi, p.sample},
                                                     accum, cam};
    ptre::host_dense(job, tab, stats, lens);
  }
}
