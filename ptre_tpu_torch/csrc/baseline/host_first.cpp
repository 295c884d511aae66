// Host build of the first designs of the render and recording kernels
// (render_kernel.cu, record_kernel.cu in this directory), against the frozen
// headers here: their per-pixel and per-ray bodies, one path at a time.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_first.so host_first.cpp
//
// tests/test_torch_csrc_host.py and test_torch_csrc_grad_host.py hold the
// redesigned kernels' host builds (csrc/host_render.cpp, host_grad.cpp) to
// it bit for bit: g++ contracts no a*b+c without -mfma, so the two run the
// same float operations if the redesign reordered none.

#include "trace.cuh"

extern "C" void ptre_render_sample_first(const ptre::RenderParams* params,
                                         float* accum, const float* urand,
                                         const float* tris, const float* sphs,
                                         const float* mats, const float* sky) {
  const ptre::RenderParams& p = *params;
  const ptre::SceneTables sc = {tris, sphs, mats, sky,
                                p.n_tri, p.n_sph, p.num_mats};
  for (int y = 0; y < p.height; ++y) {
    for (int x = 0; x < p.width; ++x) {
      ptre::render_pixel_at(p, sc, x, y, urand, accum);
    }
  }
}

extern "C" void ptre_trace_record_first(const ptre::TraceParams* params,
                                        const float* o, const float* d,
                                        const float* urand, const float* tris,
                                        const float* sphs, const float* mats,
                                        const float* sky, float* color,
                                        int32_t* sel) {
  const ptre::TraceParams& p = *params;
  const ptre::SceneTables sc = {tris, sphs, mats, sky,
                                p.n_tri, p.n_sph, p.num_mats};
  for (int64_t ray = 0; ray < p.n_rays; ++ray)
    ptre::record_ray(p, sc, ray, o, d, urand, color, sel);
}
