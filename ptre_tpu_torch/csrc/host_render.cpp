// Host build of the render kernel's per-pixel body, for checks on machines
// without a GPU: the same render_pixel_at (trace.cuh, philox.cuh) that
// render_kernel.cu runs per thread, looped over the image on the CPU.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host.so host_render.cpp
//
// tests/test_torch_csrc_host.py builds it this way and holds it against the
// plain PyTorch version.

#include "trace.cuh"

extern "C" void ptre_render_sample_host(const ptre::RenderParams* params,
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
