// Host build of the wavefront kernels' per-ray bodies, for checks on
// machines without a GPU: the same slab_pass, sweep_leaf and finish_bounce_at
// (wave.cuh, trace.cuh, philox.cuh) that mask_kernel.cu and wave_kernel.cu
// run per thread, looped over the ray blocks on the CPU. The sweep reads each
// listed leaf straight from the table instead of staging it.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_wave.so host_wave.cpp
//
// tests/test_torch_csrc_host.py builds it this way and holds it against the
// plain PyTorch versions.

#include "wave.cuh"

extern "C" void ptre_wave_mask_host(const ptre::MaskParams* params,
                                    const float* state, const float* boxes,
                                    uint8_t* mask, int lanes) {
  const ptre::MaskParams& p = *params;
  for (int64_t b = 0; b < p.r_pad / lanes; ++b) {
    for (int l = 0; l < p.n_leaf; ++l) {
      uint8_t any = 0;
      for (int64_t col = b * lanes; col < (b + 1) * lanes; ++col) {
        const ptre::WaveRay r = ptre::load_ray(state, col, p.r_pad);
        const float iv[3] = {ptre::slab_inv(r.d[0]), ptre::slab_inv(r.d[1]),
                             ptre::slab_inv(r.d[2])};
        if (r.act > 0.5f &&
            ptre::slab_pass(boxes + l * ptre::kBoxStride, r.o, iv, p.t_min)) {
          any = 1;
        }
      }
      mask[b * p.n_leaf + l] = any;
    }
  }
}

extern "C" void ptre_wave_bounce_host(const ptre::WaveParams* params,
                                      const float* state, const int32_t* ids,
                                      const int32_t* shortlist,
                                      const int32_t* counts, const float* tris,
                                      const float* sphs, const float* mats,
                                      const float* sky, const float* urand,
                                      float* out, int lanes) {
  const ptre::WaveParams& p = *params;
  const ptre::SceneTables sc = {tris, sphs, mats, sky, 0, p.n_sph, p.num_mats};
  for (int64_t col = 0; col < p.r_pad; ++col) {
    const int64_t b = col / lanes;
    ptre::WaveRay r = ptre::load_ray(state, col, p.r_pad);
    if (r.act > 0.5f) {
      ptre::TriBest best = {ptre::kBig, 0, false};
      for (int k = 0; k < counts[b]; ++k) {
        const int leaf = shortlist[b * p.list_stride + k];
        ptre::sweep_leaf(tris + (int64_t)leaf * ptre::kLeaf * ptre::kTriStride,
                         leaf, r, p, best);
      }
      ptre::finish_bounce_at(p, sc, best, ids[col], urand, r);
    }
    ptre::store_ray(out, col, p.r_pad, r);
  }
}
