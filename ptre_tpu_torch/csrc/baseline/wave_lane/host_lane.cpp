// Host build of the bounce kernel's design before the warp sweep
// (wave_kernel.cu in this directory): each live ray walks its block's
// shortlist on its own and sweeps a leaf whose box it passes itself on its
// own lane (wave.cuh sweep_leaf), per column on the CPU. A yardstick, never
// in the library: the shipped per-ray bodies (wave.cuh, trace.cuh,
// philox.cuh), built with g++ as
//
//   g++ -std=c++17 -O2 -shared -fPIC -I ptre_tpu_torch/csrc -o libptre_wave_lane.so
//       host_lane.cpp
//
// tests/test_torch_wave_warp.py holds csrc/host_wave.cpp's warp walk to it
// bit for bit (g++ contracts no a*b+c, so both compute the same floats).

#include "wave.cuh"

extern "C" void ptre_wave_bounce_host(const ptre::WaveParams* params,
                                      const float* state, const int32_t* ids,
                                      const int32_t* shortlist,
                                      const int32_t* counts, const float* tris,
                                      const float* rows, const float* boxes,
                                      const float* sphs, const float* mats,
                                      const float* sky, const float* urand,
                                      float* out, int32_t* sel, int lanes) {
  const ptre::WaveParams& p = *params;
  const ptre::SceneTables sc = {tris, sphs, mats, sky, 0, p.n_sph, p.num_mats};
  for (int64_t col = 0; col < p.r_pad; ++col) {
    const int64_t b = col / lanes;
    ptre::WaveRay r = ptre::load_ray(state, col, p.r_pad);
    if (r.act > 0.5f) {
      ptre::TriBest best = {ptre::kBig, 0, false};
      const float iv[3] = {ptre::slab_inv(r.d[0]), ptre::slab_inv(r.d[1]),
                           ptre::slab_inv(r.d[2])};
      for (int k = 0; k < counts[b]; ++k) {
        const int leaf = shortlist[b * p.list_stride + k];
        // the ray's own cull, bounded by its closest hit so far
        if (!ptre::slab_pass_within(boxes + leaf * ptre::kBoxStride, r.o, iv, p.t_min,
                                    best.t)) {
          continue;
        }
        ptre::sweep_leaf(rows + (int64_t)leaf * ptre::kLeaf * ptre::kRowStride, leaf, r,
                         p, best);
      }
      if (sel != nullptr) {
        const ptre::WinnerWriter rec = {ptre::sel_slot(sel, p, p.bounce, ids[col])};
        ptre::finish_bounce_at(p, sc, best, ids[col], urand, rec, r);
      } else {
        ptre::finish_bounce_at(p, sc, best, ids[col], urand, ptre::NoWinner(), r);
      }
    }
    ptre::store_ray(out, col, p.r_pad, r);
  }
}
