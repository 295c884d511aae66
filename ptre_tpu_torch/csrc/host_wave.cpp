// Host build of the wavefront kernels' and the culled megakernel's per-ray
// bodies, for checks on machines without a GPU: the same slab_pass,
// slab_pass_within, sweep_leaf and finish_bounce_at (wave.cuh, trace.cuh,
// philox.cuh) that mask_kernel.cu, wave_kernel.cu and mega_kernel.cu run per
// thread, looped over the ray blocks on the CPU, a block's votes taken by a
// loop over its rays. The sweep reads each leaf's compact rows straight from
// the table instead of staging them.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_wave.so host_wave.cpp
//
// tests/test_torch_csrc_host.py builds it this way and holds it against the
// plain PyTorch versions.

#include <vector>

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

// mega_kernel.cu's block over every block of `lanes` rays: per bounce the
// two-level walk with the block's votes, the sweep and the finish. `sel`
// (max_depth, n_rays) int32 or null.
extern "C" void ptre_trace_culled_host(const ptre::MegaParams* params,
                                       const float* o, const float* d,
                                       const float* urand, const float* tris,
                                       const float* rows, const float* boxes,
                                       const float* boxes2,
                                       const float* sphs, const float* mats,
                                       const float* sky, float* color,
                                       int32_t* sel, int lanes) {
  const ptre::MegaParams& p = *params;
  ptre::WaveParams wp = p.w;
  const ptre::SceneTables sc = {tris, sphs, mats, sky, 0, wp.n_sph, wp.num_mats};
  const int64_t n = wp.n_rays;
  std::vector<ptre::WaveRay> rays(lanes);
  std::vector<ptre::TriBest> best(lanes);
  std::vector<float> iv(3 * lanes);
  for (int64_t base = 0; base < n; base += lanes) {
    const int m = (int)(n - base < lanes ? n - base : lanes);
    for (int i = 0; i < m; ++i) {
      for (int k = 0; k < 3; ++k) {
        rays[i].o[k] = o[3 * (base + i) + k];
        rays[i].d[k] = d[3 * (base + i) + k];
        rays[i].c[k] = 1.0f;
      }
      rays[i].act = 1.0f;
    }
    auto live = [&](int i) { return rays[i].act > 0.5f; };
    // the block's vote on one box row: any live ray passes, bounded by its best
    auto vote = [&](const float* box) {
      for (int i = 0; i < m; ++i) {
        if (live(i) && ptre::slab_pass_within(box, rays[i].o, &iv[3 * i], wp.t_min,
                                              best[i].t)) {
          return true;
        }
      }
      return false;
    };
    auto sweep = [&](int leaf) {
      const float* leaf_rows = rows + (int64_t)leaf * ptre::kLeaf * ptre::kRowStride;
      for (int i = 0; i < m; ++i) {
        if (live(i)) ptre::sweep_leaf(leaf_rows, leaf, rays[i], wp, best[i]);
      }
    };
    int bounce = 0;
    for (; bounce < p.max_depth; ++bounce) {
      bool any = false;
      for (int i = 0; i < m; ++i) any = any || live(i);
      if (!any) break;
      wp.bounce = bounce;
      for (int i = 0; i < m; ++i) {
        best[i] = {ptre::kBig, 0, false};
        for (int k = 0; k < 3; ++k) iv[3 * i + k] = ptre::slab_inv(rays[i].d[k]);
      }
      if (p.cull) {
        for (int js = 0; js < p.n_super; ++js) {
          if (!vote(boxes2 + js * ptre::kBoxStride)) continue;
          for (int jj = 0; jj < ptre::kSuper; ++jj) {
            const int leaf = js * ptre::kSuper + jj;
            if (vote(boxes + leaf * ptre::kBoxStride)) sweep(leaf);
          }
        }
      } else {
        for (int leaf = 0; leaf < wp.n_leaf; ++leaf) sweep(leaf);
      }
      for (int i = 0; i < m; ++i) {
        const int32_t id = (int32_t)(base + i);
        if (!live(i)) {
          if (sel != nullptr) *ptre::sel_slot(sel, wp, bounce, id) = -1;
        } else if (sel != nullptr) {
          const ptre::WinnerWriter rec = {ptre::sel_slot(sel, wp, bounce, id)};
          ptre::finish_bounce_at(wp, sc, best[i], id, urand, rec, rays[i]);
        } else {
          ptre::finish_bounce_at(wp, sc, best[i], id, urand, ptre::NoWinner(), rays[i]);
        }
      }
    }
    for (int i = 0; i < m; ++i) {
      const int32_t id = (int32_t)(base + i);
      if (sel != nullptr) {
        for (int b = bounce; b < p.max_depth; ++b) *ptre::sel_slot(sel, wp, b, id) = -1;
      }
      for (int k = 0; k < 3; ++k) color[3 * (base + i) + k] = rays[i].c[k];
    }
  }
}
