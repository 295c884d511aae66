// Host build of the wavefront kernels' and the culled megakernel's per-ray
// bodies, for checks on machines without a GPU: the same slab_pass,
// super_union, slab_pass_within, sweep_leaf and finish_bounce_at (wave.cuh,
// trace.cuh, philox.cuh) that mask_kernel.cu, wave_kernel.cu and
// mega_kernel.cu run per thread, looped over the ray blocks or warps on the
// CPU, a warp's votes taken by a loop over its rays. The sweeps read each
// leaf's compact rows straight from the table instead of staging them.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_wave.so host_wave.cpp
//
// tests/test_torch_csrc_host.py and test_torch_culled_walk.py build it this
// way and hold it against the plain PyTorch versions and the culled
// megakernel's first design (csrc/baseline/raster_mega/).

#include <algorithm>
#include <vector>

#include "wave.cuh"

// mask_kernel.cu's block over every block of `lanes` rays: the supertile
// union boxes (super_union), then per warp of 32 rays the two-level walk —
// a supertile whose leaves are all listed is skipped, else its box is voted
// on by the live lanes, and, where one passes, each leaf not yet listed —
// into the block's bit mask, written as one byte a leaf. The kernel's warps
// run at once and list leaves in another order; the verdict is an OR, so
// the mask is the same.
extern "C" void ptre_wave_mask_host(const ptre::MaskParams* params,
                                    const float* state, const float* boxes,
                                    uint8_t* mask, int lanes) {
  const ptre::MaskParams& p = *params;
  const int n_super = (p.n_leaf + ptre::kSuper - 1) / ptre::kSuper;
  std::vector<float> sup((size_t)n_super * 6);
  for (int s = 0; s < n_super; ++s) ptre::super_union(boxes, p.n_leaf, s, &sup[s * 6]);
  std::vector<uint8_t> listed(p.n_leaf);
  for (int64_t b = 0; b < p.r_pad / lanes; ++b) {
    std::fill(listed.begin(), listed.end(), 0);
    for (int64_t w0 = b * lanes; w0 < (b + 1) * lanes; w0 += 32) {
      bool live[32];
      float o[32][3], iv[32][3];
      bool any_live = false;
      for (int l = 0; l < 32; ++l) {
        const ptre::WaveRay r = ptre::load_ray(state, w0 + l, p.r_pad);
        live[l] = r.act > 0.5f;
        any_live = any_live || live[l];
        for (int k = 0; k < 3; ++k) {
          o[l][k] = r.o[k];
          iv[l][k] = ptre::slab_inv(r.d[k]);
        }
      }
      if (!any_live) continue;
      auto vote = [&](const float* box) {
        for (int l = 0; l < 32; ++l)
          if (live[l] && ptre::slab_pass(box, o[l], iv[l], p.t_min)) return true;
        return false;
      };
      for (int s = 0; s < n_super; ++s) {
        const int l0 = s * ptre::kSuper;
        const int l1 = std::min(l0 + ptre::kSuper, (int)p.n_leaf);
        bool all = true;
        for (int l = l0; l < l1; ++l) all = all && listed[l];
        if (all || !vote(&sup[s * 6])) continue;
        for (int l = l0; l < l1; ++l)
          if (!listed[l] && vote(boxes + l * ptre::kBoxStride)) listed[l] = 1;
      }
    }
    for (int l = 0; l < p.n_leaf; ++l) mask[b * p.n_leaf + l] = listed[l];
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

namespace {

// mega_kernel.cu sweep_leaf_warp: for each lane of `passed` in ascending
// order, its ray against the leaf's 64 rows, the rows split between the 32
// lanes (row j on lane j % 32), each lane's strict t < best over its two rows,
// the lanes' (t, row) minimum by the kernel's butterfly, then merged into the
// ray's best with strict t < best.
void sweep_leaf_warp(const float* rows, int leaf, const bool* passed, int m,
                     const ptre::WaveRay* rays, const ptre::WaveParams& wp,
                     ptre::TriBest* best) {
  const float* leaf_rows = rows + (int64_t)leaf * ptre::kLeaf * ptre::kRowStride;
  for (int src = 0; src < m; ++src) {
    if (!passed[src]) continue;
    float t_min[32];
    int j_min[32];
    bool any = false;
    for (int lane = 0; lane < 32; ++lane) {
      t_min[lane] = ptre::kBig;
      j_min[lane] = ptre::kLeaf;
      for (int j = lane; j < ptre::kLeaf; j += 32) {
        float t;
        if (ptre::row_accepts(leaf_rows + j * ptre::kRowStride, rays[src].o, rays[src].d,
                              wp.t_min, wp.t_max, wp.det_eps, &t)) {
          any = true;
          if (t < t_min[lane]) {
            t_min[lane] = t;
            j_min[lane] = j;
          }
        }
      }
    }
    if (!any) continue;
    for (int off = 16; off > 0; off >>= 1) {  // __shfl_xor_sync, all lanes at once
      float t_o[32];
      int j_o[32];
      for (int lane = 0; lane < 32; ++lane) {
        t_o[lane] = t_min[lane ^ off];
        j_o[lane] = j_min[lane ^ off];
      }
      for (int lane = 0; lane < 32; ++lane) {
        if (t_o[lane] < t_min[lane] || (t_o[lane] == t_min[lane] && j_o[lane] < j_min[lane])) {
          t_min[lane] = t_o[lane];
          j_min[lane] = j_o[lane];
        }
      }
    }
    best[src].hit = true;
    if (t_min[src] < best[src].t) {
      best[src].t = t_min[src];
      best[src].idx = leaf * ptre::kLeaf + j_min[src];
    }
  }
}

}  // namespace

// mega_kernel.cu's warp over every warp of 32 rays, lanes in the kernel's
// order: per bounce the warp's walk — a supertile that no live lane passes
// is skipped, else every live lane tests each of its leaves and the rays of
// the lanes that pass are swept by the warp (sweep_leaf_warp) —, then each
// lane's finish. `sel` (max_depth, n_rays)
// int32 or null; `stats` (5) receives the counters of
// megakernel.CULLED_STATS.
extern "C" void ptre_trace_culled_host(const ptre::MegaParams* params,
                                       const float* o, const float* d,
                                       const float* urand, const float* tris,
                                       const float* rows, const float* boxes,
                                       const float* boxes2,
                                       const float* sphs, const float* mats,
                                       const float* sky, float* color,
                                       int32_t* sel, long long* stats) {
  const ptre::MegaParams& p = *params;
  ptre::WaveParams wp = p.w;
  const ptre::SceneTables sc = {tris, sphs, mats, sky, 0, wp.n_sph, wp.num_mats};
  const int64_t n = wp.n_rays;
  for (int i = 0; i < 5; ++i) stats[i] = 0;
  ptre::WaveRay rays[32];
  ptre::TriBest best[32];
  float iv[32][3];
  for (int64_t base = 0; base < n; base += 32) {
    const int m = (int)(n - base < 32 ? n - base : 32);  // a ragged warp's lanes past m are dead
    for (int i = 0; i < m; ++i) {
      for (int k = 0; k < 3; ++k) {
        rays[i].o[k] = o[3 * (base + i) + k];
        rays[i].d[k] = d[3 * (base + i) + k];
        rays[i].c[k] = 1.0f;
      }
      rays[i].act = 1.0f;
    }
    auto live = [&](int i) { return rays[i].act > 0.5f; };
    auto pass = [&](const float* box, int i) {
      return live(i) && ptre::slab_pass_within(box, rays[i].o, iv[i], wp.t_min, best[i].t);
    };
    int bounce = 0;
    for (; bounce < p.max_depth; ++bounce) {
      int n_live = 0;
      for (int i = 0; i < m; ++i) n_live += live(i);
      if (n_live == 0) break;
      wp.bounce = bounce;
      stats[0] += n_live;
      for (int i = 0; i < m; ++i) {
        best[i] = {ptre::kBig, 0, false};
        for (int k = 0; k < 3; ++k) iv[i][k] = ptre::slab_inv(rays[i].d[k]);
      }
      if (p.cull) {
        for (int js = 0; js < p.n_super; ++js) {
          stats[1] += n_live;
          bool any = false;
          for (int i = 0; i < m; ++i) any = any || pass(boxes2 + js * ptre::kBoxStride, i);
          if (!any) continue;
          const int end = std::min((js + 1) * ptre::kSuper, (int)wp.n_leaf);
          for (int leaf = js * ptre::kSuper; leaf < end; ++leaf) {
            bool own[32];
            int n_pass = 0;
            for (int i = 0; i < m; ++i) n_pass += own[i] = pass(boxes + leaf * ptre::kBoxStride, i);
            stats[2] += n_live;
            stats[3] += n_pass;
            stats[4] += n_pass > 0 ? n_live : 0;
            sweep_leaf_warp(rows, leaf, own, m, rays, wp, best);
          }
        }
      } else {
        bool all[32];
        for (int i = 0; i < m; ++i) all[i] = live(i);
        for (int leaf = 0; leaf < wp.n_leaf; ++leaf) {
          sweep_leaf_warp(rows, leaf, all, m, rays, wp, best);
        }
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
