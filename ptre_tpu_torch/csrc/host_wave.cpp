// Host build of the wavefront kernels' and the culled megakernel's per-ray
// bodies, for checks on machines without a GPU: the same slab_pass,
// super_union, slab_pass_within, row_accepts and finish_bounce_at (wave.cuh,
// trace.cuh, philox.cuh) that mask_kernel.cu, wave_kernel.cu and
// mega_kernel.cu run per thread, looped over the ray blocks or warps on the
// CPU, a warp's votes taken by a loop over its rays, the warp's sweep of a
// leaf (wave.cuh sweep_leaf_warp) and the block's shortlist (wave.cuh
// bits_to_list) by their twins below.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_wave.so host_wave.cpp
//
// tests/test_torch_csrc_host.py and test_torch_culled_walk.py build it this
// way and hold it against the plain PyTorch versions and the culled
// megakernel's first design (csrc/baseline/raster_mega/).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

#include "wave.cuh"

namespace {

// mask_kernel.cu's walk over every block of `lanes` rays: the supertile
// union boxes — taken from `supers` (the global instantiation's table,
// megakernel.pack_super_boxes) where it is given, else formed by
// super_union as the staged instantiation forms them —, then per warp of 32
// rays the two-level walk — a supertile whose leaves are all listed is
// skipped, else its box is voted on by the live lanes, and, where one
// passes, each leaf not yet listed — into the block's listed leaves, which
// `emit(b, listed)` receives. The kernel's warps run at once and list
// leaves in another order; the verdict is an OR, so the result is the same.
template <class Emit>
void mask_walk_host(const ptre::MaskParams& p, const float* state, const float* boxes,
                    const float* supers, int lanes, Emit emit) {
  const int n_super = (p.n_leaf + ptre::kSuper - 1) / ptre::kSuper;
  std::vector<float> sup((size_t)n_super * ptre::kBoxStride);
  for (int s = 0; s < n_super; ++s) {
    float* dst = &sup[(size_t)s * ptre::kBoxStride];
    if (supers != nullptr) {
      std::copy(supers + (size_t)s * ptre::kBoxStride, supers + (size_t)(s + 1) * ptre::kBoxStride,
                dst);
    } else {
      ptre::super_union(boxes, p.n_leaf, s, dst);
    }
  }
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
        if (all || !vote(&sup[(size_t)s * ptre::kBoxStride])) continue;
        for (int l = l0; l < l1; ++l)
          if (!listed[l] && vote(boxes + l * ptre::kBoxStride)) listed[l] = 1;
      }
    }
    emit(b, listed.data());
  }
}

// wave.cuh bits_to_list, a block of kMaxLanes threads emulated in turn: the
// words taken kMaxLanes at a time, each warp's inclusive scan of their
// popcounts, warp 0's exclusive scan of the warps' totals, carried from
// chunk to chunk; then each warp's non-zero words in ascending order, lane l
// storing leaf 32 w + l, if set, at the word's offset plus list_slot.
// list[0, cnt) is written, and *count = cnt.
void bits_to_list_host(const std::vector<unsigned>& words, int32_t* list, int32_t* count) {
  constexpr int kWarps = ptre::kMaxLanes / 32;
  const int n_words = (int)words.size();
  int base = 0;
  for (int c = 0; c < n_words; c += ptre::kMaxLanes) {
    int incl[ptre::kMaxLanes], warp_off[kWarps];
    for (int t = 0; t < ptre::kMaxLanes; ++t) {
      const int pc = c + t < n_words ? ptre::popc32(words[c + t]) : 0;
      incl[t] = (t % 32 == 0 ? 0 : incl[t - 1]) + pc;
    }
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      warp_off[w] = total;
      total += incl[32 * w + 31];
    }
    for (int t = 0; t < ptre::kMaxLanes && c + t < n_words; ++t) {
      const unsigned word = words[c + t];
      const int at = base + warp_off[t / 32] + incl[t] - ptre::popc32(word);
      for (int lane = 0; lane < 32; ++lane)
        if ((word >> lane) & 1u) list[at + ptre::list_slot(word, lane)] = 32 * (c + t) + lane;
    }
    base += total;
  }
  *count = base;
}

// The bit mask of one block's listed leaves (one byte, 0 or 1, a leaf).
std::vector<unsigned> to_words(const uint8_t* listed, int n_leaf) {
  std::vector<unsigned> words((n_leaf + 31) / 32, 0u);
  for (int l = 0; l < n_leaf; ++l)
    if (listed[l] != 0) words[l >> 5] |= 1u << (l & 31);
  return words;
}

}  // namespace

// mask_kernel.cu's launch writing the dense mask (ptre_wave_mask): one byte
// a leaf, `mask` (r_pad / lanes, n_leaf).
extern "C" void ptre_wave_mask_host(const ptre::MaskParams* params,
                                    const float* state, const float* boxes,
                                    const float* supers, uint8_t* mask, int lanes) {
  const ptre::MaskParams& p = *params;
  mask_walk_host(p, state, boxes, supers, lanes, [&](int64_t b, const uint8_t* listed) {
    std::copy(listed, listed + p.n_leaf, mask + b * p.n_leaf);
  });
}

// mask_kernel.cu's launch writing the shortlists (ptre_wave_mask_lists):
// row b of `list` ((r_pad / lanes, n_leaf) int32) written in [0, count[b]).
extern "C" void ptre_wave_mask_lists_host(const ptre::MaskParams* params,
                                          const float* state, const float* boxes,
                                          const float* supers, int32_t* list, int32_t* count,
                                          int lanes) {
  const ptre::MaskParams& p = *params;
  mask_walk_host(p, state, boxes, supers, lanes, [&](int64_t b, const uint8_t* listed) {
    bits_to_list_host(to_words(listed, p.n_leaf), list + b * p.n_leaf, count + b);
  });
}

// mask_kernel.cu's shortlist_rows_kernel (ptre_shortlists): the shortlists
// of the nb rows of a dense (nb, n_leaf) bool mask.
extern "C" void ptre_shortlists_host(const uint8_t* mask, int nb, int n_leaf, int32_t* list,
                                     int32_t* count) {
  for (int64_t b = 0; b < nb; ++b)
    bits_to_list_host(to_words(mask + b * n_leaf, n_leaf), list + b * n_leaf, count + b);
}

namespace {

// wave.cuh order_key: a float's order as an unsigned, -0.0 taken as +0.0.
unsigned order_key(float t) {
  t += 0.0f;
  unsigned u;
  std::memcpy(&u, &t, sizeof(u));
  return (u & 0x80000000u) != 0 ? ~u : (u | 0x80000000u);
}

// wave.cuh sweep_leaf_warp, which the bounce kernel and the culled
// megakernel run: for each lane of `passed` in ascending order, its ray
// against the leaf's 64 rows, row j on lane j % 32; the least order key of
// the lanes' accepted t (the REDUX), then the lowest row that has it, among
// the first rows and then the second (the two ballots), merged into the
// ray's best with strict t < best.
void sweep_leaf_warp(const float* rows, int leaf, const bool* passed, int m,
                     const ptre::WaveRay* rays, const ptre::WaveParams& wp,
                     ptre::TriBest* best) {
  const float* leaf_rows = rows + (int64_t)leaf * ptre::kLeaf * ptre::kRowStride;
  const float inf = std::numeric_limits<float>::infinity();
  for (int src = 0; src < m; ++src) {
    if (!passed[src]) continue;
    float t_row[2][32];
    bool acc[2][32];
    bool any = false;
    unsigned k_min = ~0u;
    for (int lane = 0; lane < 32; ++lane) {
      for (int h = 0; h < 2; ++h) {
        acc[h][lane] = ptre::row_accepts(leaf_rows + (lane + 32 * h) * ptre::kRowStride,
                                         rays[src].o, rays[src].d, wp.t_min, wp.t_max,
                                         wp.det_eps, &t_row[h][lane]);
        any = any || acc[h][lane];
      }
      const float t_lane = std::fmin(acc[0][lane] ? t_row[0][lane] : inf,
                                     acc[1][lane] ? t_row[1][lane] : inf);
      k_min = std::min(k_min, order_key(t_lane));
    }
    if (!any) continue;
    int j_min = -1;
    for (int j = 0; j < ptre::kLeaf && j_min < 0; ++j) {
      if (acc[j / 32][j % 32] && order_key(t_row[j / 32][j % 32]) == k_min) j_min = j;
    }
    const float t_min = t_row[j_min / 32][j_min % 32];
    best[src].hit = true;
    if (t_min < best[src].t) {
      best[src].t = t_min;
      best[src].idx = leaf * ptre::kLeaf + j_min;
    }
  }
}

}  // namespace

// wave_kernel.cu's block over every block of `lanes` rays, warp by warp of
// 32 columns, lanes in the kernel's order: a warp with a live lane walks the
// block's shortlist; for each listed leaf every live lane tests the leaf's
// box against its own ray, bounded by its closest hit so far, and the rays
// of the lanes that pass are swept by the warp (sweep_leaf_warp); then each
// live lane's finish. `sel` (max_depth, n_sel) int32 or null; `stats` null
// or 5 counters that the call adds wavefront.BOUNCE_STATS to.
extern "C" void ptre_wave_bounce_host(const ptre::WaveParams* params,
                                      const float* state, const int32_t* ids,
                                      const int32_t* shortlist,
                                      const int32_t* counts, const float* tris,
                                      const float* rows, const float* boxes,
                                      const float* sphs, const float* mats,
                                      const float* sky, const float* urand,
                                      float* out, int32_t* sel, long long* stats,
                                      int lanes) {
  const ptre::WaveParams& p = *params;
  const ptre::SceneTables sc = {tris, sphs, mats, sky, 0, p.n_sph, p.num_mats};
  ptre::WaveRay rays[32];
  ptre::TriBest best[32];
  float iv[32][3];
  for (int64_t w0 = 0; w0 < p.r_pad; w0 += 32) {
    const int64_t b = w0 / lanes;
    int n_live = 0;
    for (int i = 0; i < 32; ++i) {
      rays[i] = ptre::load_ray(state, w0 + i, p.r_pad);
      best[i] = {ptre::kBig, 0, false};
      for (int k = 0; k < 3; ++k) iv[i][k] = ptre::slab_inv(rays[i].d[k]);
      n_live += rays[i].act > 0.5f;
    }
    if (n_live > 0) {
      const int n = counts[b];
      long long n_own = 0, n_visits = 0;
      for (int k = 0; k < n; ++k) {
        const int leaf = shortlist[b * p.list_stride + k];
        bool own[32];
        int n_pass = 0;
        for (int i = 0; i < 32; ++i) {
          own[i] = rays[i].act > 0.5f &&
                   ptre::slab_pass_within(boxes + leaf * ptre::kBoxStride, rays[i].o, iv[i],
                                          p.t_min, best[i].t);
          n_pass += own[i];
        }
        n_own += n_pass;
        n_visits += n_pass > 0;
        sweep_leaf_warp(rows, leaf, own, 32, rays, p, best);
      }
      if (stats != nullptr) {
        stats[0] += n_live;
        stats[1] += (long long)n_live * n;
        stats[2] += n_own;
        stats[3] += n_visits;
        stats[4] += n_live * n_visits;
      }
    }
    for (int i = 0; i < 32; ++i) {
      const int64_t col = w0 + i;
      if (rays[i].act > 0.5f) {
        if (sel != nullptr) {
          const ptre::WinnerWriter rec = {ptre::sel_slot(sel, p, p.bounce, ids[col])};
          ptre::finish_bounce_at(p, sc, best[i], ids[col], urand, rec, rays[i]);
        } else {
          ptre::finish_bounce_at(p, sc, best[i], ids[col], urand, ptre::NoWinner(), rays[i]);
        }
      }
      ptre::store_ray(out, col, p.r_pad, rays[i]);
    }
  }
}

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
