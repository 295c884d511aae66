// Host build of the first designs of the hard raster kernel and the culled
// megakernel (raster_kernel.cu, mega_kernel.cu in this directory), against
// the frozen headers here: the hard kernel's body over every block's sample
// tile (the block-uniform chunk gate, every row of a visited chunk), and the
// culled megakernel's block over every block of `lanes` rays (per bounce the
// two-level walk with the block's votes, every live ray sweeping each leaf
// that some ray of the block passes).
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_first.so host_first.cpp
//
// tests/test_torch_raster_gate.py and test_torch_culled_walk.py hold the
// redesigned kernels' host builds (csrc/host_raster.cpp, host_wave.cpp) to
// them bit for bit: g++ contracts no a*b+c without -mfma, so the two run the
// same float operations unless the redesign reordered some.

#include <vector>

#include "raster.cuh"
#include "wave.cuh"

namespace r = ptre::rast;

// The hard kernel's body: planar (3, rows_ss, width_ss) image; returns the
// visited (block, chunk) pairs.
extern "C" long long ptre_raster_hard_host(const r::RasterParams* params, const float* tris,
                                           const float* cbox, float* out) {
  const r::RasterParams& p = *params;
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  std::vector<float> best_z(plane, r::kFar);
  std::vector<int> best_i(plane, -1);
  long long visited = 0;
  const int n_by = (p.rows_ss + r::kTile - 1) / r::kTile;
  const int n_bx = (p.width_ss + r::kTile - 1) / r::kTile;
  for (int by = 0; by < n_by; ++by) {
    const int r0 = by * r::kTile;
    const int r1 = r0 + r::kTile - 1 < p.rows_ss - 1 ? r0 + r::kTile - 1 : p.rows_ss - 1;
    const float y_first = r::row_y(p, r0), y_last = r::row_y(p, r1);
    for (int bx = 0; bx < n_bx; ++bx) {
      const int x0 = bx * r::kTile;
      const int x1 = x0 + r::kTile < p.width_ss ? x0 + r::kTile : p.width_ss;
      const float x_lo = (float)x0, x_hi = x_lo + (float)r::kTile;
      for (int k = 0; k < p.n_chunks; ++k) {
        if (!r::chunk_hits(cbox + k * r::kBoxStride, x_lo, x_hi, y_first, y_last)) continue;
        ++visited;
        for (int rr = r0; rr <= r1; ++rr) {
          for (int x = x0; x < x1; ++x) {
            const int64_t s = (int64_t)rr * p.width_ss + x;
            r::hard_sweep(tris + (int64_t)k * r::kChunk * r::kRow, k * r::kChunk,
                          (float)x + 0.5f, r::row_y(p, rr), best_z[s], best_i[s]);
          }
        }
      }
    }
  }
  for (int rr = 0; rr < p.rows_ss; ++rr) {
    for (int x = 0; x < p.width_ss; ++x) {
      const int64_t s = (int64_t)rr * p.width_ss + x;
      float rgb[3] = {p.scal[9], p.scal[10], p.scal[11]};
      if (best_i[s] >= 0) {
        r::shade_winner(tris + (int64_t)best_i[s] * r::kRow, (float)x + 0.5f, r::row_y(p, rr),
                        p.scal, rgb);
      }
      for (int c = 0; c < 3; ++c) out[c * plane + s] = rgb[c];
    }
  }
  return visited;
}

// The culled megakernel's block over every block of `lanes` rays. `sel`
// (max_depth, n_rays) int32 or null.
extern "C" void ptre_trace_culled_host(const ptre::MegaParams* params, const float* o,
                                       const float* d, const float* urand, const float* tris,
                                       const float* rows, const float* boxes,
                                       const float* boxes2, const float* sphs,
                                       const float* mats, const float* sky, float* color,
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
