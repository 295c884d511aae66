// Host build of the rasterizer kernels' per-sample code, for checks on
// machines without a GPU: the SoftRas pair terms and their hand-written
// adjoint in double (raster.cuh), and the bodies of the three kernels
// (raster_kernel.cu, soft_raster_kernel.cu) looped over the same sample
// tiles with the same block-uniform chunk gate, the same row gate (the hard
// kernel's rounding reach, the soft kernels' 14-sigma dilation) and
// per-sample box test, reading rows straight from the table, and summing
// d(table) in order instead of by atomics. The bodies count what the
// kernels' stats instantiations count (raster_kernel.STATS,
// soft_raster.STATS).
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_raster.so host_raster.cpp
//
// tests/test_torch_csrc_host.py and test_torch_raster_gate.py build it this
// way and hold it against torch float64 autograd, the plain PyTorch versions
// and the hard kernel's first design (csrc/baseline/raster_mega/).

#include <vector>

#include "raster.cuh"

namespace {

using ptre::rast::RasterParams;
namespace r = ptre::rast;

// A block's sample tile: window rows r0..r1, columns x0..x1 - 1, and its
// extent for the gates (raster.cuh block_tile).
struct Tile {
  int r0, r1, x0, x1;
  float x_lo, x_hi, y_first, y_last;
};

// Calls visit(k, tile) for every block's tile and every chunk that passes its
// gate, chunks ascending per tile; returns the visited (block, chunk) pairs.
template <typename Visit>
long long for_each_visit(const RasterParams& p, const float* cbox, Visit visit) {
  long long visited = 0;
  const int n_by = (p.rows_ss + r::kTile - 1) / r::kTile;
  const int n_bx = (p.width_ss + r::kTile - 1) / r::kTile;
  for (int by = 0; by < n_by; ++by) {
    Tile t;
    t.r0 = by * r::kTile;
    t.r1 = t.r0 + r::kTile - 1 < p.rows_ss - 1 ? t.r0 + r::kTile - 1 : p.rows_ss - 1;
    t.y_first = r::row_y(p, t.r0);
    t.y_last = r::row_y(p, t.r1);
    for (int bx = 0; bx < n_bx; ++bx) {
      t.x0 = bx * r::kTile;
      t.x1 = t.x0 + r::kTile < p.width_ss ? t.x0 + r::kTile : p.width_ss;
      t.x_lo = (float)t.x0;
      t.x_hi = t.x_lo + (float)r::kTile;
      for (int k = 0; k < p.n_chunks; ++k) {
        if (!r::chunk_hits(cbox + k * r::kBoxStride, t.x_lo, t.x_hi, t.y_first, t.y_last)) {
          continue;
        }
        ++visited;
        visit(k, t);
      }
    }
  }
  return visited;
}

// Calls body(x, rr, px, py) for every sample of tile t.
template <typename Body>
void for_each_sample(const RasterParams& p, const Tile& t, Body body) {
  for (int rr = t.r0; rr <= t.r1; ++rr) {
    for (int x = t.x0; x < t.x1; ++x) body(x, rr, (float)x + 0.5f, r::row_y(p, rr));
  }
}

// The kernels' row gate (raster.cuh gate_rows) of chunk k for tile t: the
// mask of the rows that pass, their gate boxes (box_of(row)) in `boxes`;
// adds to the rows-passed counter.
template <typename BoxOf>
uint64_t gate_rows(const float* tris, int k, const Tile& t, r::GateBox* boxes,
                   long long* stats, BoxOf box_of) {
  uint64_t mask = 0;
  for (int i = 0; i < r::kChunk; ++i) {
    const float* c = tris + ((int64_t)k * r::kChunk + i) * r::kRow;
    boxes[i] = box_of(c);
    if (r::row_hits(c, boxes[i], t.x_lo, t.x_hi, t.y_first, t.y_last)) mask |= 1ull << i;
  }
  stats[1] += __builtin_popcountll(mask);
  return mask;
}

// The soft kernels' gate boxes: the screen box dilated by 14 sigma
// (raster.cuh gate_box).
auto soft_box(const RasterParams& p) {
  const float dil = r::kDilateSigma / p.scal[12];
  return [dil](const float* c) { return r::gate_box(c, dil); };
}

}  // namespace

// (n, 32) rows, samples (px, py) -> (n, 5): cov, logit, r, g, b
extern "C" void ptre_soft_pair_host_d(int n, const double* rows, const double* px,
                                      const double* py, const float* scal, double* out) {
  const r::SoftScal<double> k = r::soft_scal<double>(scal);
  for (int i = 0; i < n; ++i) {
    const r::PairFwd<double> f = r::pair_forward(rows + i * r::kRow, px[i], py[i], k);
    double* o = out + 5 * i;
    o[0] = f.cov;
    o[1] = f.logit;
    for (int c = 0; c < 3; ++c) o[2 + c] = f.col[c];
  }
}

// cotangents (n, 5) of those outputs -> d(rows) (n, 32), overwritten
extern "C" void ptre_soft_pair_adjoint_host_d(int n, const double* rows,
                                              const double* px, const double* py,
                                              const float* scal, const double* gout,
                                              double* grows) {
  const r::SoftScal<double> k = r::soft_scal<double>(scal);
  for (int i = 0; i < n; ++i) {
    const double* c = rows + i * r::kRow;
    const r::PairFwd<double> f = r::pair_forward(c, px[i], py[i], k);
    double* g = grows + i * r::kRow;
    for (int j = 0; j < r::kRow; ++j) g[j] = 0.0;
    const double* go = gout + 5 * i;
    r::pair_adjoint(c, px[i], py[i], k, f, go[0], go[1], go + 2, g);
  }
}

// (n, 32) rows, samples (px, py) -> 1 where the soft kernels evaluate the
// pair (the row kept and its gate box holding the sample), else 0
extern "C" void ptre_soft_gate_host(int n, const float* rows, const float* px,
                                    const float* py, float sigma_inv, int* out) {
  const float dil = r::kDilateSigma / sigma_inv;
  for (int i = 0; i < n; ++i) {
    const float* c = rows + i * r::kRow;
    out[i] = c[12] > 0.5f && r::box_holds(r::gate_box(c, dil), px[i], py[i]);
  }
}

// (n, 32) rows, the window of `params` -> (n, 4) gate boxes of the hard
// kernel's row gate (raster.cuh hard_gate_box): minx, maxx, miny, maxy
extern "C" void ptre_hard_gate_host(int n, const float* rows, const RasterParams* params,
                                    float* out) {
  const float span = r::window_span(*params);
  for (int i = 0; i < n; ++i) {
    const r::GateBox b = r::hard_gate_box(rows + i * r::kRow, span);
    const float v[4] = {b.x0, b.x1, b.y0, b.y1};
    for (int k = 0; k < 4; ++k) out[4 * i + k] = v[k];
  }
}

// The hard kernel's body: planar (3, rows_ss, width_ss) image; `stats` (4)
// receives the counters of raster_kernel.STATS. Returns the visited pairs.
extern "C" long long ptre_raster_hard_host(const RasterParams* params, const float* tris,
                                           const float* cbox, float* out, long long* stats) {
  const RasterParams& p = *params;
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  const float span = r::window_span(p);
  std::vector<float> best_z(plane, r::kFar);
  std::vector<int> best_i(plane, -1);
  for (int i = 0; i < 4; ++i) stats[i] = 0;
  stats[0] = for_each_visit(p, cbox, [&](int kc, const Tile& t) {
    r::GateBox boxes[r::kChunk];
    const uint64_t mask = gate_rows(tris, kc, t, boxes, stats, [&](const float* c) {
      return r::hard_gate_box(c, span);
    });
    if (mask == 0) return;
    for_each_sample(p, t, [&](int x, int rr, float px, float py) {
      const int64_t s = (int64_t)rr * p.width_ss + x;
      uint32_t n_test = 0, n_cover = 0;
      r::hard_sweep_gated(tris + (int64_t)kc * r::kChunk * r::kRow, boxes, mask,
                          kc * r::kChunk, px, py, best_z[s], best_i[s], n_test, n_cover);
      stats[2] += n_test;
      stats[3] += n_cover;
    });
  });
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
  return stats[0];
}

// The soft forward kernel's body: image (3, rows_ss, width_ss) and the
// residual planes (6, rows_ss, width_ss): m, D, W, Nr, Ng, Nb; `stats` (4)
// receives the counters of soft_raster.STATS. Returns the visited pairs.
extern "C" long long ptre_soft_fwd_host(const RasterParams* params, const float* tris,
                                        const float* cbox, float* img, float* res,
                                        long long* stats) {
  const RasterParams& p = *params;
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  const r::SoftScal<float> k = r::soft_scal<float>(p.scal);
  r::SoftState* st = new r::SoftState[plane];
  for (int64_t i = 0; i < plane; ++i) st[i] = r::soft_state_init();
  for (int i = 0; i < 4; ++i) stats[i] = 0;
  stats[0] = for_each_visit(p, cbox, [&](int kc, const Tile& t) {
    r::GateBox boxes[r::kChunk];
    const uint64_t mask = gate_rows(tris, kc, t, boxes, stats, soft_box(p));
    if (mask == 0) return;
    for_each_sample(p, t, [&](int x, int rr, float px, float py) {
      uint32_t n_eval = 0, n_inc = 0;
      r::soft_sweep(tris + (int64_t)kc * r::kChunk * r::kRow, boxes, mask, px, py, k,
                    st[(int64_t)rr * p.width_ss + x], n_eval, n_inc);
      stats[2] += n_eval;
      stats[3] += n_inc;
    });
  });
  for (int64_t s = 0; s < plane; ++s) {
    float rgb[3];
    r::soft_color(st[s], p.scal, rgb);
    for (int c = 0; c < 3; ++c) img[c * plane + s] = rgb[c];
    const float v[6] = {st[s].m, st[s].D, st[s].W, st[s].N[0], st[s].N[1], st[s].N[2]};
    for (int c = 0; c < 6; ++c) res[c * plane + s] = v[c];
  }
  delete[] st;
  return stats[0];
}

// The soft backward kernel's body: d(table) (n_chunks * 64, 32), added into;
// `stats` (4) as the forward's. Returns the visited pairs.
extern "C" long long ptre_soft_bwd_host(const RasterParams* params, const float* tris,
                                        const float* cbox, const float* res,
                                        const float* dimg, float* dtab, long long* stats) {
  const RasterParams& p = *params;
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  const r::SoftScal<float> k = r::soft_scal<float>(p.scal);
  for (int i = 0; i < 4; ++i) stats[i] = 0;
  stats[0] = for_each_visit(p, cbox, [&](int kc, const Tile& t) {
    r::GateBox boxes[r::kChunk];
    const uint64_t mask = gate_rows(tris, kc, t, boxes, stats, soft_box(p));
    if (mask == 0) return;
    for_each_sample(p, t, [&](int x, int rr, float px, float py) {
      const int64_t s = (int64_t)rr * p.width_ss + x;
      float rv[6], gv[3];
      for (int c = 0; c < 6; ++c) rv[c] = res[c * plane + s];
      for (int c = 0; c < 3; ++c) gv[c] = dimg[c * plane + s];
      const r::SoftRowState<float> st = r::soft_row_state(rv, gv, p.scal);
      for (int i = 0; i < r::kChunk; ++i) {
        if (!(mask >> i & 1u) || !r::box_holds(boxes[i], px, py)) continue;
        const int64_t row = (int64_t)kc * r::kChunk + i;
        float g[r::kRow] = {0.0f};
        ++stats[2];
        if (r::pair_backward(tris + row * r::kRow, px, py, k, st, g)) {
          ++stats[3];
          for (int j = 0; j < r::kGradCols; ++j) {
            dtab[row * r::kRow + r::grad_col(j)] += g[r::grad_col(j)];
          }
        }
      }
    });
  });
  return stats[0];
}
