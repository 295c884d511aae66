// Host build of the rasterizer kernels' per-sample code, for checks on
// machines without a GPU: the SoftRas pair terms and their hand-written
// adjoint in double (raster.cuh), and the bodies of the three kernels
// (raster_kernel.cu, soft_raster_kernel.cu) looped over the same sample
// tiles with the same block-uniform chunk gate, reading each chunk straight
// from the table instead of staging it, and summing d(table) in order
// instead of by atomics.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_raster.so host_raster.cpp
//
// tests/test_torch_csrc_host.py builds it this way and holds it against
// torch float64 autograd and the plain PyTorch versions.

#include "raster.cuh"

namespace {

using ptre::rast::RasterParams;
namespace r = ptre::rast;

// Calls body(k, x, rr, px, py) for every sample of every block and every
// chunk that passes the block's gate, chunks ascending per sample; returns
// the visited (block, chunk) pairs.
template <typename Body>
long long for_each_visit(const RasterParams& p, const float* cbox, Body body) {
  long long visited = 0;
  const int n_by = (p.rows_ss + r::kTile - 1) / r::kTile;
  const int n_bx = (p.width_ss + r::kTile - 1) / r::kTile;
  for (int by = 0; by < n_by; ++by) {
    const int r0 = by * r::kTile;
    const int r1 = r0 + r::kTile - 1 < p.rows_ss - 1 ? r0 + r::kTile - 1 : p.rows_ss - 1;
    const float y_first = r::row_y(p, r0), y_last = r::row_y(p, r1);
    for (int bx = 0; bx < n_bx; ++bx) {
      const float x_lo = (float)(bx * r::kTile), x_hi = x_lo + (float)r::kTile;
      for (int k = 0; k < p.n_chunks; ++k) {
        if (!r::chunk_hits(cbox + k * r::kBoxStride, x_lo, x_hi, y_first, y_last)) continue;
        ++visited;
        for (int rr = r0; rr <= r1; ++rr) {
          for (int x = bx * r::kTile; x < (bx + 1) * r::kTile && x < p.width_ss; ++x) {
            body(k, x, rr, (float)x + 0.5f, r::row_y(p, rr));
          }
        }
      }
    }
  }
  return visited;
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

// The hard kernel's body: planar (3, rows_ss, width_ss) image
extern "C" long long ptre_raster_hard_host(const RasterParams* params, const float* tris,
                                           const float* cbox, float* out) {
  const RasterParams& p = *params;
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  float* best_z = new float[plane];
  int* best_i = new int[plane];
  for (int64_t i = 0; i < plane; ++i) {
    best_z[i] = r::kFar;
    best_i[i] = -1;
  }
  const long long visited = for_each_visit(p, cbox, [&](int k, int x, int rr, float px, float py) {
    const int64_t s = (int64_t)rr * p.width_ss + x;
    r::hard_sweep(tris + (int64_t)k * r::kChunk * r::kRow, k * r::kChunk, px, py, best_z[s],
                  best_i[s]);
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
  delete[] best_z;
  delete[] best_i;
  return visited;
}

// The soft forward kernel's body: image (3, rows_ss, width_ss) and the
// residual planes (6, rows_ss, width_ss): m, D, W, Nr, Ng, Nb
extern "C" long long ptre_soft_fwd_host(const RasterParams* params, const float* tris,
                                        const float* cbox, float* img, float* res) {
  const RasterParams& p = *params;
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  const r::SoftScal<float> k = r::soft_scal<float>(p.scal);
  r::SoftState* st = new r::SoftState[plane];
  for (int64_t i = 0; i < plane; ++i) st[i] = r::soft_state_init();
  const long long visited = for_each_visit(p, cbox, [&](int kc, int x, int rr, float px, float py) {
    r::soft_sweep(tris + (int64_t)kc * r::kChunk * r::kRow, px, py, k,
                  st[(int64_t)rr * p.width_ss + x]);
  });
  for (int64_t s = 0; s < plane; ++s) {
    float rgb[3];
    r::soft_color(st[s], p.scal, rgb);
    for (int c = 0; c < 3; ++c) img[c * plane + s] = rgb[c];
    const float v[6] = {st[s].m, st[s].D, st[s].W, st[s].N[0], st[s].N[1], st[s].N[2]};
    for (int c = 0; c < 6; ++c) res[c * plane + s] = v[c];
  }
  delete[] st;
  return visited;
}

// The soft backward kernel's body: d(table) (n_chunks * 64, 32), added into
extern "C" long long ptre_soft_bwd_host(const RasterParams* params, const float* tris,
                                        const float* cbox, const float* res,
                                        const float* dimg, float* dtab) {
  const RasterParams& p = *params;
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  const r::SoftScal<float> k = r::soft_scal<float>(p.scal);
  return for_each_visit(p, cbox, [&](int kc, int x, int rr, float px, float py) {
    const int64_t s = (int64_t)rr * p.width_ss + x;
    float rv[6], gv[3];
    for (int c = 0; c < 6; ++c) rv[c] = res[c * plane + s];
    for (int c = 0; c < 3; ++c) gv[c] = dimg[c * plane + s];
    const r::SoftRowState<float> st = r::soft_row_state(rv, gv, p.scal);
    for (int i = 0; i < r::kChunk; ++i) {
      const int64_t row = (int64_t)kc * r::kChunk + i;
      const float* c = tris + row * r::kRow;
      if (!(c[12] > 0.5f)) continue;
      float g[r::kRow] = {0.0f};
      if (r::pair_backward(c, px, py, k, st, g)) {
        for (int j = 0; j < r::kGradCols; ++j) {
          dtab[row * r::kRow + r::grad_col(j)] += g[r::grad_col(j)];
        }
      }
    }
  });
}
