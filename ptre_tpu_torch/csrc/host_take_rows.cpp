// Host build of the row-gather backward (take_rows_kernel.cu), for checks on
// machines without a GPU. The shared instantiation's body runs block by
// block and warp by warp with the kernel's own per-span code
// (take_rows.cuh add_column, block_cell), and its cross-block sum in the
// finishing kernel's order (lane l over blocks l, l + 32, ..., then the
// butterfly), so its d(table) is the kernel's bit for bit. The global
// instantiation's float64 atomics are summed here in row order.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_take_rows.so host_take_rows.cpp
//
// tests/test_torch_take_rows.py builds it this way and holds it against
// torch's float64 index_add_.

#include <stddef.h>

#include <vector>

#include "take_rows.cuh"

namespace r = ptre::rows;

extern "C" int ptre_take_rows_max_cells_host() { return r::kMaxSharedCells; }

extern "C" long long ptre_take_rows_blocks_host(long long m) { return r::shared_blocks(m); }

// d(table) (n, f) of the cotangent g (m, f) of table[idx], as the shared
// instantiation sums it (any n * f: the host has no shared-memory cap).
extern "C" void ptre_take_rows_shared_host(const float* g, const int64_t* idx, long long m, int n,
                                           int f, float* out) {
  const int n_cells = n * f;
  const int64_t n_blocks = r::shared_blocks(m);
  std::vector<double> part((size_t)n_blocks * n_cells);
  std::vector<double> slices((size_t)r::kWarps * n_cells);
  int ids[r::kRowsPerWarp];
  for (int64_t b = 0; b < n_blocks; ++b) {
    slices.assign(slices.size(), 0.0);
    for (int w = 0; w < r::kWarps; ++w) {
      const int64_t first = r::span_first(b, w);
      const int count = r::span_count(first, m);
      for (int i = 0; i < count; ++i) ids[i] = (int)idx[first + i];
      for (int c = 0; c < f; ++c) {
        r::add_column(slices.data() + (size_t)w * n_cells, g + first * f, ids, count, f, c);
      }
    }
    for (int j = 0; j < n_cells; ++j) {
      part[(size_t)b * n_cells + j] = r::block_cell(slices.data(), n_cells, j);
    }
  }
  for (int j = 0; j < n_cells; ++j) {
    double lane[32];
    for (int l = 0; l < 32; ++l) {
      double s = 0.0;
      for (int64_t b = l; b < n_blocks; b += 32) s += part[(size_t)b * n_cells + j];
      lane[l] = s;
    }
    for (int k = 16; k >= 1; k >>= 1) {
      double next[32];
      for (int l = 0; l < 32; ++l) next[l] = lane[l] + lane[l ^ k];
      for (int l = 0; l < 32; ++l) lane[l] = next[l];
    }
    out[j] = (float)lane[0];
  }
}

// d(table) as the global instantiation sums it, its atomics taken in row
// order.
extern "C" void ptre_take_rows_global_host(const float* g, const int64_t* idx, long long m,
                                           int n, int f, float* out) {
  std::vector<double> acc((size_t)n * f, 0.0);
  for (int64_t e = 0; e < m * f; ++e) {
    const int64_t row = e / f;
    acc[(size_t)(idx[row] * f + (e - row * f))] += (double)g[e];
  }
  for (size_t i = 0; i < acc.size(); ++i) out[i] = (float)acc[i];
}
