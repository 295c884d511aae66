// The backward of a row gather, out = table[idx] with table (N, F): d(table)
// = the sum, for each row n, of the cotangent rows whose index is n. Shared
// by the CUDA unit (take_rows_kernel.cu) and its host build
// (host_take_rows.cpp), so both add the same terms in the same order.
//
// Every sum runs in float64 and is rounded once to float32. The shared
// instantiation (N * F <= kMaxSharedCells) splits the M gathered rows into
// spans of kRowsPerWarp rows, kWarps spans a block. A warp adds its span's
// rows one after another into its own float64 (N, F) slice of shared memory,
// lane c owning columns c, c + 32, ...: no two threads touch one cell, so no
// atomics. The block then sums its warps' slices in warp order into its
// partial, and a second launch sums the partials of one cell across blocks
// in a fixed order (lane l takes blocks l, l + 32, ..., then a butterfly of
// shuffles): d(table) is the same bits on every run.
#pragma once

#include <stdint.h>

#ifndef PTRE_HD
#ifdef __CUDACC__
#define PTRE_HD __host__ __device__ __forceinline__
#else
#define PTRE_HD inline
#endif
#endif

namespace ptre {
namespace rows {

constexpr int kWarps = 8;                       // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 32;                // one index load a lane
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
// kWarps float64 (N, F) slices and the spans' int32 row indices in the 48 KB
// of shared memory a block takes without opting in: N * F <= 752
constexpr int kMaxSharedCells = (48 * 1024 - kRowsPerBlock * 4) / (kWarps * 8);

PTRE_HD int64_t shared_blocks(int64_t m) { return (m + kRowsPerBlock - 1) / kRowsPerBlock; }

// Rows of the span of warp `w` of block `b`: [first, first + count).
PTRE_HD int64_t span_first(int64_t b, int w) { return (b * kWarps + w) * kRowsPerWarp; }

PTRE_HD int span_count(int64_t first, int64_t m) {
  const int64_t left = m - first;
  return left <= 0 ? 0 : (left < kRowsPerWarp ? (int)left : kRowsPerWarp);
}

// Adds column c of a span's `count` cotangent rows (g at the span's first
// row, rows of f floats) into a warp's slice `acc` (N * f doubles) at the
// rows `ids` name, in row order.
PTRE_HD void add_column(double* acc, const float* g, const int* ids, int count, int f, int c) {
#ifdef __CUDA_ARCH__
#pragma unroll 4
#endif
  for (int r = 0; r < count; ++r) acc[ids[r] * f + c] += (double)g[(int64_t)r * f + c];
}

// A block's partial of cell j: its warps' slices (each n_cells doubles,
// one after another) summed in warp order.
PTRE_HD double block_cell(const double* slices, int n_cells, int j) {
  double s = slices[j];
  for (int w = 1; w < kWarps; ++w) s += slices[w * n_cells + j];
  return s;
}

}  // namespace rows
}  // namespace ptre
