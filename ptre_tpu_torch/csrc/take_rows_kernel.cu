// Backward of the differentiable row gathers (ops/cuda/take_rows.py) for
// Hopper (sm_90a): d(table) (N, F) from the cotangent (M, F) of
// table[idx], each cell summed in float64 and rounded once to float32.
//
// Replaces PyTorch's backward of tensor[idx], index_put_(accumulate=True):
// a sort of the indices, then one thread per (distinct index, column) that
// adds the index's duplicates one after another. The tables the fused and
// raster kernels read are built by such gathers: 16,256 rows from 2
// drawcall transforms or materials, 16,244 of them copies of one row, so a
// thread made ~16,000 dependent adds, ~3 ms a gather on an H100. The work
// is to read the cotangent once (1 MB at config 4's shapes, 0.3 us).
//
// Two instantiations, chosen from N * F alone (take_rows.py
// `instantiation`, against ptre_take_rows_max_cells):
//   * shared (N * F <= kMaxSharedCells, take_rows.cuh): each warp sums a
//     span of 32 rows into its own float64 slice of shared memory, lane c
//     owning column c; the block sums its slices in warp order into its
//     partial; a second launch sums each cell's partials across blocks in a
//     fixed order. No atomics: d(table) is the same bits on every run.
//   * global: float64 atomics into a zeroed (N, F) buffer, one thread an
//     element, then a cast. Where the index names each row at most once (a
//     permutation) every cell takes one add into zero, so the result is
//     exact and the same on every run; with duplicates the float64 sums
//     land in no fixed order.

#include <cuda_runtime.h>

#include "take_rows.cuh"

namespace ptre {
namespace rows {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGlobalThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rows_partial_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx, int64_t m,
                        int n_cells, int f, double* __restrict__ part) {
  extern __shared__ double s_dyn[];
  double* slices = s_dyn;                                      // [kWarps][n_cells]
  int* s_ids = reinterpret_cast<int*>(s_dyn + kWarps * n_cells);  // [kWarps][kRowsPerWarp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < kWarps * n_cells; j += kThreads) slices[j] = 0.0;
  const int64_t first = span_first(blockIdx.x, warp);
  const int count = span_count(first, m);
  int* ids = s_ids + warp * kRowsPerWarp;
  if (lane < count) ids[lane] = (int)idx[first + lane];
  __syncthreads();
  for (int c = lane; c < f; c += 32) {
    add_column(slices + warp * n_cells, g + first * f, ids, count, f, c);
  }
  __syncthreads();
  double* out = part + (int64_t)blockIdx.x * n_cells;
  for (int j = threadIdx.x; j < n_cells; j += kThreads) out[j] = block_cell(slices, n_cells, j);
}

// One warp a cell: lane l sums the partials of blocks l, l + 32, ... in
// order, then a butterfly of shuffles, the same tree on every run.
__global__ void __launch_bounds__(kThreads)
    rows_finish_kernel(const double* __restrict__ part, int n_blocks, int n_cells,
                       float* __restrict__ out) {
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (cell >= n_cells) return;  // the whole warp
  double s = 0.0;
  for (int b = lane; b < n_blocks; b += 32) s += part[(int64_t)b * n_cells + cell];
  for (int k = 16; k >= 1; k >>= 1) s += __shfl_xor_sync(kFull, s, k);
  if (lane == 0) out[cell] = (float)s;
}

__global__ void __launch_bounds__(kGlobalThreads)
    rows_atomic_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx,
                       int64_t elems, int f, double* __restrict__ acc) {
  const int64_t e = (int64_t)blockIdx.x * kGlobalThreads + threadIdx.x;
  if (e >= elems) return;
  const int64_t r = e / f;
  atomicAdd(acc + idx[r] * f + (e - r * f), (double)g[e]);
}

__global__ void __launch_bounds__(kGlobalThreads)
    rows_cast_kernel(const double* __restrict__ acc, int64_t cells, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kGlobalThreads + threadIdx.x;
  if (i < cells) out[i] = (float)acc[i];
}

}  // namespace rows
}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launches.
// g (m, f) float32 and idx (m,) int64 in [0, n) are contiguous; out (n, f).

// Table cells (n * f) the shared instantiation takes (kMaxSharedCells); a
// larger table takes the global one (take_rows.py `instantiation`).
extern "C" int ptre_take_rows_max_cells() { return ptre::rows::kMaxSharedCells; }

// Blocks of the shared instantiation for m gathered rows: the rows of
// `part` that ptre_take_rows_shared writes.
extern "C" long long ptre_take_rows_blocks(long long m) {
  return (long long)ptre::rows::shared_blocks(m);
}

// part: (ptre_take_rows_blocks(m), n * f) float64 scratch. Two launches.
extern "C" int ptre_take_rows_shared(const float* g, const int64_t* idx, long long m, int n,
                                     int f, double* part, float* out, void* stream) {
  using namespace ptre::rows;
  const int n_cells = n * f;
  if (m < 1 || n < 1 || f < 1 || n_cells > kMaxSharedCells) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_blocks = shared_blocks(m);
  const size_t smem = (size_t)kWarps * n_cells * sizeof(double) + kRowsPerBlock * sizeof(int);
  rows_partial_kernel<<<(unsigned)n_blocks, kThreads, smem, st>>>(g, idx, m, n_cells, f, part);
  rows_finish_kernel<<<(n_cells + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      part, (int)n_blocks, n_cells, out);
  return (int)cudaGetLastError();
}

// acc: (n, f) float64 scratch, zeroed here. Three launches (the zeroing,
// the atomics, the cast).
extern "C" int ptre_take_rows_global(const float* g, const int64_t* idx, long long m, int n,
                                     int f, double* acc, float* out, void* stream) {
  using namespace ptre::rows;
  if (m < 1 || n < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t cells = (int64_t)n * f, elems = (int64_t)m * f;
  cudaMemsetAsync(acc, 0, cells * sizeof(double), st);
  rows_atomic_kernel<<<(unsigned)((elems + kGlobalThreads - 1) / kGlobalThreads),
                       kGlobalThreads, 0, st>>>(g, idx, elems, f, acc);
  rows_cast_kernel<<<(unsigned)((cells + kGlobalThreads - 1) / kGlobalThreads), kGlobalThreads,
                     0, st>>>(acc, cells, out);
  return (int)cudaGetLastError();
}
