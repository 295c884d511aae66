// Hard z-buffer tile rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/raster_kernel.py
// _raster_kernel (:255, launched at :435). One CUDA block per 16 x 16 tile
// of window samples, one thread per sample. The block tests the chunk boxes
// of the Morton-sorted table against its tile 32 at a time by ballot
// (raster.cuh chunk_hits, for_each_chunk: block-uniform) and visits the
// chunks that pass in ascending order. A visit starts with the row gate
// (raster.cuh gate_rows): threads 0-63 each build one row's gate box — its
// screen box (cols 23-26) grown by the rounding reach of covers()
// (hard_gate_box; infinite for a sliver, which is then tested by every
// sample, as before) — test it and the row's keep flag against the tile's
// extent, store the box in shared memory, and two ballots make the chunk's
// 64-bit row mask. Each thread then evaluates covers() on a mask row only
// where the row's gate box holds its own sample, in ascending row order with
// strict z < best: the lowest sorted index among z ties, the TPU kernel's
// lexicographic (z, index) merge (:327-343). A skipped pair cannot cover
// (raster.cuh, the hard row gate), so every winner is the ungated sweep's.
// Rows are read through L1/L2, not staged. After the sweep each thread reads
// its winner's row by index, re-interpolates the normal exactly, shades it
// (HLSL ambient + diffuse) or writes the clear colour, to the planar (3,
// rows_ss, width_ss) image. The (y0, stride) window, ragged tiles and any
// table size are handled here; the box resolve stays in PyTorch.
//
// What bounds it on this card: bytes. The function writes the 44.5 MB image
// once at 2560 x 1440 and needs ~6.2 M coverage tests (a sample inside the
// row's own box, on the 1,932-triangle demo scene): 0.0133 ms. The first
// design swept every row of every visited chunk, 256 x 64 coverage tests a
// (block, chunk) pair, 286.7 M tests of which 2.2 % had the sample inside
// the row's box, bound by float32 ALU work: 0.544-0.555 ms. The row gate
// leaves 6.22 M tests: 0.080-0.082 ms (NVIDIA H100 80GB HBM3, 700 W). What
// remains is latency: each block's serial chain of chunk boxes, the two
// barriers around the row gate and the row reads (~0.05 ms; the image
// write alone takes 0.016, the shading 0.011). Staging the chunk's rows in
// shared memory, as the first design did, measured slower (0.096 ms;
// chip_ablations.py times these variants). With
// `stats` given, a separate instantiation also counts the visited (block,
// chunk) pairs, the rows that pass the row gate, the pairs evaluated and
// those that cover; a launch without `stats` counts nothing.
//
// Rounding: coverage, z and the shading use round-to-nearest operations in
// the plain version's order (raster.cuh), so the winners and colours equal
// raster_kernel.raster_reference's bit for bit on the card.
//
// Not carried over from the TPU kernel: the per-tile shortlists built
// outside the kernel (_tile_shortlists), the VMEM-resident whole table, the
// (8, 128) tile constraints, the f32 winner index and the one-hot MXU
// gather of the winner's attributes (a direct row read).

#include <cuda_runtime.h>

#include "raster.cuh"

namespace ptre {
namespace rast {

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
    raster_hard_kernel(const RasterParams p, const float* __restrict__ tris,
                       const float* __restrict__ cbox, float* __restrict__ out,
                       unsigned long long* __restrict__ stats) {
  __shared__ GateBox s_box[kChunk];
  __shared__ unsigned s_mask[2];
  const BlockTile t = block_tile(p);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const float span = window_span(p);
  unsigned long long visits = 0, rows_passed = 0;
  uint32_t n_test = 0, n_cover = 0;

  float best_z = kFar;
  int best_i = -1;
  for_each_chunk(p, cbox, t, tid, [&](int kc) {
    const float* rows = tris + (int64_t)kc * kChunk * kRow;
    const uint64_t mask = gate_rows(rows, t, tid, s_box, s_mask,
                                    [&](const float* c) { return hard_gate_box(c, span); });
    if (kStats) {
      ++visits;
      rows_passed += __popcll(mask);
    }
    if (mask != 0 && t.in) {
      hard_sweep_gated(rows, s_box, mask, kc * kChunk, t.px, t.py, best_z, best_i, n_test,
                       n_cover);
    }
  });
  if (kStats) add_stats(stats, tid, visits, rows_passed, n_test, n_cover);
  if (!t.in) return;

  float rgb[3] = {p.scal[9], p.scal[10], p.scal[11]};
  if (best_i >= 0) shade_winner(tris + (int64_t)best_i * kRow, t.px, t.py, p.scal, rgb);
  const int64_t plane = (int64_t)p.rows_ss * p.width_ss;
  const int64_t s = (int64_t)t.r * p.width_ss + t.x;
  for (int c = 0; c < 3; ++c) out[c * plane + s] = rgb[c];
}

}  // namespace rast
}  // namespace ptre

// C interface for ctypes. Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
// stats: null (nothing counted) or 4 uint64 counters that the launch adds to
// (raster_kernel.py STATS).
extern "C" int ptre_raster_hard(const ptre::rast::RasterParams* params,
                                const float* tris, const float* cbox, float* out,
                                unsigned long long* stats, void* stream) {
  using namespace ptre::rast;
  const RasterParams p = *params;
  if (const int rc = check_launch(p, tris)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stats != nullptr) {
    raster_hard_kernel<true><<<tile_grid(p), dim3(kTile, kTile), 0, st>>>(p, tris, cbox, out,
                                                                         stats);
  } else {
    raster_hard_kernel<false><<<tile_grid(p), dim3(kTile, kTile), 0, st>>>(p, tris, cbox, out,
                                                                          stats);
  }
  return (int)cudaGetLastError();
}
