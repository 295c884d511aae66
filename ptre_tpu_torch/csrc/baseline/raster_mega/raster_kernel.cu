// A yardstick, not part of the kernel library (ops/cuda/build.py builds
// the units of csrc/ only): the hard raster kernel's first design — every
// visited chunk's 64 rows staged into shared memory and swept by every
// thread of the tile — kept as it was shipped, with the header it was
// shipped with (a frozen copy in this directory), so that chip_smoke.py can
// build it, hold the shipped kernel's image to it sample for sample and time
// the two in turns on the same inputs.
//
// Hard z-buffer tile rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel ptre_tpu/ops/pallas/raster_kernel.py
// _raster_kernel (:255, launched at :435). One CUDA block per 16 x 16 tile
// of window samples, one thread per sample. The block walks every chunk of
// the Morton-sorted table in ascending order and tests the chunk's box
// against its tile (raster.cuh chunk_hits, block-uniform: every thread reads
// the same five floats); for a chunk that passes, all threads stage its 64
// rows x 32 floats (8 KB) into shared memory with 16-byte loads, then each
// thread sweeps the 64 rows with strict z < best — the lowest sorted index
// among z ties, which is the TPU kernel's lexicographic (z, index) merge
// (:327-343). After the sweep each thread reads its winner's row by index
// from global memory (L2), re-interpolates the normal exactly, shades it
// (HLSL ambient + diffuse) or writes the clear colour, to the planar
// (3, rows_ss, width_ss) image. The (y0, stride) window, ragged tiles and
// any table size are handled here; the box resolve stays in PyTorch.
//
// What bounds it on this card. The function is bound by bytes: the 44 MB
// image written once at 2560 x 1440 outweighs the coverage tests its inputs
// need (a sample inside the row's own box: ~6.2 M pairs on the
// 1,932-triangle demo scene). This kernel is bound instead by float32 ALU
// work in its sweep: a visited (block, chunk) pair costs 256 x 64 coverage
// tests of ~30 operations, and on that scene ~2 % of the swept pairs have
// the sample inside the row's box. The design keeps the per-chunk work
// block-uniform (no per-thread culling branch) and the shared memory at
// 8 KB a block, so occupancy is set by registers; the Morton-compact chunk
// boxes keep the visited pairs few. Skipping the rows whose box misses the
// tile is the step toward the bound.
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

__global__ void __launch_bounds__(kTile* kTile)
    raster_hard_kernel(const RasterParams p, const float* __restrict__ tris,
                       const float* __restrict__ cbox, float* __restrict__ out) {
  __shared__ __align__(16) float s_rows[kChunk * kRow];
  const BlockTile t = block_tile(p);
  const int tid = threadIdx.y * kTile + threadIdx.x;

  float best_z = kFar;
  int best_i = -1;
  for (int k = 0; k < p.n_chunks; ++k) {
    if (!chunk_hits(cbox + k * kBoxStride, t.x_lo, t.x_hi, t.y_first, t.y_last)) continue;
    __syncthreads();  // every thread is done with the previous chunk
    stage_chunk(s_rows, tris, k, tid);
    __syncthreads();
    if (t.in) hard_sweep(s_rows, k * kChunk, t.px, t.py, best_z, best_i);
  }
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
extern "C" int ptre_raster_hard(const ptre::rast::RasterParams* params,
                                const float* tris, const float* cbox, float* out,
                                void* stream) {
  using namespace ptre::rast;
  const RasterParams p = *params;
  if (const int rc = check_launch(p, tris)) return rc;
  raster_hard_kernel<<<tile_grid(p), dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(
      p, tris, cbox, out);
  return (int)cudaGetLastError();
}
