// The staged route's closest-hit sweep, per ray: shared by the CUDA sweep
// kernel (sweep_kernel.cu) and its host build (host_sweep.cpp).
//
// The function is the brute-force sweep of ptre_tpu/ops/pallas/
// intersect_kernel.py _sweep_kernel (:95) and of the plain PyTorch version,
// ptre_tpu_torch/ops/intersect.py sweep_edges, over the packet's triangle
// rows; it is computed over the leaf table of wavefront.prepare_scene
// instead: 64-row leaves of compact rows (wave.cuh kRowStride) in Morton
// order, their boxes and the supertiles' union boxes, dilated
// (wavefront.CULL_PAD_REL). A ray walks the supertiles, then the leaves of
// the supertiles it passes, then the rows of the leaves it passes, every box
// test bounded by its own closest hit so far (wave.cuh slab_pass_within).
// The culling is conservative, so the winner is the brute force's:
//   * a row is compared on (t, packet row) lexicographically, so the lowest
//     packet row wins a tie whatever the Morton order and the visit order;
//   * hit_tri is true if any row accepts (a box culled by the bound lies
//     beyond an accepted hit already);
//   * a class without a hit keeps index 0;
//   * spheres follow, bounded by the triangle winner (t_max when no triangle
//     was hit), with the far-root quirk: the near root alone is checked
//     against that bound, a near root below t_min falls back to the far root
//     with only a t_min check (shape.cu:13-46, :62-103,
//     path_tracer.cu:252-295).
// The plain version writes every product and sum in the same order with one
// rounding each; this unit is built without FMA contraction (-fmad=false,
// ops/cuda/build.py UNIT_FLAGS), so the two select the same primitives.
#pragma once

#include <stdint.h>
#include <string.h>

#include "wave.cuh"

namespace ptre {
namespace sweep {

// Kernel arguments, passed by value. Mirrored field for field by
// SweepParams in ops/cuda/sweep_kernel.py (every field is 4 bytes).
struct SweepParams {
  float t_min, t_max, det_eps;
  int32_t n_rays, n_leaf,
      n_super,  // supertiles: the leaf boxes hold n_super * kSuper rows
      n_sph;
};

struct Best {
  float t;
  int32_t idx;  // the packet's own row
  bool hit;
};

// The packet row of a compact row (its column 10, int32 bits).
PTRE_HD int32_t packet_row(const float* row) {
#ifdef __CUDA_ARCH__
  return __float_as_int(row[10]);
#else
  int32_t j;
  memcpy(&j, row + 10, sizeof(j));
  return j;
#endif
}

// One compact row against the ray; on acceptance `best` takes it if its
// (t, packet row) is below best's.
PTRE_HD void test_row(const float* row, const float o[3], const float d[3],
                      const SweepParams& p, Best& best) {
  float t;
  if (!row_accepts(row, o, d, p.t_min, p.t_max, p.det_eps, &t)) return;
  best.hit = true;
  const int32_t j = packet_row(row);
  if (t < best.t || (t == best.t && j < best.idx)) {
    best.t = t;
    best.idx = j;
  }
}

// One sphere test of row `s` (a pack_sph16 row) against `bound`; updates
// `best` (strict t < best in ascending order: the lowest index on a tie).
PTRE_HD void test_sphere(const float* row, int32_t s, const float o[3],
                         const float d[3], float bound, const SweepParams& p,
                         Best& best) {
  if (!(row[4] > 0.5f)) return;
  const float r = row[3];
  const float ocx = row[0] - o[0], ocy = row[1] - o[1], ocz = row[2] - o[2];
  const float halfb = d[0] * ocx + d[1] * ocy + d[2] * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  const float delta = halfb * halfb - c;
  const float sq = sqrtf(fmaxf(delta, 0.0f));
  const float t_near = halfb - sq;
  const float t = t_near >= p.t_min ? t_near : halfb + sq;
  const bool acc = delta >= 0.0f && t_near <= bound && t >= p.t_min;
  if (!acc) return;
  best.hit = true;
  if (t < best.t) {
    best.t = t;
    best.idx = s;
  }
}

// The triangle winner's t bounds the spheres.
PTRE_HD float sphere_bound(const Best& tri, const SweepParams& p) {
  return tri.hit ? tri.t : p.t_max;
}

// Every sphere row, after the triangles.
PTRE_HD Best sweep_spheres(const float* sphs, const float o[3], const float d[3],
                           const Best& tri, const SweepParams& p) {
  const float bound = sphere_bound(tri, p);
  Best sph = {kBig, 0, false};
  for (int s = 0; s < p.n_sph; ++s) test_sphere(sphs + s * kSphStride, s, o, d, bound, p, sph);
  return sph;
}

// The culled triangle walk of one ray, as the kernel's lanes run it: the
// supertiles in ascending order, the leaves of those it passes, the rows of
// the leaves it passes, each box test bounded by the closest hit so far.
PTRE_HD Best sweep_triangles(const float* rows, const float* boxes, const float* boxes2,
                             const float o[3], const float d[3], const SweepParams& p) {
  const float iv[3] = {slab_inv(d[0]), slab_inv(d[1]), slab_inv(d[2])};
  Best tri = {kBig, 0, false};
  for (int js = 0; js < p.n_super; ++js) {
    if (!slab_pass_within(boxes2 + js * kBoxStride, o, iv, p.t_min, tri.t)) continue;
    for (int leaf = js * kSuper; leaf < (js + 1) * kSuper && leaf < p.n_leaf; ++leaf) {
      if (!slab_pass_within(boxes + leaf * kBoxStride, o, iv, p.t_min, tri.t)) continue;
      const float* lr = rows + (int64_t)leaf * kLeaf * kRowStride;
      for (int j = 0; j < kLeaf; ++j) test_row(lr + j * kRowStride, o, d, p, tri);
    }
  }
  return tri;
}

// The four selections of ray `i`: i_tri, hit_tri, i_sph, hit_sph, each a
// row of the (4, n_rays) int32 output.
PTRE_HD void store(int32_t* out, int64_t i, int64_t n_rays, const Best& tri,
                   const Best& sph) {
  out[i] = tri.idx;
  out[n_rays + i] = tri.hit ? 1 : 0;
  out[2 * n_rays + i] = sph.idx;
  out[3 * n_rays + i] = sph.hit ? 1 : 0;
}

}  // namespace sweep
}  // namespace ptre
