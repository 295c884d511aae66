// The closest-hit sweep of the staged route, per ray: shared by the CUDA
// sweep kernel (sweep_kernel.cu) and its host build (host_sweep.cpp).
//
// One ray against every triangle row, then every sphere row, keeping a
// running (best t, best index, any hit): the one-ray form of
// ptre_tpu/ops/pallas/intersect_kernel.py _sweep_kernel (:95) and of the
// plain PyTorch version, ptre_tpu_torch/ops/intersect.py sweep. The plain
// version writes every product and sum in the same order with one rounding
// each; this unit is built without FMA contraction (-fmad=false, see
// ops/cuda/build.py UNIT_FLAGS), so the two select the same primitives.
//
// Semantics (shape.cu:13-46, :62-103, path_tracer.cu:252-295):
// Moller-Trumbore with |det| < det_eps rejected; strict t < best in
// ascending row order, so the lowest index wins a tie and a class without
// a hit keeps index 0; spheres bounded by the closest triangle (t_max when
// no triangle was hit), and the sphere far-root quirk: the near root alone
// is checked against that bound, a near root below t_min falls back to the
// far root with only a t_min check.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef PTRE_HD
#ifdef __CUDACC__
#define PTRE_HD __host__ __device__ __forceinline__
#else
#define PTRE_HD inline
#endif
#endif

namespace ptre {
namespace sweep {

// Triangle row: v0 (0-2), e1 = v1 - v0 (3-5), e2 = v2 - v0 (6-8), valid (9),
// zero padding (10-11): 48 bytes, three 16-byte loads.
constexpr int kTriStride = 12;
// Sphere row: center (0-2), radius (3), valid (4), zero padding (5-7).
constexpr int kSphStride = 8;
constexpr float kBig = 3.00000001e+38f;

// Kernel arguments, passed by value. Mirrored field for field by
// SweepParams in ops/cuda/sweep_kernel.py (every field is 4 bytes).
struct SweepParams {
  float t_min, t_max, det_eps;
  int32_t n_rays, n_tri, n_sph;
};

struct Best {
  float t;
  int32_t idx;
  bool hit;
};

// One Moller-Trumbore test of row `j`; updates `best`.
PTRE_HD void test_triangle(const float* row, int32_t j, const float o[3],
                           const float d[3], const SweepParams& p, Best& best) {
  if (!(row[9] > 0.5f)) return;  // an invalid row accepts nothing
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float e2x = row[6], e2y = row[7], e2z = row[8];
  const float pvx = d[1] * e2z - d[2] * e2y;
  const float pvy = d[2] * e2x - d[0] * e2z;
  const float pvz = d[0] * e2y - d[1] * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = 1.0f / (fabsf(det) < p.det_eps ? 1.0f : det);
  const float tvx = o[0] - row[0], tvy = o[1] - row[1], tvz = o[2] - row[2];
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  const bool acc = fabsf(det) >= p.det_eps && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                   u + v <= 1.0f && t >= p.t_min && t <= p.t_max;
  if (!acc) return;
  best.hit = true;
  if (t < best.t) {
    best.t = t;
    best.idx = j;
  }
}

// One sphere test of row `s` against `bound`; updates `best`.
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
