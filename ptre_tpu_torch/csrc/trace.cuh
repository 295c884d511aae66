// Path tracing of the dense class, shared by the CUDA render and recording
// kernels and their host builds:
//   * scatter_shade (material select by index, ONB cosine scatter,
//     Oren-Nayar / emissive weight) and sky_color, also read by wave.cuh and
//     replay.cuh;
//   * derive_row: a triangle row as the dense kernels stage it once a block
//     (v0 and the edges e1 = v1 - v0, e2 = v2 - v0, the vertex normals, the
//     material, the row's original index), valid rows only, ascending;
//   * path_bounce: one bounce of one path over those rows (the sweep with an
//     optional selection recorder, then the shading and the next ray);
//   * RenderJob / RecordJob: what a lane does when it takes a pixel or a ray
//     (camera ray, or the given ray), at each bounce, and when the path ends
//     (clamp + scrub + running average, or colour and the -1 selections);
//   * dense_kernel (the card) and host_dense (its twin on the host, each
//     warp's 32 lanes simulated): a warp owns a tile of items, each lane one
//     path, and a lane whose path ended takes the tile's next unstarted
//     item.
//
// These are the one-ray forms of ptre_tpu/ops/pallas/megakernel.py
// _trace_block (:811) and _scatter_shade (:611), and of the per-tile body of
// render_kernel._render_kernel (render_kernel.py:79). Their plain PyTorch
// twins are trace_block / scatter_shade in ops/cuda/megakernel.py and
// sample_accum_reference in ops/cuda/render_kernel.py; all three keep the
// same operation order so they agree to float rounding.
//
// Rounding: inside the bounce loop nvcc may contract a*b+c into an FMA, so a
// ray that grazes an edge can pick another primitive than the plain version.
// Ray generation, the sky gradient and the running average are written with
// round-to-nearest intrinsics that are never contracted: primary rays, sky
// pixels and the accumulate step are bit-equal to the plain version.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef __CUDACC__
#include <vector>
#endif

#include "philox.cuh"

namespace ptre {

constexpr int kMaxTri = 64;  // dense class: triangle rows staged per block
constexpr int kMaxSph = 64;
// Material tables: pack_mats rows (kind, albedo, param, 0, 0, 0), at least
// kStagedMats of them. The dense and culled kernels read a hit's row in
// place, through L1/L2; the wave kernel stages a table of at most
// kStagedMats rows in shared memory and reads a larger one in place. Ids
// are float32, which holds every index below kMaxMaterials exactly.
constexpr int kStagedMats = 8;
constexpr int kMaxMaterials = 1 << 24;
constexpr int kTriStride = 32;  // pack_tri32 row
constexpr int kSphStride = 16;  // pack_sph16 row
constexpr int kMatStride = 8;   // pack_mats row
constexpr int kMaxDepth = 8;    // bounces the gradient kernels keep state for

constexpr float kBig = 3.00000001e+38f;
constexpr float kTau = 6.28318548f;     // float32(2 * 3.14159265358979)
constexpr float kInvPi = 0.318309873f;  // float32(1 / 3.14159265358979)

// Kernel arguments, passed by value. Mirrored field for field by
// RenderParams in ops/cuda/render_kernel.py (every field is 4 bytes). The
// camera is not among them: the kernel reads its rows where they live
// (RenderJob::cam), so the host never reads a camera made on the card.
struct RenderParams {
  float t_min, t_max, det_eps, shadow_eps, pdf_eps;
  float inv_w, inv_h;  // 1/W, 1/H
  float inv_n, w_old;  // running average: 1/n and (n-1)/n
  uint32_t seed_lo, seed_hi, sample;
  int32_t height, width, n_tri, n_sph, num_mats, max_depth, clamp,
      external_rng;
};

// Arguments of the recording and fused backward kernels, passed by value.
// Mirrored field for field by TraceParams in ops/cuda/megakernel.py.
struct TraceParams {
  float t_min, t_max, det_eps, shadow_eps, pdf_eps;
  uint32_t seed_lo, seed_hi, sample;
  int32_t n_rays, n_tri, n_sph, num_mats, max_depth,
      sph_offset,  // unified-table row of sphere 0 (the padded triangle rows)
      n_rows,      // unified-table rows (fused backward only)
      external_rng;
};

struct SceneTables {
  const float* tris;  // (n_tri, 32)
  const float* sphs;  // (n_sph, 16)
  const float* mats;  // (max(num_mats, kStagedMats), kMatStride)
  const float* sky;   // bottom rgb, top rgb
  int n_tri, n_sph, num_mats;
};

PTRE_HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

PTRE_HD float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

PTRE_HD float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// a*x + b*y + c, rounded after every operation
PTRE_HD float lin2_rn(float a, float x, float b, float y, float c) {
  return add_rn(add_rn(mul_rn(a, x), mul_rn(b, y)), c);
}

// Rows 2k and 2k+1 of an external (2 + 2*max_depth, H, W) uniform tensor.
struct ExternalUniforms {
  const float* urand;
  int64_t pixel, plane;  // pixel offset, H*W

  PTRE_HD void pair(int k, float* u1, float* u2) const {
    *u1 = urand[(2 * k) * plane + pixel];
    *u2 = urand[(2 * k + 1) * plane + pixel];
  }
};

// Sky gradient on the incoming ray's y (megakernel.py:706-713).
PTRE_HD void sky_color(float dy, const float* sky, float* r, float* g,
                       float* b) {
  const float a = mul_rn(add_rn(dy, 1.0f), 0.5f);
  const float om = sub_rn(1.0f, a);
  *r = add_rn(mul_rn(om, sky[0]), mul_rn(a, sky[3]));
  *g = add_rn(mul_rn(om, sky[1]), mul_rn(a, sky[4]));
  *b = add_rn(mul_rn(om, sky[2]), mul_rn(a, sky[5]));
}

// The material row of a float id, or -1 for the zero row. The reference
// scans every row m < num_mats for |id - m| < 0.5, last match wins
// (megakernel.py:625-631). At most one integer lies that close to id, the
// nearest one, rintf(id), and id - m is exact there (Sterbenz), so one
// comparison gives the scan's row for every float id: k + 0.5 (a tie, 0.5
// away from both neighbours), NaN, ids below -0.5 and ids past num_mats -
// 0.5 take no row. num_mats <= kMaxMaterials is exact as a float.
PTRE_HD int material_row(float mat_id, int num_mats) {
  const float m = rintf(mat_id);
  return fabsf(mat_id - m) < 0.5f && m >= 0.0f && m < (float)num_mats ? (int)m : -1;
}

// Shading of a hit (megakernel.py:611-714): returns the bounce factor f and
// the scattered direction wi; *emissive ends the path.
PTRE_HD void scatter_shade(float nx, float ny, float nz, float dx, float dy,
                           float dz, float mat_id, float u1, float u2,
                           const SceneTables& sc, float pdf_eps, float f[3],
                           float wi[3], bool* emissive) {
  float m_kind = 0.0f, m_ar = 0.0f, m_ag = 0.0f, m_ab = 0.0f, m_param = 0.0f;
  const int m = material_row(mat_id, sc.num_mats);
  if (m >= 0) {
    const float* row = sc.mats + m * kMatStride;
    m_kind = row[0];
    m_ar = row[1];
    m_ag = row[2];
    m_ab = row[3];
    m_param = row[4];
  }
  const bool is_emissive = m_kind > 0.5f;

  // cosine-weighted sample in the ONB; branch on |n.x| > 0.9 (:634-656)
  const float phi = kTau * u1;
  const float sr = sqrtf(u2);
  const float lx = cosf(phi) * sr;
  const float ly = sinf(phi) * sr;
  const float lz = sqrtf(fmaxf(1.0f - u2, 0.0f));
  const bool big_x = fabsf(nx) > 0.9f;
  const float ax = big_x ? 0.0f : 1.0f;
  const float ay = big_x ? 1.0f : 0.0f;
  float vx = ny * 0.0f - nz * ay;
  float vy = nz * ax - nx * 0.0f;
  float vz = nx * ay - ny * ax;
  const float vlen = sqrtf(vx * vx + vy * vy + vz * vz);
  const float vinv = 1.0f / (vlen > 0.0f ? vlen : 1.0f);
  vx *= vinv;
  vy *= vinv;
  vz *= vinv;
  const float ux = vy * nz - vz * ny;
  const float uy = vz * nx - vx * nz;
  const float uz = vx * ny - vy * nx;
  float wix = lx * ux + ly * vx + lz * nx;
  float wiy = lx * uy + ly * vy + lz * ny;
  float wiz = lx * uz + ly * vz + lz * nz;

  // degenerate-pdf fallback: cast along the normal (:658-666)
  float ndotwi = nx * wix + ny * wiy + nz * wiz;
  float pdf = ndotwi * kInvPi;
  if (pdf < pdf_eps) {
    wix = nx;
    wiy = ny;
    wiz = nz;
    pdf = kInvPi;
    ndotwi = 1.0f;
  }
  const float cosw = fmaxf(0.0f, ndotwi);

  // Oren-Nayar A/B, transcendental-free world-frame form (:668-692)
  const float sigma = fminf(fmaxf(m_param, 0.0f), 1.0f);
  const float s2 = sigma * sigma;
  const float A = 1.0f - 0.5f * s2 / (s2 + 0.33f);
  const float B = 0.45f * s2 / (s2 + 0.09f);
  const float wox = -dx, woy = -dy, woz = -dz;
  const float li = sqrtf(wix * wix + wiy * wiy);
  const float lo = sqrtf(wox * wox + woy * woy);
  const float li_s = li > 0.0f ? li : 1.0f;
  const float lo_s = lo > 0.0f ? lo : 1.0f;
  const float ci = li > 1e-12f ? wix / li_s : 1.0f;
  const float si = li > 1e-12f ? wiy / li_s : 0.0f;
  const float co = lo > 1e-12f ? wox / lo_s : 1.0f;
  const float so = lo > 1e-12f ? woy / lo_s : 0.0f;
  const float cos_dphi = ci * co + si * so;
  const float cos_to = fminf(fmaxf(wox * nx + woy * ny + woz * nz, 0.0f), 1.0f);
  const float cos_ti = fminf(fmaxf(ndotwi, 0.0f), 1.0f);
  const float cos_a = fminf(cos_ti, cos_to);
  const float cos_b = fmaxf(cos_ti, cos_to);
  const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
  const float tan_b =
      sqrtf(fmaxf(1.0f - cos_b * cos_b, 0.0f)) / fmaxf(cos_b, 1e-6f);
  const float coeff = (A + B * cos_dphi * sin_a * tan_b) * kInvPi;

  // emission: a terminal multiplicative factor with w_pdf = 1 (:697-703)
  const float w_pdf = is_emissive ? 1.0f : cosw / pdf;
  f[0] = w_pdf * (is_emissive ? m_param * m_ar : m_ar * coeff);
  f[1] = w_pdf * (is_emissive ? m_param * m_ag : m_ag * coeff);
  f[2] = w_pdf * (is_emissive ? m_param * m_ab : m_ab * coeff);
  wi[0] = wix;
  wi[1] = wiy;
  wi[2] = wiz;
  *emissive = is_emissive;
}

// Recorder policies of path_bounce. NoRecord compiles to nothing, so the
// render kernel's code and registers are those of a loop without recording.
struct NoRecord {
  PTRE_HD void hit(int, int, int) {}
};

// Writes the winner of every bounce that hits as a unified-table row
// (megakernel.py:933-937): triangle j -> j, sphere s -> sph_offset + s.
// Bounces after the path ended are left to the caller (-1).
struct SelRecorder {
  int32_t* sel;  // (max_depth, n_rays)
  int64_t ray, n_rays;
  int sph_offset;
  int n_hits;

  PTRE_HD void hit(int bounce, int tri_idx, int sph_idx) {
    sel[bounce * n_rays + ray] = sph_idx >= 0 ? sph_offset + sph_idx : tri_idx;
    n_hits = bounce + 1;
  }
};

// A 16-byte vector: one shared-memory load on the card.
#ifdef __CUDACC__
using Vec4 = float4;
#else
struct Vec4 {
  float x, y, z, w;
};
#endif

PTRE_HD Vec4 load4(const float* p) {  // p 16-byte aligned
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const float4*>(p);
#else
  const Vec4 v = {p[0], p[1], p[2], p[3]};
  return v;
#endif
}

// Direction reciprocal clamped away from 0 at +-1e-12 (wavefront.py:138-141).
PTRE_HD float slab_inv(float c) {
  return 1.0f / (fabsf(c) < 1e-12f ? (c >= 0.0f ? 1e-12f : -1e-12f) : c);
}

// Entry and exit parameters of one ray through one box (lo.xyz hi.xyz). No
// a*b+c appears, so FMA contraction cannot change a verdict.
PTRE_HD void slab_interval(const float* box, const float o[3],
                           const float iv[3], float* t_near, float* t_far) {
  float tn = -kBig, tf = kBig;
  for (int k = 0; k < 3; ++k) {
    const float lo = box[k], hi = box[3 + k];
    const float tnk = ((iv[k] >= 0.0f ? lo : hi) - o[k]) * iv[k];
    const float tfk = ((iv[k] >= 0.0f ? hi : lo) - o[k]) * iv[k];
    tn = k == 0 ? tnk : fmaxf(tn, tnk);
    tf = k == 0 ? tfk : fminf(tf, tfk);
  }
  *t_near = tn;
  *t_far = tf;
}

// Slab test of one ray against one box (wavefront.py:144-152).
PTRE_HD bool slab_pass(const float* box, const float o[3], const float iv[3],
                       float t_min) {
  float tn, tf;
  slab_interval(box, o, iv, &tn, &tf);
  return tn <= tf && tf >= t_min;
}

// A derived triangle row, five 16-byte vectors: v0 (0-2), e1 = v1 - v0
// (3-5), e2 = v2 - v0 (6-8), n0 n1 n2 (9-17, at their pack_tri32 columns),
// the material (18) and the row's original index (19). The edges are the
// single float subtractions every ray used to make at every bounce, so the
// sweep's arithmetic is unchanged.
constexpr int kRowFloats = 20;

PTRE_HD void derive_row(const float* tr, int idx, float* out) {
  const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
  out[0] = v0x;
  out[1] = v0y;
  out[2] = v0z;
  out[3] = tr[3] - v0x;
  out[4] = tr[4] - v0y;
  out[5] = tr[5] - v0z;
  out[6] = tr[6] - v0x;
  out[7] = tr[7] - v0y;
  out[8] = tr[8] - v0z;
  for (int i = 9; i < 18; ++i) out[i] = tr[i];
  out[18] = tr[19];
  out[19] = (float)idx;
}

PTRE_HD bool row_valid(const float* tr) { return tr[18] > 0.5f; }

// Group boxes: the derived rows in groups of kGroupRows, each group's box
// (lo.xyz hi.xyz 0 0) taken over its triangles' vertices and grown by
// kCullPadRel x the largest |coordinate| of the valid triangles on every
// side, as the wavefront grows its leaf boxes (wavefront.CULL_PAD_REL). A ray
// that fails a group's slab test skips the group's rows: the box holds every
// point the Moller-Trumbore test can accept, with a margin far wider than
// its float rounding, so no hit is dropped (held against the first design,
// which tests every row, bit for bit).
constexpr int kGroupRows = 8;
constexpr int kMaxGroups = kMaxTri / kGroupRows;
constexpr int kBoxFloats = 8;
constexpr float kCullPadRel = 1e-5f;

PTRE_HD float row_extent(const float* tr) {  // the largest |coordinate|
  float m = 0.0f;
  for (int i = 0; i < 9; ++i) m = fmaxf(m, fabsf(tr[i]));
  return m;
}

// Group g's box over the original rows (`tris`) of its derived rows.
PTRE_HD void group_box(const float* tris, const float* rows, int n_valid, int g,
                       float pad, float* box) {
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
  const int j1 = (g + 1) * kGroupRows < n_valid ? (g + 1) * kGroupRows : n_valid;
  for (int j = g * kGroupRows; j < j1; ++j) {
    const float* tr = tris + (int)rows[j * kRowFloats + 19] * kTriStride;
    for (int v = 0; v < 3; ++v) {
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], tr[3 * v + k]);
        hi[k] = fmaxf(hi[k], tr[3 * v + k]);
      }
    }
  }
  for (int k = 0; k < 3; ++k) {
    box[k] = sub_rn(lo[k], pad);
    box[3 + k] = add_rn(hi[k], pad);
  }
  box[6] = box[7] = 0.0f;
}

// The valid rows of the (n_tri, 32) table, derived in ascending order into
// `rows`, and their group boxes into `boxes`; returns their count. Ascending
// order with the strict t < best keeps the lowest original index on a tie,
// as the full table did.
PTRE_HD int derive_rows(const float* tris, int n_tri, float* rows, float* boxes) {
  int n = 0;
  float scale = 0.0f;
  for (int j = 0; j < n_tri; ++j) {
    if (!row_valid(tris + j * kTriStride)) continue;
    derive_row(tris + j * kTriStride, j, rows + kRowFloats * n++);
    scale = fmaxf(scale, row_extent(tris + j * kTriStride));
  }
  for (int g = 0; g * kGroupRows < n; ++g)
    group_box(tris, rows, n, g, mul_rn(kCullPadRel, scale), boxes + kBoxFloats * g);
  return n;
}

// The dense scene as the redesigned kernels stage it.
struct DenseScene {
  const float* rows;   // (n_valid, kRowFloats), 16-byte aligned
  const float* boxes;  // (ceil(n_valid / kGroupRows), kBoxFloats)
  const float* sphs;   // (n_sph, kSphStride), 16-byte aligned
  int n_valid, n_sph;
  SceneTables shade;   // the materials and the sky
};

// One path between bounces: its next ray, its throughput and its bounce.
struct PathState {
  float ox, oy, oz, dx, dy, dz;
  float cr, cg, cb;
  int bounce;
};

// How a bounce ended: the path missed (the sky), hit and ended (an emitter
// or max_depth), or hit and goes on.
enum BounceEnd : int { kMissed = 0, kEnded = 1, kGoesOn = 2 };

// One bounce of a live path (megakernel.py:811-990): closest hit over the
// valid triangle rows (strict t < best: the lowest index on a tie), spheres
// bounded by the closest triangle (the far-root quirk: the acceptance bounds
// t_near, not t), then the sky on a miss, or the winner's normal (flipped
// against the ray, then normalised), scatter_shade and the next ray.
// ``rec.hit(bounce, tri, sph)`` sees each hit's winner (sph >= 0 when a
// sphere won). A candidate is left as soon as its result is decided: |det|
// below det_eps or u outside [0, 1] before qv, v and t; delta < 0 before
// the root; a group of rows whose box the ray misses. The winner's
// attributes are read once, after the sweep. `tested`, when given, counts
// the rows of the groups the ray passes.
template <class Params, class Uniforms, class Recorder>
PTRE_HD int path_bounce(PathState& s, const DenseScene& sc, const Params& p,
                        Uniforms& un, Recorder& rec, unsigned* tested) {
  const float ox = s.ox, oy = s.oy, oz = s.oz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;

  float tri_t = kBig, tri_u = 0.0f, tri_v = 0.0f;
  bool tri_hit = false;
  int tri_row = -1;
  const float o3[3] = {ox, oy, oz};
  const float iv[3] = {slab_inv(dx), slab_inv(dy), slab_inv(dz)};
  for (int j0 = 0; j0 < sc.n_valid; j0 += kGroupRows) {
    if (!slab_pass(sc.boxes + j0 / kGroupRows * kBoxFloats, o3, iv, p.t_min)) continue;
    const int j1 = j0 + kGroupRows < sc.n_valid ? j0 + kGroupRows : sc.n_valid;
    if (tested != nullptr) *tested += j1 - j0;
    for (int j = j0; j < j1; ++j) {
      const float* r = sc.rows + j * kRowFloats;
      const Vec4 a = load4(r), b = load4(r + 4), c = load4(r + 8);
      const float v0x = a.x, v0y = a.y, v0z = a.z;
      const float e1x = a.w, e1y = b.x, e1z = b.y;
      const float e2x = b.z, e2y = b.w, e2z = c.x;
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      if (!(fabsf(det) >= p.det_eps)) continue;
      const float inv_det = 1.0f / det;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      if (!(u >= 0.0f && u <= 1.0f)) continue;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      if (!(v >= 0.0f && u + v <= 1.0f && t >= p.t_min && t <= p.t_max)) continue;
      tri_hit = true;  // ORs acc, not upd (:892)
      if (t < tri_t) {
        tri_t = t;
        tri_u = u;
        tri_v = v;
        tri_row = j;
      }
    }
  }
  const float tri_best = tri_hit ? tri_t : p.t_max;

  float sph_t = kBig;
  bool sph_hit = false;
  int sph_idx = -1;
  for (int k = 0; k < sc.n_sph; ++k) {
    const float* sp = sc.sphs + k * kSphStride;
    const Vec4 a = load4(sp), b = load4(sp + 4);
    if (!(b.x > 0.5f)) continue;
    const float ocx = a.x - ox, ocy = a.y - oy, ocz = a.z - oz;
    const float halfb = dx * ocx + dy * ocy + dz * ocz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - a.w * a.w;
    const float delta = halfb * halfb - c;
    if (!(delta >= 0.0f)) continue;
    const float sq = sqrtf(fmaxf(delta, 0.0f));
    const float t_near = halfb - sq;
    const float t = t_near >= p.t_min ? t_near : halfb + sq;
    if (!(t_near <= tri_best && t >= p.t_min)) continue;
    sph_hit = true;
    if (t < sph_t) {
      sph_t = t;
      sph_idx = k;
    }
  }

  if (!(tri_hit || sph_hit)) {  // miss: sky factor, the path ends
    float sr, sg, sb;
    sky_color(dy, sc.shade.sky, &sr, &sg, &sb);
    s.cr *= sr;
    s.cg *= sg;
    s.cb *= sb;
    return kMissed;
  }

  // the winner (a sphere candidate already beat the triangles); a hit that
  // never improved on kBig keeps the zero attributes it always had
  const bool use_sph = sph_hit;
  const float t_hit = use_sph ? sph_t : tri_t;
  const float px = ox + t_hit * dx;
  const float py = oy + t_hit * dy;
  const float pz = oz + t_hit * dz;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, mat_id = 0.0f;
  int tri_idx = 0;
  if (use_sph) {
    float s_cx = 0.0f, s_cy = 0.0f, s_cz = 0.0f, s_ir = 0.0f;
    if (sph_idx >= 0) {
      const float* sp = sc.sphs + sph_idx * kSphStride;
      s_cx = sp[0];
      s_cy = sp[1];
      s_cz = sp[2];
      s_ir = 1.0f / (sp[3] == 0.0f ? 1.0f : sp[3]);
      mat_id = sp[5];
    }
    const float snx = (px - s_cx) * s_ir;
    const float sny = (py - s_cy) * s_ir;
    const float snz = (pz - s_cz) * s_ir;
    const float s_sign = dx * snx + dy * sny + dz * snz < 0.0f ? 1.0f : -1.0f;
    nx = snx * s_sign;
    ny = sny * s_sign;
    nz = snz * s_sign;
  } else if (tri_row >= 0) {
    // interpolated normal, sign from the geometric normal, applied before
    // normalising (:875-889)
    const float* r = sc.rows + tri_row * kRowFloats;
    const float e1x = r[3], e1y = r[4], e1z = r[5];
    const float e2x = r[6], e2y = r[7], e2z = r[8];
    const float u = tri_u, v = tri_v;
    const float w = 1.0f - u - v;
    const float gnx = e1y * e2z - e1z * e2y;
    const float gny = e1z * e2x - e1x * e2z;
    const float gnz = e1x * e2y - e1y * e2x;
    const float sign = dx * gnx + dy * gny + dz * gnz < 0.0f ? 1.0f : -1.0f;
    nx = (w * r[9] + u * r[12] + v * r[15]) * sign;
    ny = (w * r[10] + u * r[13] + v * r[16]) * sign;
    nz = (w * r[11] + u * r[14] + v * r[17]) * sign;
    mat_id = r[18];
    tri_idx = (int)r[19];
  }
  rec.hit(s.bounce, tri_idx, use_sph ? (sph_idx >= 0 ? sph_idx : 0) : -1);
  const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
  const float ninv = nlen > 0.0f ? 1.0f / nlen : 0.0f;  // guarded (:951-953)
  nx *= ninv;
  ny *= ninv;
  nz *= ninv;

  float u1, u2;
  un.pair(1 + s.bounce, &u1, &u2);
  float f[3], wi[3];
  bool emissive;
  scatter_shade(nx, ny, nz, dx, dy, dz, mat_id, u1, u2, sc.shade, p.pdf_eps, f,
                wi, &emissive);
  s.cr *= f[0];
  s.cg *= f[1];
  s.cb *= f[2];
  if (emissive) return kEnded;

  // next ray: shadow-epsilon offset along the final normal (:967-977)
  s.ox = px + p.shadow_eps * nx;
  s.oy = py + p.shadow_eps * ny;
  s.oz = pz + p.shadow_eps * nz;
  s.dx = wi[0];
  s.dy = wi[1];
  s.dz = wi[2];
  return ++s.bounce < p.max_depth ? kGoesOn : kEnded;
}

// Uniform sources: a lane's uniforms for pixel or ray `id`.
struct PhiloxSource {
  uint32_t key0, key1, sample;
  PTRE_HD PhiloxUniforms at(int64_t id) const {
    return PhiloxUniforms(key0, key1, (uint32_t)id, sample);
  }
};

struct ExternalSource {  // an external (2 + 2*max_depth, n) uniform tensor
  const float* urand;
  int64_t plane;
  PTRE_HD ExternalUniforms at(int64_t id) const {
    const ExternalUniforms un = {urand, id, plane};
    return un;
  }
};

// Items and lanes of the warp scheduler. A warp owns a tile: kRenderTileW x
// kRenderTileH pixels of the image, or kRecordTile consecutive rays. A lane
// whose path ended takes the tile's next unstarted item once at least
// kRefillMin lanes of the warp are idle.
constexpr int kLanes = 32;
constexpr int kDenseWarps = 8;  // warps (tiles) a block of the dense kernels
constexpr int kRenderTileW = 16;
constexpr int kRenderTileH = 4;
constexpr int kRecordTile = 64;
constexpr int kRefillMin = 1;
// The counting instantiation's counters: paths started, live ray-bounces
// (sweeps), hits, warp-bounces issued, and the triangle rows tested (those
// of the groups whose box the ray passes). It also writes each path's
// bounces into `lens` (one int32 a pixel or ray) when that is given.
constexpr int kStats = 5;

// One progressive sample of one pixel (render_kernel.py:79-179): jitter,
// closed-form camera ray, the bounces, clamp + non-finite scrub, then lin =
// c/n + lin*(n-1)/n on the (H, W, 3) accumulator in place. `cam` points at
// the 18 camera rows (render_kernel.camera_rows: A B C DA DB DC, x y z
// each) in the kernel's own memory space: global memory on the card, every
// lane of a warp reading the same address.
template <class Source>
struct RenderJob {
  using Uniforms = decltype(Source().at(0));
  struct Lane {
    PathState s;
    Uniforms un;
    int64_t pix;
  };

  RenderParams p;
  Source src;
  float* accum;
  const float* cam;
  DenseScene sc;   // the staged scene
  int x0, y0, tw;  // the tile's corner and width (ragged at the edge)

  PTRE_HD int n_tiles() const {
    return ((p.width + kRenderTileW - 1) / kRenderTileW) *
           ((p.height + kRenderTileH - 1) / kRenderTileH);
  }

  // Takes tile t (x-major); returns its pixels.
  PTRE_HD int tile(int t) {
    const int tiles_x = (p.width + kRenderTileW - 1) / kRenderTileW;
    x0 = (t % tiles_x) * kRenderTileW;
    y0 = (t / tiles_x) * kRenderTileH;
    tw = p.width - x0 < kRenderTileW ? p.width - x0 : kRenderTileW;
    const int th = p.height - y0 < kRenderTileH ? p.height - y0 : kRenderTileH;
    return tw * th;
  }

  PTRE_HD void start(int item, Lane& l) const {
    const int x = x0 + item % tw, y = y0 + item / tw;
    l.pix = (int64_t)y * p.width + x;
    l.un = src.at(l.pix);
    float ju, jv;
    l.un.pair(0, &ju, &jv);
    const float jx = sub_rn(ju, 0.5f);
    const float jy = sub_rn(jv, 0.5f);
    const float x_ndc =
        sub_rn(mul_rn(add_rn((float)x, jx), mul_rn(2.0f, p.inv_w)), 1.0f);
    const float y_ndc =
        sub_rn(1.0f, mul_rn(add_rn((float)y, jy), mul_rn(2.0f, p.inv_h)));
    const float* c = cam;
    l.s.ox = lin2_rn(x_ndc, c[0], y_ndc, c[3], c[6]);
    l.s.oy = lin2_rn(x_ndc, c[1], y_ndc, c[4], c[7]);
    l.s.oz = lin2_rn(x_ndc, c[2], y_ndc, c[5], c[8]);
    const float dx = lin2_rn(x_ndc, c[9], y_ndc, c[12], c[15]);
    const float dy = lin2_rn(x_ndc, c[10], y_ndc, c[13], c[16]);
    const float dz = lin2_rn(x_ndc, c[11], y_ndc, c[14], c[17]);
    const float dlen =
        sqrtf(add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz)));
    const float dinv = dlen > 0.0f ? 1.0f / dlen : 0.0f;  // (:142-144)
    l.s.dx = mul_rn(dx, dinv);
    l.s.dy = mul_rn(dy, dinv);
    l.s.dz = mul_rn(dz, dinv);
    l.s.cr = l.s.cg = l.s.cb = 1.0f;
    l.s.bounce = 0;
  }

  PTRE_HD int step(Lane& l, unsigned* tested) const {
    NoRecord rec;
    return path_bounce(l.s, sc, p, l.un, rec, tested);
  }

  PTRE_HD void finish(const Lane& l) const {
    float* out = accum + 3 * l.pix;
    const float col[3] = {l.s.cr, l.s.cg, l.s.cb};
    for (int ch = 0; ch < 3; ++ch) {
      float v = col[ch];
      if (p.clamp) v = fminf(fmaxf(v, 0.0f), 1.0f);
      if (!isfinite(v)) v = 0.0f;  // NaN and +-inf (integrator.py:188)
      out[ch] = add_rn(mul_rn(v, p.inv_n), mul_rn(out[ch], p.w_old));
    }
  }

  PTRE_HD int64_t path(const Lane& l) const { return l.pix; }
};

// Ray `ray` of a recording trace (megakernel.py:734-808 with record_sel):
// (R, 3) rays in, the unclamped colour and the per-bounce selections out —
// the unified-table row of each hit, -1 after the path ended.
template <class Source>
struct RecordJob {
  using Uniforms = decltype(Source().at(0));
  struct Lane {
    PathState s;
    Uniforms un;
    int64_t ray;
    int n_hits;
  };

  TraceParams p;
  Source src;
  const float* o;
  const float* d;
  float* color;
  int32_t* sel;
  DenseScene sc;  // the staged scene
  int64_t base;   // the tile's first ray

  PTRE_HD int n_tiles() const {
    return (int)(((int64_t)p.n_rays + kRecordTile - 1) / kRecordTile);
  }

  // Takes tile t; returns its rays.
  PTRE_HD int tile(int t) {
    base = (int64_t)t * kRecordTile;
    return (int)(p.n_rays - base < kRecordTile ? p.n_rays - base : kRecordTile);
  }

  PTRE_HD void start(int item, Lane& l) const {
    l.ray = base + item;
    l.un = src.at(l.ray);
    l.n_hits = 0;
    const float* ro = o + 3 * l.ray;
    const float* rd = d + 3 * l.ray;
    l.s.ox = ro[0];
    l.s.oy = ro[1];
    l.s.oz = ro[2];
    l.s.dx = rd[0];
    l.s.dy = rd[1];
    l.s.dz = rd[2];
    l.s.cr = l.s.cg = l.s.cb = 1.0f;
    l.s.bounce = 0;
  }

  PTRE_HD int step(Lane& l, unsigned* tested) const {
    SelRecorder rec = {sel, l.ray, p.n_rays, p.sph_offset, l.n_hits};
    const int end = path_bounce(l.s, sc, p, l.un, rec, tested);
    l.n_hits = rec.n_hits;
    return end;
  }

  PTRE_HD void finish(const Lane& l) const {
    for (int b = l.n_hits; b < p.max_depth; ++b) sel[b * p.n_rays + l.ray] = -1;
    color[3 * l.ray] = l.s.cr;
    color[3 * l.ray + 1] = l.s.cg;
    color[3 * l.ray + 2] = l.s.cb;
  }

  PTRE_HD int64_t path(const Lane& l) const { return l.ray; }
};

#ifdef __CUDACC__
// The dense kernels: kDenseWarps warps a block, each draining one tile of
// `job` (a RenderJob or a RecordJob) with the warp scheduler below, over
// the scene `tab` staged in shared memory; kCount adds the kStats counters
// into `stats` and, with `lens`, writes each path's bounces there.
//
// Staging: warp 0 derives the valid triangle rows in ascending order (a
// ballot per 32 rows) and the boxes' pad, the other threads copy the
// spheres and the sky (a hit's material row is read in place); then a
// thread a group takes its group's box.
//
// The scheduler: each lane carries one path, advanced one bounce at a time;
// a lane whose path ended finishes it (one write) and, once at least
// kRefillMin lanes are idle, takes the tile's next unstarted item through a
// warp-uniform cursor. The warp leaves when its tile is drained. Every
// bounce runs the same sweep whatever its index, so lanes at different
// bounces share it. The loop is written in the kernel's body: written in a
// function, even a forced-inline one, nvcc placed some FMA contractions of
// the shading otherwise, and colours of sphere hits moved by an ulp from the
// first design's.
template <bool kCount, class Job>
__global__ void __launch_bounds__(kDenseWarps* kLanes)
    dense_kernel(Job job, const SceneTables tab,
                 unsigned long long* __restrict__ stats, int32_t* __restrict__ lens) {
  __shared__ __align__(16) float s_rows[kMaxTri * kRowFloats];
  __shared__ __align__(16) float s_box[kMaxGroups * kBoxFloats];
  __shared__ __align__(16) float s_sph[kMaxSph * kSphStride];
  __shared__ float s_sky[8];
  __shared__ int s_n_valid;
  __shared__ float s_pad;

  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const unsigned lane = tid % kLanes;
  if (warp == 0) {
    int n = 0;
    float scale = 0.0f;
    for (int j0 = 0; j0 < tab.n_tri; j0 += kLanes) {
      const int j = j0 + lane;
      const bool valid = j < tab.n_tri && row_valid(tab.tris + j * kTriStride);
      const unsigned b = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        derive_row(tab.tris + j * kTriStride, j,
                   s_rows + kRowFloats * (n + __popc(b & ((1u << lane) - 1u))));
        scale = fmaxf(scale, row_extent(tab.tris + j * kTriStride));
      }
      n += __popc(b);
    }
    // the largest of the lanes' extents: non-negative floats order as
    // their bits do
    scale = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(scale)));
    if (lane == 0) {
      s_n_valid = n;
      s_pad = mul_rn(kCullPadRel, scale);
    }
  }
  for (int i = tid; i < tab.n_sph * kSphStride; i += kDenseWarps * kLanes)
    s_sph[i] = tab.sphs[i];
  if (tid < 8) s_sky[tid] = tab.sky[tid];
  __syncthreads();
  if (tid * kGroupRows < s_n_valid)
    group_box(tab.tris, s_rows, s_n_valid, tid, s_pad, s_box + kBoxFloats * tid);
  __syncthreads();

  const int t = blockIdx.x * kDenseWarps + warp;
  if (t >= job.n_tiles()) return;
  const int n_items = job.tile(t);
  job.sc = {s_rows, s_box, s_sph, s_n_valid, tab.n_sph,
            {nullptr, s_sph, tab.mats, s_sky, 0, tab.n_sph, tab.num_mats}};

  const unsigned below = (1u << lane) - 1u;
  typename Job::Lane l;
  bool live = false;
  int item = 0, cursor = 0, len = 0;
  unsigned started = 0, hits = 0, live_bounces = 0, issued = 0, tested = 0;
  for (;;) {
    const unsigned idle = __ballot_sync(0xffffffffu, !live);
    if (cursor < n_items && __popc(idle) >= kRefillMin) {
      if (!live) {
        item = cursor + __popc(idle & below);
        if (item < n_items) {
          job.start(item, l);
          live = true;
          len = 0;
          started += kCount;
        }
      }
      cursor = min(cursor + __popc(idle), n_items);
    }
    const unsigned active = __ballot_sync(0xffffffffu, live);
    if (active == 0u) break;
    if (kCount) {
      ++issued;
      live_bounces += __popc(active);
    }
    if (live) {
      const int end = job.step(l, kCount ? &tested : nullptr);
      if (kCount) {
        ++len;
        hits += end != kMissed;
      }
      if (end != kGoesOn) {
        job.finish(l);
        live = false;
        if (kCount && lens != nullptr) lens[job.path(l)] = len;
      }
    }
  }
  if (kCount) {
    started = __reduce_add_sync(0xffffffffu, started);
    hits = __reduce_add_sync(0xffffffffu, hits);
    tested = __reduce_add_sync(0xffffffffu, tested);
    if (lane == 0) {
      atomicAdd(stats, (unsigned long long)started);
      atomicAdd(stats + 1, (unsigned long long)live_bounces);
      atomicAdd(stats + 2, (unsigned long long)hits);
      atomicAdd(stats + 3, (unsigned long long)issued);
      atomicAdd(stats + 4, (unsigned long long)tested);
    }
  }
}

// Launches dense_kernel over every tile of `job` on `stream`, the counting
// instantiation when `stats` is given (`lens` as dense_kernel's); returns
// cudaGetLastError().
template <class Job>
inline int launch_dense(const Job& job, const SceneTables& tab,
                        unsigned long long* stats, int32_t* lens, void* stream) {
  const int grid = (job.n_tiles() + kDenseWarps - 1) / kDenseWarps;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  if (stats != nullptr) {
    dense_kernel<true, Job><<<grid, kDenseWarps * kLanes, 0, (cudaStream_t)stream>>>(
        job, tab, stats, lens);
  } else {
    dense_kernel<false, Job><<<grid, kDenseWarps * kLanes, 0, (cudaStream_t)stream>>>(
        job, tab, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
#else
// dense_kernel on the host: the scene derived once, then the warp of every
// tile simulated lane by lane in the kernel's order (a refill, then one
// bounce of every live lane), with its counters added into `stats` and each
// path's bounces written into `lens` when given.
template <class Job>
inline void host_dense(Job job, const SceneTables& tab, uint64_t* stats,
                       int32_t* lens) {
  std::vector<float> rows((size_t)tab.n_tri * kRowFloats);
  std::vector<float> boxes((size_t)(tab.n_tri + kGroupRows - 1) / kGroupRows * kBoxFloats);
  const int n_valid = derive_rows(tab.tris, tab.n_tri, rows.data(), boxes.data());
  job.sc = {rows.data(), boxes.data(), tab.sphs, n_valid, tab.n_sph,
            {nullptr, tab.sphs, tab.mats, tab.sky, 0, tab.n_sph, tab.num_mats}};
  for (int t = 0; t < job.n_tiles(); ++t) {
    const int n_items = job.tile(t);
    typename Job::Lane l[kLanes];
    bool live[kLanes] = {};
    int item[kLanes] = {}, len[kLanes] = {};
    int cursor = 0;
    for (;;) {
      int n_idle = 0;
      for (int i = 0; i < kLanes; ++i) n_idle += !live[i];
      if (cursor < n_items && n_idle >= kRefillMin) {
        int rank = 0;
        for (int i = 0; i < kLanes; ++i) {
          if (live[i]) continue;
          item[i] = cursor + rank++;
          if (item[i] < n_items) {
            job.start(item[i], l[i]);
            live[i] = true;
            len[i] = 0;
            if (stats) ++stats[0];
          }
        }
        cursor = cursor + n_idle < n_items ? cursor + n_idle : n_items;
      }
      int n_live = 0;
      for (int i = 0; i < kLanes; ++i) n_live += live[i];
      if (n_live == 0) break;
      if (stats) {
        ++stats[3];
        stats[1] += n_live;
      }
      for (int i = 0; i < kLanes; ++i) {
        if (!live[i]) continue;
        unsigned tested = 0;
        const int end = job.step(l[i], stats ? &tested : nullptr);
        if (stats) stats[4] += tested;
        ++len[i];
        if (stats) stats[2] += end != kMissed;
        if (end != kGoesOn) {
          job.finish(l[i]);
          live[i] = false;
          if (lens) lens[job.path(l[i])] = len[i];
        }
      }
    }
  }
}
#endif

}  // namespace ptre
