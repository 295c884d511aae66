// Frozen header of the yardsticks in this directory (not the library's):
// csrc/trace.cuh as the first designs here were shipped with it. They are
// built against this copy, so a later change to the shipped header shows
// as a difference from them instead of passing by construction.
//
// Per-pixel path tracing, shared by the CUDA render and recording kernels
// and their host builds: trace_path (the bounce loop, with an optional
// selection recorder) and scatter_shade (material select, ONB cosine
// scatter, Oren-Nayar / emissive weight), then render_pixel (ray generation,
// clamp + scrub, running average).
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

#include "philox.cuh"

namespace ptre {

constexpr int kMaxTri = 64;  // dense class: triangle rows staged per block
constexpr int kMaxSph = 64;
constexpr int kMaxMats = 8;
constexpr int kTriStride = 32;  // pack_tri32 row
constexpr int kSphStride = 16;  // pack_sph16 row
constexpr int kMatStride = 8;   // pack_mats row
constexpr int kMaxDepth = 8;    // bounces the gradient kernels keep state for

constexpr float kBig = 3.00000001e+38f;
constexpr float kTau = 6.28318548f;     // float32(2 * 3.14159265358979)
constexpr float kInvPi = 0.318309873f;  // float32(1 / 3.14159265358979)

// Kernel arguments, passed by value. Mirrored field for field by
// RenderParams in ops/cuda/render_kernel.py (every field is 4 bytes).
struct RenderParams {
  float cam[18];  // camera_rows: A B C DA DB DC (x, y, z each)
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
  const float* mats;  // (8, 8)
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

// Shading of a hit (megakernel.py:611-714): returns the bounce factor f and
// the scattered direction wi; *emissive ends the path.
PTRE_HD void scatter_shade(float nx, float ny, float nz, float dx, float dy,
                           float dz, float mat_id, float u1, float u2,
                           const SceneTables& sc, float pdf_eps, float f[3],
                           float wi[3], bool* emissive) {
  // material row: float ids, |id - m| < 0.5, last match wins (:625-631)
  float m_kind = 0.0f, m_ar = 0.0f, m_ag = 0.0f, m_ab = 0.0f, m_param = 0.0f;
  for (int m = 0; m < sc.num_mats; ++m) {
    if (fabsf(mat_id - (float)m) < 0.5f) {
      const float* row = sc.mats + m * kMatStride;
      m_kind = row[0];
      m_ar = row[1];
      m_ag = row[2];
      m_ab = row[3];
      m_param = row[4];
    }
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

// Recorder policies of trace_path. NoRecord compiles to nothing, so the
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
  int n_hits = 0;

  PTRE_HD void hit(int bounce, int tri_idx, int sph_idx) {
    sel[bounce * n_rays + ray] = sph_idx >= 0 ? sph_offset + sph_idx : tri_idx;
    n_hits = bounce + 1;
  }
};

// One path, up to max_depth bounces (megakernel.py:811-990). A path that
// misses (sky) or hits an emitter ends with a per-thread break: the
// reference's skipped bounces are no-ops, so the image is the same.
// ``rec.hit(bounce, tri, sph)`` sees each hit's winner (sph >= 0 when a
// sphere won).
template <class Params, class Uniforms, class Recorder>
PTRE_HD void trace_path(float ox, float oy, float oz, float dx, float dy,
                        float dz, const SceneTables& sc, const Params& p,
                        Uniforms& un, Recorder& rec, float col[3]) {
  float cr = 1.0f, cg = 1.0f, cb = 1.0f;
  for (int bounce = 0; bounce < p.max_depth; ++bounce) {
    // triangle sweep; strict t < best keeps the lowest index (:840-892)
    float tri_t = kBig;
    bool tri_hit = false;
    int tri_idx = 0;
    float bnx = 0.0f, bny = 0.0f, bnz = 0.0f, tri_mat = 0.0f;
    for (int j = 0; j < sc.n_tri; ++j) {
      const float* tr = sc.tris + j * kTriStride;
      if (!(tr[18] > 0.5f)) continue;  // invalid rows accept nothing
      const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
      const float e1x = tr[3] - v0x, e1y = tr[4] - v0y, e1z = tr[5] - v0z;
      const float e2x = tr[6] - v0x, e2y = tr[7] - v0y, e2z = tr[8] - v0z;
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv_det = 1.0f / (fabsf(det) < p.det_eps ? 1.0f : det);
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const bool acc = fabsf(det) >= p.det_eps && u >= 0.0f && u <= 1.0f &&
                       v >= 0.0f && u + v <= 1.0f && t >= p.t_min &&
                       t <= p.t_max;
      if (!acc) continue;
      tri_hit = true;  // ORs acc, not upd (:892)
      if (t < tri_t) {
        // interpolated normal, sign from the geometric normal, applied
        // before normalising (:875-889)
        const float w = 1.0f - u - v;
        const float gnx = e1y * e2z - e1z * e2y;
        const float gny = e1z * e2x - e1x * e2z;
        const float gnz = e1x * e2y - e1y * e2x;
        const float sign = dx * gnx + dy * gny + dz * gnz < 0.0f ? 1.0f : -1.0f;
        tri_t = t;
        bnx = (w * tr[9] + u * tr[12] + v * tr[15]) * sign;
        bny = (w * tr[10] + u * tr[13] + v * tr[16]) * sign;
        bnz = (w * tr[11] + u * tr[14] + v * tr[17]) * sign;
        tri_mat = tr[19];
        tri_idx = j;
      }
    }
    const float tri_best = tri_hit ? tri_t : p.t_max;

    // spheres bounded by the closest triangle; far-root quirk: the
    // acceptance bounds t_near, not t (:906-928)
    float sph_t = kBig;
    bool sph_hit = false;
    int sph_idx = 0;
    float s_cx = 0.0f, s_cy = 0.0f, s_cz = 0.0f, s_ir = 0.0f, sph_mat = 0.0f;
    for (int s = 0; s < sc.n_sph; ++s) {
      const float* sp = sc.sphs + s * kSphStride;
      if (!(sp[4] > 0.5f)) continue;
      const float cx = sp[0], cy = sp[1], cz = sp[2], r = sp[3];
      const float ocx = cx - ox, ocy = cy - oy, ocz = cz - oz;
      const float halfb = dx * ocx + dy * ocy + dz * ocz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
      const float delta = halfb * halfb - c;
      const float sq = sqrtf(fmaxf(delta, 0.0f));
      const float t_near = halfb - sq;
      const float t = t_near >= p.t_min ? t_near : halfb + sq;
      const bool acc = delta >= 0.0f && t_near <= tri_best && t >= p.t_min;
      if (!acc) continue;
      sph_hit = true;
      if (t < sph_t) {
        sph_t = t;
        s_cx = cx;
        s_cy = cy;
        s_cz = cz;
        s_ir = 1.0f / (r == 0.0f ? 1.0f : r);
        sph_mat = sp[5];
        sph_idx = s;
      }
    }

    if (!(tri_hit || sph_hit)) {  // miss: sky factor, the path ends
      float sr, sg, sb;
      sky_color(dy, sc.sky, &sr, &sg, &sb);
      cr *= sr;
      cg *= sg;
      cb *= sb;
      break;
    }

    // merge the winner (a sphere candidate already beat the triangles)
    const bool use_sph = sph_hit;
    rec.hit(bounce, tri_idx, use_sph ? sph_idx : -1);
    const float t_hit = use_sph ? sph_t : tri_t;
    const float px = ox + t_hit * dx;
    const float py = oy + t_hit * dy;
    const float pz = oz + t_hit * dz;
    float nx, ny, nz;
    if (use_sph) {
      const float snx = (px - s_cx) * s_ir;
      const float sny = (py - s_cy) * s_ir;
      const float snz = (pz - s_cz) * s_ir;
      const float s_sign = dx * snx + dy * sny + dz * snz < 0.0f ? 1.0f : -1.0f;
      nx = snx * s_sign;
      ny = sny * s_sign;
      nz = snz * s_sign;
    } else {
      nx = bnx;
      ny = bny;
      nz = bnz;
    }
    const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
    const float ninv = nlen > 0.0f ? 1.0f / nlen : 0.0f;  // guarded (:951-953)
    nx *= ninv;
    ny *= ninv;
    nz *= ninv;
    const float mat_id = use_sph ? sph_mat : tri_mat;

    float u1, u2;
    un.pair(1 + bounce, &u1, &u2);
    float f[3], wi[3];
    bool emissive;
    scatter_shade(nx, ny, nz, dx, dy, dz, mat_id, u1, u2, sc, p.pdf_eps, f,
                  wi, &emissive);
    cr *= f[0];
    cg *= f[1];
    cb *= f[2];
    if (emissive) break;

    // next ray: shadow-epsilon offset along the final normal (:967-977)
    ox = px + p.shadow_eps * nx;
    oy = py + p.shadow_eps * ny;
    oz = pz + p.shadow_eps * nz;
    dx = wi[0];
    dy = wi[1];
    dz = wi[2];
  }
  col[0] = cr;
  col[1] = cg;
  col[2] = cb;
}

// One progressive sample of pixel (x, y) (render_kernel.py:79-179): jitter,
// closed-form camera ray, trace, clamp + non-finite scrub, then
// lin = c/n + lin*(n-1)/n on the (H, W, 3) accumulator in place.
template <class Uniforms>
PTRE_HD void render_pixel(const RenderParams& p, const SceneTables& sc, int x,
                          int y, Uniforms& un, float* accum) {
  float ju, jv;
  un.pair(0, &ju, &jv);
  const float jx = sub_rn(ju, 0.5f);
  const float jy = sub_rn(jv, 0.5f);
  const float x_ndc =
      sub_rn(mul_rn(add_rn((float)x, jx), mul_rn(2.0f, p.inv_w)), 1.0f);
  const float y_ndc =
      sub_rn(1.0f, mul_rn(add_rn((float)y, jy), mul_rn(2.0f, p.inv_h)));
  const float* c = p.cam;
  const float ox = lin2_rn(x_ndc, c[0], y_ndc, c[3], c[6]);
  const float oy = lin2_rn(x_ndc, c[1], y_ndc, c[4], c[7]);
  const float oz = lin2_rn(x_ndc, c[2], y_ndc, c[5], c[8]);
  float dx = lin2_rn(x_ndc, c[9], y_ndc, c[12], c[15]);
  float dy = lin2_rn(x_ndc, c[10], y_ndc, c[13], c[16]);
  float dz = lin2_rn(x_ndc, c[11], y_ndc, c[14], c[17]);
  const float dlen =
      sqrtf(add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz)));
  const float dinv = dlen > 0.0f ? 1.0f / dlen : 0.0f;  // (:142-144)
  dx = mul_rn(dx, dinv);
  dy = mul_rn(dy, dinv);
  dz = mul_rn(dz, dinv);

  float col[3];
  NoRecord rec;
  trace_path(ox, oy, oz, dx, dy, dz, sc, p, un, rec, col);

  for (int ch = 0; ch < 3; ++ch) {
    float v = col[ch];
    if (p.clamp) v = fminf(fmaxf(v, 0.0f), 1.0f);
    if (!isfinite(v)) v = 0.0f;  // NaN and +-inf (integrator.py:188)
    accum[ch] = add_rn(mul_rn(v, p.inv_n), mul_rn(accum[ch], p.w_old));
  }
}

// Ray `ray` of a recording trace (megakernel.py:734-808 with record_sel):
// (R, 3) rays in, the unclamped color and the per-bounce selections out —
// the unified-table row of each hit, -1 after the path ended.
PTRE_HD void record_ray(const TraceParams& p, const SceneTables& sc,
                        int64_t ray, const float* o, const float* d,
                        const float* urand, float* color, int32_t* sel) {
  SelRecorder rec = {sel, ray, p.n_rays, p.sph_offset};
  const float* ro = o + 3 * ray;
  const float* rd = d + 3 * ray;
  float col[3];
  if (p.external_rng) {
    ExternalUniforms un = {urand, ray, p.n_rays};
    trace_path(ro[0], ro[1], ro[2], rd[0], rd[1], rd[2], sc, p, un, rec, col);
  } else {
    PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)ray, p.sample);
    trace_path(ro[0], ro[1], ro[2], rd[0], rd[1], rd[2], sc, p, un, rec, col);
  }
  for (int b = rec.n_hits; b < p.max_depth; ++b) sel[b * p.n_rays + ray] = -1;
  for (int ch = 0; ch < 3; ++ch) color[3 * ray + ch] = col[ch];
}

// Pixel (x, y) with the uniform source the params select.
PTRE_HD void render_pixel_at(const RenderParams& p, const SceneTables& sc,
                             int x, int y, const float* urand, float* accum) {
  const int64_t pix = (int64_t)y * p.width + x;
  float* out = accum + 3 * pix;
  if (p.external_rng) {
    ExternalUniforms un = {urand, pix, (int64_t)p.height * p.width};
    render_pixel(p, sc, x, y, un, out);
  } else {
    PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)pix, p.sample);
    render_pixel(p, sc, x, y, un, out);
  }
}

}  // namespace ptre
