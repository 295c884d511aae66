// Per-(sample, triangle) math of the rasterizer, shared by the CUDA kernels
// raster_kernel.cu (hard z-buffer) and soft_raster_kernel.cu (SoftRas forward
// and backward) and by their host build (host_raster.cpp).
//
// These are the one-pair forms of ptre_tpu/ops/pallas/raster_kernel.py
// _raster_kernel (:255: coverage, z test, deferred winner shading :387-416)
// and ptre_tpu/ops/pallas/soft_raster.py _pair_terms (:76), plus the
// hand-written adjoint of _pair_terms: the TPU backward kernel traces
// jax.vjp inside the kernel (soft_raster.py:327), which CUDA has no
// counterpart of. The plain PyTorch twins are raster_kernel.raster_reference
// and soft_raster.pair_terms in ops/cuda/; the soft terms are templated on
// the scalar so that the host check runs them in double against torch
// float64 autograd.
//
// Row layout (pack_raster_tris, 32 floats): 0-5 screen xy of the corners,
// 6-8 NDC z, 9-11 1/w, 12 keep, 13-21 world normal * 1/w per corner, 22
// 1/area, 23-26 screen box (minx, maxx, miny, maxy), 27-29 inverse squared
// edge lengths (soft table only), 30-31 zero.
//
// Rounding: the edge functions, barycentrics and z (which decide coverage and
// the z test) and the hard path's shading are written with round-to-nearest
// operations that nvcc never contracts into FMAs, in the plain version's
// operation order: the hard kernel's winners and colours equal the plain
// version's bit for bit. The soft unit is built with -fmad=false
// (ops/cuda/build.py UNIT_FLAGS): its pair terms and adjoint round every
// operation on its own, as the plain version does.
//
// Gradient rules, as JAX differentiates the reference: a max, min or clip
// tie sends half the gradient to each side (d max(x, 0) at x == 0 is 0.5;
// min(d01, min(d12, d20)) splits level by level); `where` routes the
// gradient to the branch taken; the sigmoid is the stable form, and its
// derivative s * (1 - s) stays finite for any argument.
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
namespace rast {

constexpr int kChunk = 64;      // triangle rows per chunk: the cull and staging unit
constexpr int kRow = 32;        // table row stride
constexpr int kBoxStride = 8;   // chunk box row: minx maxx miny maxy any_keep 0 0 0
constexpr int kTile = 16;       // a block is a kTile x kTile sample tile
constexpr int kGroup = 8;       // soft forward: triangles per online-softmax update
constexpr float kFar = 1.0e9f;  // empty z-buffer (raster_kernel._FAR)
constexpr float kBig = 3e38f;   // soft_raster._BIG
constexpr float kInvTau = 100.0f;  // depth softmax 1/temperature
constexpr float kCovMin = 1e-6f;   // pairs at or below this coverage are skipped

// the columns of a row that carry a soft gradient (all others get none)
constexpr int kGradCols = 26;
PTRE_HD int grad_col(int j) { return j < 23 ? j : j + 4; }  // 0-22, 27-29

// Arguments of the three kernels, passed by value. Mirrored field for field
// by RasterParams in ops/cuda/raster_kernel.py (every field 4 bytes).
struct RasterParams {
  // ambient rgb, albedo rgb, light xyz, clear rgb, 1/sigma, y0, stride, 0
  float scal[16];
  int32_t rows_ss,   // supersampled rows of the (y0, stride) window
      width_ss,      // supersampled columns
      ss,            // supersampling factor
      n_chunks;      // chunks of the table (rows / kChunk)
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
PTRE_HD double mul_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
PTRE_HD double add_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
PTRE_HD double sub_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}
PTRE_HD float sqrt_t(float x) { return sqrtf(x); }
PTRE_HD double sqrt_t(double x) { return sqrt(x); }
PTRE_HD float exp_t(float x) { return expf(x); }
PTRE_HD double exp_t(double x) { return exp(x); }

// d max(x, y) / dx and d min(x, y) / dx, JAX's tie rule (half at a tie)
template <typename T>
PTRE_HD T dmax_dx(T x, T y) {
  return x > y ? T(1) : (x == y ? T(0.5) : T(0));
}
template <typename T>
PTRE_HD T dmin_dx(T x, T y) {
  return x < y ? T(1) : (x == y ? T(0.5) : T(0));
}
// clip(x, 0, 1) = min(max(x, 0), 1), as jnp.clip, and its derivative
template <typename T>
PTRE_HD T clip01(T x) {
  const T m = x > T(0) ? x : T(0);
  return m < T(1) ? m : T(1);
}
template <typename T>
PTRE_HD T dclip01(T x) {
  const T m = x > T(0) ? x : T(0);
  return dmin_dx(m, T(1)) * dmax_dx(x, T(0));
}
// the stable logistic: never exp of a large positive argument
template <typename T>
PTRE_HD T sigmoid(T x) {
  if (x >= T(0)) return T(1) / (T(1) + exp_t(-x));
  const T e = exp_t(x);
  return e / (T(1) + e);
}

// Supersampled y of window row r: output row y0 + stride * (r / ss), sub-row
// r % ss (soft_raster._row_y; rasterizer.raster_rows), rounded in order.
PTRE_HD float row_y(const RasterParams& p, int r) {
  const float out_row = add_rn(p.scal[13], mul_rn(p.scal[14], (float)(r / p.ss)));
  return add_rn(add_rn(mul_rn(out_row, (float)p.ss), (float)(r % p.ss)), 0.5f);
}

// Does chunk box b touch the sample tile [x_lo, x_hi) x rows [r0, r1]? The
// y range [y(r0) - 0.5, y(r1) + 1) is the soft kernels' (soft_raster.py
// :179-183), a superset of the hard kernel's shortlist test
// (raster_kernel.py:241-246): a block-uniform gate, conservative by at least
// half a sample, so a skipped chunk holds no pair that could count.
PTRE_HD bool chunk_hits(const float* b, float x_lo, float x_hi, float y_first,
                        float y_last) {
  return b[4] > 0.5f && b[0] < x_hi && b[1] >= x_lo &&
         b[2] < add_rn(y_last, 1.0f) && b[3] >= sub_rn(y_first, 0.5f);
}

// Barycentrics and z of sample (px, py) in row c, in the reference's order
// (raster_kernel.py:316-321), never contracted.
template <typename T>
struct Bary {
  T e0, e1;  // unnormalised edge functions
  T w0, w1, w2, z;
};

template <typename T>
PTRE_HD Bary<T> barycentric(const T* c, T px, T py) {
  Bary<T> b;
  b.e0 = sub_rn(mul_rn(sub_rn(c[2], px), sub_rn(c[5], py)),
                mul_rn(sub_rn(c[4], px), sub_rn(c[3], py)));
  b.e1 = sub_rn(mul_rn(sub_rn(c[4], px), sub_rn(c[1], py)),
                mul_rn(sub_rn(c[0], px), sub_rn(c[5], py)));
  b.w0 = mul_rn(b.e0, c[22]);
  b.w1 = mul_rn(b.e1, c[22]);
  b.w2 = sub_rn(sub_rn(T(1), b.w0), b.w1);
  b.z = add_rn(add_rn(mul_rn(b.w0, c[6]), mul_rn(b.w1, c[7])), mul_rn(b.w2, c[8]));
  return b;
}

// ---- hard z-buffer ------------------------------------------------------------

// The hard coverage + depth test of one live pair (raster_kernel.py:322-325).
PTRE_HD bool covers(const float* c, float px, float py, float* z) {
  const Bary<float> b = barycentric(c, px, py);
  *z = b.z;
  return b.w0 >= 0.0f && b.w1 >= 0.0f && b.w2 >= 0.0f && b.z >= 0.0f &&
         b.z <= 1.0f && c[12] > 0.5f;
}

// Shade the winner row c at (px, py): exact re-interpolation of the
// perspective-correct normal, normalise (zero stays zero), HLSL ambient +
// diffuse (raster_kernel.py:387-416). scal: the RasterParams scalars.
// w0 c[k0] + w1 c[k1] + w2 c[k2], rounded in order
PTRE_HD float bary_lin(const Bary<float>& b, const float* c, int k0, int k1, int k2) {
  return add_rn(add_rn(mul_rn(b.w0, c[k0]), mul_rn(b.w1, c[k1])), mul_rn(b.w2, c[k2]));
}

PTRE_HD void shade_winner(const float* c, float px, float py, const float* scal,
                          float rgb[3]) {
  const Bary<float> b = barycentric(c, px, py);
  const float den = bary_lin(b, c, 9, 10, 11);
  const float inv_den = 1.0f / (den == 0.0f ? 1.0f : den);
  const float nx = mul_rn(bary_lin(b, c, 13, 16, 19), inv_den);
  const float ny = mul_rn(bary_lin(b, c, 14, 17, 20), inv_den);
  const float nz = mul_rn(bary_lin(b, c, 15, 18, 21), inv_den);
  const float nlen = sqrtf(add_rn(add_rn(mul_rn(nx, nx), mul_rn(ny, ny)), mul_rn(nz, nz)));
  const float ninv = nlen > 0.0f ? 1.0f / nlen : 0.0f;
  const float ndl = add_rn(add_rn(mul_rn(mul_rn(nx, ninv), scal[6]),
                                  mul_rn(mul_rn(ny, ninv), scal[7])),
                           mul_rn(mul_rn(nz, ninv), scal[8]));
  const float q = -ndl;
  const float diffuse = q > 0.0f ? q : 0.0f;
  for (int k = 0; k < 3; ++k) rgb[k] = mul_rn(add_rn(scal[k], diffuse), scal[3 + k]);
}

// ---- SoftRas pair terms and their adjoint -------------------------------------

template <typename T>
struct SoftScal {
  T amb[3], alb[3], light[3], sigma_inv;
};

template <typename T>
PTRE_HD SoftScal<T> soft_scal(const float* s) {
  SoftScal<T> k;
  for (int i = 0; i < 3; ++i) {
    k.amb[i] = T(s[i]);
    k.alb[i] = T(s[3 + i]);
    k.light[i] = T(s[6 + i]);
  }
  k.sigma_inv = T(s[12]);
  return k;
}

// Closest point of segment a -> b to p, and the distance (soft_raster.py:92-99)
template <typename T>
struct EdgeFwd {
  T ex, ey, rx, ry, t_raw, t, dx, dy, d;
};

template <typename T>
PTRE_HD EdgeFwd<T> edge_fwd(T ax, T ay, T bx, T by, T ilen, T px, T py) {
  EdgeFwd<T> e;
  e.ex = bx - ax;
  e.ey = by - ay;
  e.rx = px - ax;
  e.ry = py - ay;
  e.t_raw = (e.rx * e.ex + e.ry * e.ey) * ilen;
  e.t = clip01(e.t_raw);
  e.dx = px - (ax + e.t * e.ex);
  e.dy = py - (ay + e.t * e.ey);
  e.d = sqrt_t(e.dx * e.dx + e.dy * e.dy + T(1e-12f));
  return e;
}

// d(distance) = gd onto the segment's ends and its inverse squared length
template <typename T>
PTRE_HD void edge_adjoint(const EdgeFwd<T>& e, T gd, T* gax, T* gay, T* gbx,
                          T* gby, T* gilen, T ilen) {
  const T gs = gd * (T(0.5) / e.d);
  const T gdx = gs * T(2) * e.dx, gdy = gs * T(2) * e.dy;
  // closest point c = a + t * e, d = p - c
  T gax_ = -gdx, gay_ = -gdy;
  T gt = -gdx * e.ex - gdy * e.ey;
  T gex = -gdx * e.t, gey = -gdy * e.t;
  const T gtr = gt * dclip01(e.t_raw);
  *gilen += gtr * (e.rx * e.ex + e.ry * e.ey);
  const T ga = gtr * ilen;  // d(rx*ex + ry*ey)
  gax_ -= ga * e.ex;
  gay_ -= ga * e.ey;
  gex += ga * e.rx;
  gey += ga * e.ry;
  *gax += gax_ - gex;
  *gay += gay_ - gey;
  *gbx += gex;
  *gby += gey;
}

// Everything of one pair that the adjoint reads: the forward, computed once.
template <typename T>
struct PairFwd {
  Bary<T> b;
  EdgeFwd<T> e01, e12, e20;
  T inner, dist, sig, z_ok, keep;
  bool inside;
  T den, inv_den, ux, uy, uz, nx, ny, nz, nlen, q;
  // outputs
  T cov, logit, col[3];
};

// soft_raster._pair_terms for one (triangle row, sample): coverage, depth
// logit and the shaded colour.
template <typename T>
PTRE_HD PairFwd<T> pair_forward(const T* c, T px, T py, const SoftScal<T>& k) {
  PairFwd<T> f;
  f.b = barycentric(c, px, py);
  f.z_ok = (f.b.z >= T(0) && f.b.z <= T(1)) ? T(1) : T(0);
  f.keep = c[12];
  f.e01 = edge_fwd(c[0], c[1], c[2], c[3], c[27], px, py);
  f.e12 = edge_fwd(c[2], c[3], c[4], c[5], c[28], px, py);
  f.e20 = edge_fwd(c[4], c[5], c[0], c[1], c[29], px, py);
  f.inner = f.e12.d < f.e20.d ? f.e12.d : f.e20.d;
  f.dist = f.e01.d < f.inner ? f.e01.d : f.inner;
  f.inside = f.b.w0 >= T(0) && f.b.w1 >= T(0) && f.b.w2 >= T(0);
  const T signed_d = f.inside ? f.dist : -f.dist;
  f.sig = sigmoid(signed_d * k.sigma_inv);
  f.cov = f.keep * f.z_ok * f.sig;
  f.logit = -clip01(f.b.z) * T(kInvTau);

  const T w0 = f.b.w0, w1 = f.b.w1, w2 = f.b.w2;
  f.den = w0 * c[9] + w1 * c[10] + w2 * c[11];
  f.inv_den = T(1) / (f.den == T(0) ? T(1) : f.den);
  f.ux = w0 * c[13] + w1 * c[16] + w2 * c[19];
  f.uy = w0 * c[14] + w1 * c[17] + w2 * c[20];
  f.uz = w0 * c[15] + w1 * c[18] + w2 * c[21];
  f.nx = f.ux * f.inv_den;
  f.ny = f.uy * f.inv_den;
  f.nz = f.uz * f.inv_den;
  f.nlen = sqrt_t(f.nx * f.nx + f.ny * f.ny + f.nz * f.nz + T(1e-20f));
  const T ninv = T(1) / f.nlen;
  f.q = -((f.nx * ninv) * k.light[0] + (f.ny * ninv) * k.light[1] +
          (f.nz * ninv) * k.light[2]);
  const T diffuse = f.q > T(0) ? f.q : T(0);
  for (int i = 0; i < 3; ++i) f.col[i] = (k.amb[i] + diffuse) * k.alb[i];
  return f;
}

// The vector-Jacobian product of pair_forward: cotangents (gcov, glogit,
// gcol) of its outputs -> d(row), added into g[32] (soft_raster.py:327-336,
// by hand).
template <typename T>
PTRE_HD void pair_adjoint(const T* c, T px, T py, const SoftScal<T>& k,
                          const PairFwd<T>& f, T gcov, T glogit, const T gcol[3],
                          T* g) {
  const T w0 = f.b.w0, w1 = f.b.w1, w2 = f.b.w2;
  // shading: col = (amb + max(q, 0)) * alb
  const T gdiff = gcol[0] * k.alb[0] + gcol[1] * k.alb[1] + gcol[2] * k.alb[2];
  const T gq = gdiff * dmax_dx(f.q, T(0));
  const T ninv = T(1) / f.nlen;
  // q = -(n * ninv) . light
  const T gmx = -gq * k.light[0], gmy = -gq * k.light[1], gmz = -gq * k.light[2];
  const T gninv = gmx * f.nx + gmy * f.ny + gmz * f.nz;
  const T gnlen = -gninv / (f.nlen * f.nlen);
  const T gl2 = gnlen * (T(0.5) / f.nlen);
  const T gnx = gmx * ninv + gl2 * T(2) * f.nx;
  const T gny = gmy * ninv + gl2 * T(2) * f.ny;
  const T gnz = gmz * ninv + gl2 * T(2) * f.nz;
  // n = u * inv_den, inv_den = 1 / where(den == 0, 1, den)
  const T gux = gnx * f.inv_den, guy = gny * f.inv_den, guz = gnz * f.inv_den;
  const T ginv = gnx * f.ux + gny * f.uy + gnz * f.uz;
  const T gden = f.den == T(0) ? T(0) : -ginv / (f.den * f.den);
  T gw0 = gden * c[9] + gux * c[13] + guy * c[14] + guz * c[15];
  T gw1 = gden * c[10] + gux * c[16] + guy * c[17] + guz * c[18];
  T gw2 = gden * c[11] + gux * c[19] + guy * c[20] + guz * c[21];
  g[9] += gden * w0;
  g[10] += gden * w1;
  g[11] += gden * w2;
  g[13] += gux * w0;
  g[14] += guy * w0;
  g[15] += guz * w0;
  g[16] += gux * w1;
  g[17] += guy * w1;
  g[18] += guz * w1;
  g[19] += gux * w2;
  g[20] += guy * w2;
  g[21] += guz * w2;

  // logit = -clip(z, 0, 1) * 100; cov = keep * z_ok * sigmoid(signed / sigma)
  T gz = -glogit * T(kInvTau) * dclip01(f.b.z);
  g[12] += gcov * f.z_ok * f.sig;
  const T ga = gcov * f.keep * f.z_ok * f.sig * (T(1) - f.sig);
  const T gsigned = ga * k.sigma_inv;
  const T gdist = f.inside ? gsigned : -gsigned;
  const T gd01 = gdist * dmin_dx(f.e01.d, f.inner);
  const T ginner = gdist * dmin_dx(f.inner, f.e01.d);
  const T gd12 = ginner * dmin_dx(f.e12.d, f.e20.d);
  const T gd20 = ginner * dmin_dx(f.e20.d, f.e12.d);
  edge_adjoint(f.e01, gd01, &g[0], &g[1], &g[2], &g[3], &g[27], c[27]);
  edge_adjoint(f.e12, gd12, &g[2], &g[3], &g[4], &g[5], &g[28], c[28]);
  edge_adjoint(f.e20, gd20, &g[4], &g[5], &g[0], &g[1], &g[29], c[29]);

  // z = w0 z0 + w1 z1 + w2 z2; w2 = 1 - w0 - w1; w0 = e0 / area, w1 = e1 / area
  g[6] += gz * w0;
  g[7] += gz * w1;
  g[8] += gz * w2;
  gw0 += gz * c[6];
  gw1 += gz * c[7];
  gw2 += gz * c[8];
  gw0 -= gw2;
  gw1 -= gw2;
  g[22] += gw0 * f.b.e0 + gw1 * f.b.e1;
  const T ge0 = gw0 * c[22], ge1 = gw1 * c[22];
  // e0 = (x1 - px)(y2 - py) - (x2 - px)(y1 - py)
  g[2] += ge0 * (c[5] - py);
  g[5] += ge0 * (c[2] - px);
  g[4] -= ge0 * (c[3] - py);
  g[3] -= ge0 * (c[4] - px);
  // e1 = (x2 - px)(y0 - py) - (x0 - px)(y2 - py)
  g[4] += ge1 * (c[1] - py);
  g[1] += ge1 * (c[4] - px);
  g[0] -= ge1 * (c[5] - py);
  g[5] -= ge1 * (c[0] - px);
}

// Per-sample softmax state -> cotangents of one pair (soft_raster.py
// :301-335): from the saved (m, D, W, N) and the image cotangent.
template <typename T>
struct SoftRowState {
  T m, inv_d, s, g_clear, g_out, gimg[3];
};

template <typename T>
PTRE_HD SoftRowState<T> soft_row_state(const T res[6], const T gimg[3],
                                       const float* scal) {
  SoftRowState<T> st;
  st.m = res[0];
  const T D = res[1];
  st.inv_d = D > T(0) ? T(1) / D : T(0);
  st.s = res[2] * st.inv_d;
  const T live_bg = st.s < T(1) ? T(1) : T(0);
  st.g_clear = (gimg[0] * T(scal[9]) + gimg[1] * T(scal[10]) + gimg[2] * T(scal[11])) * live_bg;
  st.g_out = (gimg[0] * res[3] + gimg[1] * res[4] + gimg[2] * res[5]) * st.inv_d;
  for (int i = 0; i < 3; ++i) st.gimg[i] = gimg[i];
  return st;
}

// d(row) of one pair, added into g[32]; returns false (adding nothing) for a
// pair at or below the coverage threshold.
template <typename T>
PTRE_HD bool pair_backward(const T* c, T px, T py, const SoftScal<T>& k,
                           const SoftRowState<T>& st, T* g) {
  const PairFwd<T> f = pair_forward(c, px, py, k);
  if (!(f.cov > T(kCovMin))) return false;
  T dlm = f.logit - st.m;
  const T e = exp_t(dlm < T(0) ? dlm : T(0));
  const T p = e * st.inv_d;
  const T gc = st.gimg[0] * f.col[0] + st.gimg[1] * f.col[1] + st.gimg[2] * f.col[2];
  const T dl = p * (f.cov * gc - st.g_out) - st.g_clear * p * (f.cov - st.s);
  const T dcov = p * gc - st.g_clear * p;
  const T wi = f.cov * p;
  const T gcol[3] = {wi * st.gimg[0], wi * st.gimg[1], wi * st.gimg[2]};
  pair_adjoint(c, px, py, k, f, dcov, dl, gcol, g);
  return true;
}

// ---- the soft kernels' row gate ------------------------------------------------
//
// A pair whose sample lies outside the row's screen box dilated by 14 sigma
// has a signed distance below -14 sigma (outside the triangle, at least that
// far from each edge), so its coverage is at most sigmoid(-14) = 8.3e-7, below
// kCovMin: the plain version includes no such pair. The gate box grows the
// dilated box by kGatePadRel of (the row's largest |coordinate| + 14 sigma):
// the computed edge distance and the box's own rounding are off by a few
// ulps of those magnitudes (~5e-7 of them), so rounding can never cull a
// pair that counts; sigmoid(-13.8155) = 1e-6 leaves a further 0.18 sigma.

constexpr float kDilateSigma = 14.0f;  // soft_raster.DILATE_SIGMA
constexpr float kGatePadRel = 1e-5f;

struct GateBox {
  float x0, x1, y0, y1;
};

// Row c's gate box; dil = 14 sigma (kDilateSigma / the 1/sigma scalar).
PTRE_HD GateBox gate_box(const float* c, float dil) {
  const float m = fmaxf(fmaxf(fabsf(c[23]), fabsf(c[24])), fmaxf(fabsf(c[25]), fabsf(c[26])));
  const float reach = add_rn(dil, mul_rn(kGatePadRel, add_rn(m, dil)));
  return {sub_rn(c[23], reach), add_rn(c[24], reach), sub_rn(c[25], reach),
          add_rn(c[26], reach)};
}

// Is kept row c's gate box b in reach of the sample tile? The tile's extent
// as chunk_hits takes it: conservative by at least half a sample, so a row
// whose gate box holds a sample of the tile always passes.
PTRE_HD bool row_hits(const float* c, const GateBox& b, float x_lo, float x_hi,
                      float y_first, float y_last) {
  return c[12] > 0.5f && b.x0 < x_hi && b.x1 >= x_lo && b.y0 < add_rn(y_last, 1.0f) &&
         b.y1 >= sub_rn(y_first, 0.5f);
}

PTRE_HD bool box_holds(const GateBox& b, float px, float py) {
  return px >= b.x0 && px <= b.x1 && py >= b.y0 && py <= b.y1;
}

// ---- the hard kernel's row gate --------------------------------------------------
//
// A pair whose sample lies outside the row's screen box cannot cover in exact
// arithmetic, but covers() rounds: for a row of tiny area the rounded
// barycentrics of a sample beyond the box can all be >= 0. The gate box is the
// screen box grown by `reach`, derived from the rounding of covers() (u =
// 2^-24, Sb the box's larger side, A the row's exact area, alpha the stored
// float32 area, 1/alpha its col 22, R the largest |corner - sample|
// coordinate difference):
//   * each edge function is off by at most 4u (|a b| + |c d|) <= 8u R^2, the
//     stored area off the exact one by at most 8u Sb^2, |alpha| <= 2 Sb^2;
//   * a pair that covers has w0, w1 >= 0 and w0 + w1 <= 1 + u, so every exact
//     edge function is >= -E, E = 16.04u R^2 + 14.2u Sb^2, every exact
//     barycentric >= -E / A, and the sample lies at most D = 2 Sb E / A
//     outside the box on either axis; R <= Sb + D;
//   * so a covering sample at distance D from the box needs
//     f(D) = (2 Sb / A) u (16.04 (Sb + D)^2 + 14.2 Sb^2) - D >= 0. f is
//     convex: f < 0 at D = reach and at the farthest sample of the window
//     (span + the row's largest |coordinate|) puts every sample beyond the
//     grown box out of reach.
// With q = 2u Sb / alpha, reach = 64 q Sb^2 gives f(reach) < 0 (30.6 q Sb^2
// of 64, for reach <= Sb / 100, a row of area >= 7.6e-4 Sb^2); the far end is
// held at twice f's terms. Where either test fails (a sliver, or a row whose
// arithmetic may overflow) the reach is infinite: the row is not gated and
// every sample of a visited tile tests it, as the first design did. A
// rounded bound never halves a margin of 2. Tests: tests/test_torch_raster_gate.py.

constexpr float kRoundoff = 5.9604645e-8f;  // 2^-24, float32's unit roundoff

// The largest |coordinate| of any sample of the window, plus a margin.
PTRE_HD float window_span(const RasterParams& p) {
  const float y = fmaxf(fabsf(row_y(p, 0)), fabsf(row_y(p, p.rows_ss - 1)));
  return add_rn(fmaxf((float)p.width_ss, y), (float)(p.ss + 1));
}

// Kept row c's gate box for samples within `span` (window_span) of the origin.
PTRE_HD GateBox hard_gate_box(const float* c, float span) {
  const float sb = fmaxf(sub_rn(c[24], c[23]), sub_rn(c[26], c[25]));
  const float m = fmaxf(fmaxf(fabsf(c[23]), fabsf(c[24])), fmaxf(fabsf(c[25]), fabsf(c[26])));
  const float q = mul_rn(mul_rn(2.0f * kRoundoff, sb), fabsf(c[22]));
  const float reach = mul_rn(mul_rn(64.0f, q), mul_rn(sb, sb));
  const float dmax = add_rn(span, m);
  const float sr = add_rn(sb, dmax);
  const bool sound = reach <= mul_rn(0.01f, sb) &&
                     mul_rn(mul_rn(32.0f, q), add_rn(mul_rn(sr, sr), mul_rn(sb, sb))) <= dmax;
  const float r = sound ? reach : INFINITY;
  return {sub_rn(c[23], r), add_rn(c[24], r), sub_rn(c[25], r), add_rn(c[26], r)};
}

PTRE_HD int lowest_bit(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)m) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

// One chunk's rows (global ids base..base+63) into a sample's z-buffer: the
// rows of `mask` (bit i: row base + i passed the tile's gate) whose gate box
// holds the sample, with strict z < best in ascending row order, so a z tie
// keeps the lowest sorted index, within the chunk and across ascending chunks
// (raster_kernel.py:327-343). No other row of the chunk can cover the sample,
// so the winner is that of a sweep over all 64. n_test counts the covers()
// evaluated, n_cover those that cover.
PTRE_HD void hard_sweep_gated(const float* rows, const GateBox* boxes, uint64_t mask, int base,
                              float px, float py, float& best_z, int& best_i, uint32_t& n_test,
                              uint32_t& n_cover) {
  for (; mask != 0; mask &= mask - 1) {
    const int i = lowest_bit(mask);
    if (!box_holds(boxes[i], px, py)) continue;
    ++n_test;
    float z;
    if (covers(rows + i * kRow, px, py, &z)) {
      ++n_cover;
      if (z < best_z) {
        best_z = z;
        best_i = base + i;
      }
    }
  }
}

// Online-softmax state of one sample (soft_raster.py:191-226)
struct SoftState {
  float m, D, W, N[3];
};

PTRE_HD SoftState soft_state_init() { return {-kBig, 0.0f, 0.0f, {0.0f, 0.0f, 0.0f}}; }

// One group of kGroup rows (c points at the group's first row, b at their
// gate boxes) into the state, with the reference's empty-state guards
// (soft_raster.py:199-220). Only the rows of `bits` whose gate box holds the
// sample are evaluated (n_eval counts them, n_inc those above kCovMin); every
// other row enters as the plain version computes it, lm = -BIG and e = 0.
// A group with no pair above kCovMin leaves the state bit for bit as it was
// (gm = -BIG: m_new = m, and scale is 1, or 0 on the all-zero empty state).
PTRE_HD void soft_group(const float* c, const GateBox* b, unsigned bits, float px, float py,
                        const SoftScal<float>& k, SoftState& st, uint32_t& n_eval,
                        uint32_t& n_inc) {
  float cov[kGroup], lm[kGroup], col[kGroup][3];
  float gm = -kBig;
  for (int j = 0; j < kGroup; ++j) {
    cov[j] = 0.0f;
    lm[j] = -kBig;
    for (int i = 0; i < 3; ++i) col[j][i] = 0.0f;
    if ((bits >> j & 1u) && box_holds(b[j], px, py)) {
      const PairFwd<float> f = pair_forward(c + j * kRow, px, py, k);
      ++n_eval;
      if (f.cov > kCovMin) {
        ++n_inc;
        cov[j] = f.cov;
        lm[j] = f.logit;
        for (int i = 0; i < 3; ++i) col[j][i] = f.col[i];
      }
    }
    gm = gm > lm[j] ? gm : lm[j];
  }
  if (!(gm > -kBig)) return;
  const float m_new = st.m > gm ? st.m : gm;
  const float dm = st.m - m_new;
  const float scale =
      expf(dm > -kBig * 0.5f ? dm : -kBig * 0.5f) * (st.m > -kBig * 0.5f ? 1.0f : 0.0f);
  float se = 0.0f, sce = 0.0f, sn[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < kGroup; ++j) {
    const float e = cov[j] > kCovMin ? expf(lm[j] - m_new) : 0.0f;
    const float ce = cov[j] * e;
    se += e;
    sce += ce;
    for (int i = 0; i < 3; ++i) sn[i] += ce * col[j][i];
  }
  st.D = st.D * scale + se;
  st.W = st.W * scale + sce;
  for (int i = 0; i < 3; ++i) st.N[i] = st.N[i] * scale + sn[i];
  st.m = m_new;
}

// A chunk's rows into the state, group by group in ascending order; `mask`
// holds the rows that passed the tile's gate (bit i: row i).
PTRE_HD void soft_sweep(const float* rows, const GateBox* boxes, uint64_t mask, float px,
                        float py, const SoftScal<float>& k, SoftState& st, uint32_t& n_eval,
                        uint32_t& n_inc) {
  for (int g = 0; g < kChunk / kGroup; ++g) {
    const unsigned bits = (unsigned)(mask >> (g * kGroup)) & 0xffu;
    if (bits != 0u) {
      soft_group(rows + g * kGroup * kRow, boxes + g * kGroup, bits, px, py, k, st, n_eval,
                 n_inc);
    }
  }
}

// The resolved soft colour of a finished state (soft_raster.py:232-240)
PTRE_HD void soft_color(const SoftState& st, const float* scal, float rgb[3]) {
  const float inv_d = st.D > 0.0f ? 1.0f / st.D : 0.0f;
  const float s = st.W * inv_d;
  const float bg = 1.0f - s > 0.0f ? 1.0f - s : 0.0f;
  for (int i = 0; i < 3; ++i) rgb[i] = st.N[i] * inv_d + bg * scal[9 + i];
}

#ifdef __CUDACC__
// A block's sample tile and this thread's sample: tile (blockIdx.x,
// blockIdx.y) of kTile x kTile window samples; a ragged edge leaves threads
// outside the window (in == false), which still take part in every barrier.
struct BlockTile {
  int x, r;        // this thread's column and window row
  bool in;         // inside the window
  float px, py;    // its sample
  float x_lo, x_hi, y_first, y_last;  // the tile's extent, for chunk_hits
};

__device__ __forceinline__ BlockTile block_tile(const RasterParams& p) {
  BlockTile t;
  t.x = blockIdx.x * kTile + threadIdx.x;
  t.r = blockIdx.y * kTile + threadIdx.y;
  t.in = t.x < p.width_ss && t.r < p.rows_ss;
  t.px = (float)t.x + 0.5f;
  t.py = row_y(p, t.r);
  const int r0 = blockIdx.y * kTile;
  const int r1 = min(r0 + kTile - 1, p.rows_ss - 1);
  t.x_lo = (float)(blockIdx.x * kTile);
  t.x_hi = t.x_lo + (float)kTile;
  t.y_first = row_y(p, r0);
  t.y_last = row_y(p, r1);
  return t;
}

constexpr int kThreads = kTile * kTile;
constexpr unsigned kFull = 0xffffffffu;

// The counters of the kernels' stats instantiations (raster_kernel.STATS,
// soft_raster.STATS), in order: visited (block, chunk) pairs, rows that pass
// a visit's row gate, (sample, row) pairs evaluated (the sample inside the
// row's gate box), and those that count (cover, or pass the coverage
// threshold).
enum : int { kVisits, kRowsPassed, kPairsEvaluated, kPairsCounted };

// The row gate of chunk `rows` for this block's tile: the 64-bit mask of the
// rows that pass (row_hits), their gate boxes (box_of(row)) left in s_box.
// Every thread of the block calls it (two barriers); the first barrier also
// tells that the previous chunk's readers of s_box and s_mask are done.
template <typename BoxOf>
__device__ __forceinline__ uint64_t gate_rows(const float* rows, const BlockTile& t, int tid,
                                              GateBox* s_box, unsigned* s_mask, BoxOf box_of) {
  __syncthreads();
  if (tid < kChunk) {
    const float* c = rows + tid * kRow;
    const GateBox b = box_of(c);
    s_box[tid] = b;
    const unsigned m = __ballot_sync(kFull, row_hits(c, b, t.x_lo, t.x_hi, t.y_first,
                                                     t.y_last));
    if ((tid & 31) == 0) s_mask[tid >> 5] = m;
  }
  __syncthreads();
  return (uint64_t)s_mask[1] << 32 | s_mask[0];
}

// Calls visit(kc) for every chunk whose box passes the tile's gate
// (chunk_hits), ascending. Each warp's lanes test 32 chunks at once and a
// ballot lists the hits; every warp tests the same chunks against the same
// tile, so the list is block-uniform.
template <typename Visit>
__device__ __forceinline__ void for_each_chunk(const RasterParams& p, const float* cbox,
                                               const BlockTile& t, int tid, Visit visit) {
  for (int base = 0; base < p.n_chunks; base += 32) {
    const int kl = base + (tid & 31);
    unsigned hits = __ballot_sync(
        kFull, kl < p.n_chunks &&
                   chunk_hits(cbox + kl * kBoxStride, t.x_lo, t.x_hi, t.y_first, t.y_last));
    for (; hits != 0; hits &= hits - 1) visit(base + __ffs(hits) - 1);
  }
}

// Per-thread counts (evaluated, counted) summed over the warp, then added by
// lane 0 with the block's visits and rows passed (thread 0's).
__device__ __forceinline__ void add_stats(unsigned long long* stats, int tid,
                                          unsigned long long visits,
                                          unsigned long long rows_passed, uint32_t n_eval,
                                          uint32_t n_count) {
  n_eval = __reduce_add_sync(kFull, n_eval);
  n_count = __reduce_add_sync(kFull, n_count);
  if ((tid & 31) != 0) return;
  if (tid == 0) {
    atomicAdd(stats + kVisits, visits);
    atomicAdd(stats + kRowsPassed, rows_passed);
  }
  atomicAdd(stats + kPairsEvaluated, (unsigned long long)n_eval);
  atomicAdd(stats + kPairsCounted, (unsigned long long)n_count);
}

// The C interfaces' argument check (a non-empty window, whole chunks, a
// 16-byte aligned table) and the grid of sample tiles.
inline int check_launch(const RasterParams& p, const float* tris) {
  if (p.rows_ss < 1 || p.width_ss < 1 || p.ss < 1 || p.n_chunks < 1 ||
      reinterpret_cast<uintptr_t>(tris) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

inline dim3 tile_grid(const RasterParams& p) {
  return dim3((p.width_ss + kTile - 1) / kTile, (p.rows_ss + kTile - 1) / kTile);
}
#endif

}  // namespace rast
}  // namespace ptre
