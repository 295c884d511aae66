// Frozen header of the yardsticks in this directory (not the library's):
// csrc/replay.cuh as the first designs here (replay_kernel.cu: replay_fwd_kernel,
// replay_bwd_kernel) were shipped with it. They are built against this
// copy, so a later change to the shipped header shows as a difference from
// them instead of passing by construction. The copies one directory up
// belong to older yardsticks.
//
// The replay chain's bounce and its hand-written adjoint, shared by the
// fused backward kernel and its host build (host_grad.cpp).
//
// chain_bounce is ptre_tpu/ops/pallas/replay_kernel.py _chain_bounce
// (:54-238): one bounce re-derived from the winner's row of the unified
// (P, 27) table. chain_bounce_adjoint is its reverse — on the TPU a jax.vjp
// traced inside the kernel (fused_grad.py:243-255), which has no CUDA
// counterpart. The adjoint is the gradient JAX takes, not the textbook one:
//   * the gradsafe straight-through forms differentiate their stable
//     formula: d inv_det/d det = -1/det^2 where |det| > floor (floor
//     detached), d sq/d delta = 0.5/sqrt(delta) where delta > floor, d rc/d
//     cos_b = -1/cos_b^2 where cos_b > TAU_COS; a tie with the floor gives
//     half (gradsafe.py:101-146);
//   * cos_weight / pdf is detached (cosine_ratio);
//   * a double-where sqrt guard has zero gradient at 0;
//   * a max, min or clip tie sends half the gradient to each side;
//   * `where` routes the gradient to the branch taken: a per-thread `if`
//     here, which never forms the 0 * inf the TPU's guards exist to avoid;
//   * an emissive hit's factor is param * albedo with w_pdf = 1.
// The plain version is ops/cuda/replay_kernel.chain_bounce under torch
// autograd; both are templated on the scalar so that the host check runs
// this code in double against autograd in float64. Every constant is a
// float32 value, as in the plain version.
#pragma once

#include <math.h>
#include <stdint.h>

#include "trace.cuh"

namespace ptre {

constexpr int kRowStride = 27;  // unified-table row (replay_kernel.G_ROWS)

PTRE_HD float sqrt_t(float x) { return sqrtf(x); }
PTRE_HD double sqrt_t(double x) { return sqrt(x); }
PTRE_HD float cos_t(float x) { return cosf(x); }
PTRE_HD double cos_t(double x) { return cos(x); }
PTRE_HD float sin_t(float x) { return sinf(x); }
PTRE_HD double sin_t(double x) { return sin(x); }
PTRE_HD float abs_t(float x) { return fabsf(x); }
PTRE_HD double abs_t(double x) { return fabs(x); }

// d max(x, y) / dx and d min(x, y) / dx, JAX's tie rule (half at a tie)
template <typename T>
PTRE_HD T dmax_dx(T x, T y) {
  return x > y ? T(1) : (x == y ? T(0.5) : T(0));
}
template <typename T>
PTRE_HD T dmin_dx(T x, T y) {
  return x < y ? T(1) : (x == y ? T(0.5) : T(0));
}
template <typename T>
PTRE_HD T clip01(T x) {
  const T m = x > T(0) ? x : T(0);
  return m < T(1) ? m : T(1);
}
// d clip(x, 0, 1) / dx = d min(m, 1)/dm * d max(x, 0)/dx
template <typename T>
PTRE_HD T dclip01(T x) {
  const T m = x > T(0) ? x : T(0);
  return dmin_dx(m, T(1)) * dmax_dx(x, T(0));
}

template <typename T>
struct ChainConsts {
  T t_min, shadow_eps, pdf_eps;
};

template <typename T>
struct ChainConstants {
  static constexpr T kTau = T(6.28318548f);     // float32(2 * 3.14159265358979)
  static constexpr T kInvPi = T(0.318309873f);  // float32(1 / 3.14159265358979)
  static constexpr T kTauCos = T(0.05f);        // gradsafe.TAU_COS
  static constexpr T kTauDet = T(1e-3f);        // gradsafe.TAU_DET
  static constexpr T kTauDelta = T(1e-4f);      // gradsafe.TAU_DELTA
  static constexpr T kTinySq = T(1e-24f);
};

// Every intermediate of one live, hitting, non-emissive bounce that the
// adjoint reads: the forward of such a bounce, computed once.
template <typename T>
struct HitBounce {
  // geometry (triangle or sphere) -> hit point p, final normal n
  T p[3], n[3];
  // triangle
  T e1[3], e2[3], pv[3], tv[3], qv[3], det, det_floor, det_m, inv_det, u, v,
      w, t;
  T in[3], nlen_sq, ninv, tsign;
  // sphere
  T oc[3], halfb, delta, delta_floor, delta_m, sq, t_near, r_safe, sn[3],
      ssign, sr;
  bool near_root;
  // scatter
  T lx, ly, lz, ax, ay, vr[3], vlen_sq, vlen, vinv, vv[3], uu[3], wi[3];
  T ndotwi, pdf, cosw;
  bool degen;
  // Oren-Nayar
  T sigma, s2, a_num, a_den, A, b_num, b_den, Bc;
  T wox, woy, li_sq, li, li_s, lo_sq, lo, lo_s, ci, si, co, so, cos_dphi;
  T x_to, cos_to, cos_ti, cos_a, cos_b, sin_a_sq, sin_a, tan_b_sq, sqb;
  T rc_m, rc, tan_b, m1, m2, coeff, w_pdf;
  bool li_ok, lo_ok;
};

template <typename T>
PTRE_HD void hit_bounce_forward(const T o[3], const T d[3], const T* g,
                                bool use_sph, T u1, T u2,
                                const ChainConsts<T>& k, HitBounce<T>& h) {
  typedef ChainConstants<T> K;
  if (!use_sph) {
    // triangle attrs (intersect.triangle_hit_attrs_t)
    for (int i = 0; i < 3; ++i) {
      h.e1[i] = g[3 + i] - g[i];
      h.e2[i] = g[6 + i] - g[i];
    }
    const T* e1 = h.e1;
    const T* e2 = h.e2;
    h.pv[0] = d[1] * e2[2] - d[2] * e2[1];
    h.pv[1] = d[2] * e2[0] - d[0] * e2[2];
    h.pv[2] = d[0] * e2[1] - d[1] * e2[0];
    h.det = e1[0] * h.pv[0] + e1[1] * h.pv[1] + e1[2] * h.pv[2];
    // gradsafe.stable_inv_det: value 1/det (det == 0 -> 1), gradient of
    // sign / max(|det|, floor)
    const T e1_sq = e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2];
    const T e2_sq = e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2];
    const T prod = e1_sq * e2_sq;
    h.det_floor = K::kTauDet * sqrt_t(prod > K::kTinySq ? prod : K::kTinySq);
    const T sign = h.det < T(0) ? T(-1) : T(1);
    const T fwd = T(1) / (h.det == T(0) ? T(1) : h.det);
    const T adet = abs_t(h.det);
    h.det_m = adet > h.det_floor ? adet : h.det_floor;
    const T stable = sign / h.det_m;
    h.inv_det = stable + (fwd - stable);
    for (int i = 0; i < 3; ++i) h.tv[i] = o[i] - g[i];
    const T* tv = h.tv;
    h.u = (tv[0] * h.pv[0] + tv[1] * h.pv[1] + tv[2] * h.pv[2]) * h.inv_det;
    h.qv[0] = tv[1] * e1[2] - tv[2] * e1[1];
    h.qv[1] = tv[2] * e1[0] - tv[0] * e1[2];
    h.qv[2] = tv[0] * e1[1] - tv[1] * e1[0];
    h.v = (d[0] * h.qv[0] + d[1] * h.qv[1] + d[2] * h.qv[2]) * h.inv_det;
    h.t = (e2[0] * h.qv[0] + e2[1] * h.qv[1] + e2[2] * h.qv[2]) * h.inv_det;
    h.w = T(1) - h.u - h.v;
    for (int i = 0; i < 3; ++i)
      h.in[i] = h.w * g[9 + i] + h.u * g[12 + i] + h.v * g[15 + i];
    h.nlen_sq = h.in[0] * h.in[0] + h.in[1] * h.in[1] + h.in[2] * h.in[2];
    h.ninv = h.nlen_sq > T(0) ? T(1) / sqrt_t(h.nlen_sq) : T(0);
    const T gnx = e1[1] * e2[2] - e1[2] * e2[1];
    const T gny = e1[2] * e2[0] - e1[0] * e2[2];
    const T gnz = e1[0] * e2[1] - e1[1] * e2[0];
    h.tsign = d[0] * gnx + d[1] * gny + d[2] * gnz < T(0) ? T(1) : T(-1);
    for (int i = 0; i < 3; ++i) {
      h.n[i] = h.in[i] * h.ninv * h.tsign;
      h.p[i] = o[i] + h.t * d[i];
    }
  } else {
    // sphere attrs (intersect.sphere_hit_attrs_t)
    h.sr = g[21];
    for (int i = 0; i < 3; ++i) h.oc[i] = g[18 + i] - o[i];
    h.halfb = d[0] * h.oc[0] + d[1] * h.oc[1] + d[2] * h.oc[2];
    const T c_ = h.oc[0] * h.oc[0] + h.oc[1] * h.oc[1] + h.oc[2] * h.oc[2] -
                 h.sr * h.sr;
    h.delta = h.halfb * h.halfb - c_;
    // gradsafe.stable_sqrt_delta
    h.delta_floor = K::kTauDelta * (h.sr * h.sr) + K::kTinySq;
    const bool pos = h.delta > T(0);
    const T fwd = pos ? sqrt_t(h.delta) : T(0);
    h.delta_m = h.delta > h.delta_floor ? h.delta : h.delta_floor;
    const T stable = pos ? sqrt_t(h.delta_m) : T(0);
    h.sq = stable + (fwd - stable);
    h.t_near = h.halfb - h.sq;
    h.near_root = h.t_near >= k.t_min;
    h.t = h.near_root ? h.t_near : h.halfb + h.sq;
    h.r_safe = h.sr > T(0) ? h.sr : T(1);
    for (int i = 0; i < 3; ++i) {
      h.p[i] = o[i] + h.t * d[i];
      h.sn[i] = (h.p[i] - g[18 + i]) / h.r_safe;
    }
    h.ssign = d[0] * h.sn[0] + d[1] * h.sn[1] + d[2] * h.sn[2] < T(0) ? T(1) : T(-1);
    for (int i = 0; i < 3; ++i) h.n[i] = h.sn[i] * h.ssign;
  }
  const T nx = h.n[0], ny = h.n[1], nz = h.n[2];

  // ONB cosine scatter (path_replay._scatter_from_uniforms)
  const T phi = K::kTau * u1;
  const T sr_ = sqrt_t(u2);
  h.lx = cos_t(phi) * sr_;
  h.ly = sin_t(phi) * sr_;
  const T om = T(1) - u2;
  h.lz = sqrt_t(om > T(0) ? om : T(0));
  const bool big_x = abs_t(nx) > T(0.9f);
  h.ax = big_x ? T(0) : T(1);
  h.ay = big_x ? T(1) : T(0);
  h.vr[0] = -nz * h.ay;
  h.vr[1] = nz * h.ax;
  h.vr[2] = nx * h.ay - ny * h.ax;
  h.vlen_sq = h.vr[0] * h.vr[0] + h.vr[1] * h.vr[1] + h.vr[2] * h.vr[2];
  h.vlen = h.vlen_sq > T(0) ? sqrt_t(h.vlen_sq) : T(0);
  h.vinv = T(1) / (h.vlen > T(0) ? h.vlen : T(1));
  for (int i = 0; i < 3; ++i) h.vv[i] = h.vr[i] * h.vinv;
  const T* vv = h.vv;
  h.uu[0] = vv[1] * nz - vv[2] * ny;
  h.uu[1] = vv[2] * nx - vv[0] * nz;
  h.uu[2] = vv[0] * ny - vv[1] * nx;
  for (int i = 0; i < 3; ++i)
    h.wi[i] = h.lx * h.uu[i] + h.ly * vv[i] + h.lz * h.n[i];
  h.ndotwi = nx * h.wi[0] + ny * h.wi[1] + nz * h.wi[2];
  h.pdf = h.ndotwi * K::kInvPi;
  h.degen = h.pdf < k.pdf_eps;
  if (h.degen) {
    for (int i = 0; i < 3; ++i) h.wi[i] = h.n[i];
    h.pdf = K::kInvPi;
    h.ndotwi = T(1);
  }
  h.cosw = h.ndotwi > T(0) ? h.ndotwi : T(0);

  // Oren-Nayar coefficient (path_replay._oren_nayar_coeff)
  const T param = g[26];
  h.sigma = clip01(param);
  h.s2 = h.sigma * h.sigma;
  h.a_num = T(0.5) * h.s2;
  h.a_den = h.s2 + T(0.33f);
  h.A = T(1) - h.a_num / h.a_den;
  h.b_num = T(0.45f) * h.s2;
  h.b_den = h.s2 + T(0.09f);
  h.Bc = h.b_num / h.b_den;
  h.wox = -d[0];
  h.woy = -d[1];
  h.li_sq = h.wi[0] * h.wi[0] + h.wi[1] * h.wi[1];
  h.li = h.li_sq > T(0) ? sqrt_t(h.li_sq) : T(0);
  h.lo_sq = h.wox * h.wox + h.woy * h.woy;
  h.lo = h.lo_sq > T(0) ? sqrt_t(h.lo_sq) : T(0);
  h.li_s = h.li > T(0) ? h.li : T(1);
  h.lo_s = h.lo > T(0) ? h.lo : T(1);
  h.li_ok = h.li > T(1e-12f);
  h.lo_ok = h.lo > T(1e-12f);
  h.ci = h.li_ok ? h.wi[0] / h.li_s : T(1);
  h.si = h.li_ok ? h.wi[1] / h.li_s : T(0);
  h.co = h.lo_ok ? h.wox / h.lo_s : T(1);
  h.so = h.lo_ok ? h.woy / h.lo_s : T(0);
  h.cos_dphi = h.ci * h.co + h.si * h.so;
  h.x_to = -(d[0] * nx + d[1] * ny + d[2] * nz);
  h.cos_to = clip01(h.x_to);
  h.cos_ti = clip01(h.cosw);
  h.cos_a = h.cos_ti < h.cos_to ? h.cos_ti : h.cos_to;
  h.cos_b = h.cos_ti > h.cos_to ? h.cos_ti : h.cos_to;
  const T sa = T(1) - h.cos_a * h.cos_a;
  h.sin_a_sq = sa > T(0) ? sa : T(0);
  h.sin_a = h.sin_a_sq > T(0) ? sqrt_t(h.sin_a_sq) : T(0);
  const T tb = T(1) - h.cos_b * h.cos_b;
  h.tan_b_sq = tb > T(0) ? tb : T(0);
  h.sqb = h.tan_b_sq > T(0) ? sqrt_t(h.tan_b_sq) : T(0);
  // gradsafe.stable_recip_cos
  const T rc_f = T(1) / (h.cos_b > T(1e-6f) ? h.cos_b : T(1e-6f));
  h.rc_m = h.cos_b > K::kTauCos ? h.cos_b : K::kTauCos;
  const T rc_s = T(1) / h.rc_m;
  h.rc = rc_s + (rc_f - rc_s);
  h.tan_b = h.sqb * h.rc;
  h.m1 = h.Bc * h.cos_dphi;
  h.m2 = h.m1 * h.sin_a;
  h.coeff = (h.A + h.m2 * h.tan_b) * K::kInvPi;
  h.w_pdf = h.cosw / h.pdf;  // gradsafe.cosine_ratio: no gradient
}

// Sky factor of a miss on the incoming direction's y (replay_kernel.py:218-221)
template <typename T>
PTRE_HD T sky_a(const T d[3]) {
  return (d[1] + T(1)) * T(0.5);
}

// One bounce forward (replay_kernel._chain_bounce). `g` is read only when
// the bounce is live and hit. Returns next_active.
template <typename T>
PTRE_HD bool chain_bounce(const T o[3], const T d[3], const T c[3],
                          bool active, const T* g, bool use_sph, bool hit,
                          T u1, T u2, const T sky[6], const ChainConsts<T>& k,
                          T o2[3], T d2[3], T c2[3]) {
  for (int i = 0; i < 3; ++i) {
    o2[i] = o[i];
    d2[i] = d[i];
    c2[i] = c[i];
  }
  if (!active) return false;
  if (!hit) {
    const T a = sky_a(d);
    for (int i = 0; i < 3; ++i)
      c2[i] = c[i] * ((T(1) - a) * sky[i] + a * sky[3 + i]);
    return false;
  }
  if (g[22] > T(0.5)) {  // emissive: the terminal factor param * albedo
    for (int i = 0; i < 3; ++i) c2[i] = c[i] * (T(1) * (g[26] * g[23 + i]));
    return false;
  }
  HitBounce<T> h;
  hit_bounce_forward(o, d, g, use_sph, u1, u2, k, h);
  for (int i = 0; i < 3; ++i) {
    c2[i] = c[i] * (h.w_pdf * (g[23 + i] * h.coeff));
    o2[i] = h.p[i] + k.shadow_eps * h.n[i];
    d2[i] = h.wi[i];
  }
  return true;
}

// The adjoint of chain_bounce: given the cotangents (go, gd, gc) of (o2, d2,
// c2), writes those of (o, d, c), the 27 of the row g and the 6 of the sky.
template <typename T>
PTRE_HD void chain_bounce_adjoint(const T o[3], const T d[3], const T c[3],
                                  bool active, const T* g, bool use_sph,
                                  bool hit, T u1, T u2, const T sky[6],
                                  const ChainConsts<T>& k, const T go[3],
                                  const T gd[3], const T gc[3], T dO[3],
                                  T dD[3], T dC[3], T dg[kRowStride],
                                  T dsky[6]) {
  typedef ChainConstants<T> K;
  for (int i = 0; i < kRowStride; ++i) dg[i] = T(0);
  for (int i = 0; i < 6; ++i) dsky[i] = T(0);
  for (int i = 0; i < 3; ++i) {  // o2 = o, d2 = d unless the path goes on
    dO[i] = go[i];
    dD[i] = gd[i];
    dC[i] = gc[i];
  }
  if (!active) return;
  if (!hit) {  // c2 = c * ((1 - a) * bottom + a * top), a = (dy + 1) / 2
    const T a = sky_a(d);
    T da = T(0);
    for (int i = 0; i < 3; ++i) {
      const T f = (T(1) - a) * sky[i] + a * sky[3 + i];
      const T df = gc[i] * c[i];
      dC[i] = gc[i] * f;
      dsky[i] = df * (T(1) - a);
      dsky[3 + i] = df * a;
      da += df * (sky[3 + i] - sky[i]);
    }
    dD[1] += da * T(0.5);
    return;
  }
  const T param = g[26];
  if (g[22] > T(0.5)) {  // emissive: only param and albedo get gradient
    for (int i = 0; i < 3; ++i) {
      const T df = gc[i] * c[i];
      dC[i] = gc[i] * (T(1) * (param * g[23 + i]));
      dg[23 + i] = df * param;
      dg[26] += df * g[23 + i];
    }
    return;
  }

  HitBounce<T> h;
  hit_bounce_forward(o, d, g, use_sph, u1, u2, k, h);
  const T* n = h.n;

  // c2 = c * w_pdf * (albedo * coeff); o2 = p + eps * n; d2 = wi
  T dcoeff = T(0);
  T dP[3], dN[3], dWi[3], dDir[3];
  for (int i = 0; i < 3; ++i) {
    const T alb = g[23 + i];
    dC[i] = gc[i] * (h.w_pdf * (alb * h.coeff));
    const T datt = gc[i] * c[i] * h.w_pdf;
    dg[23 + i] = datt * h.coeff;
    dcoeff += datt * alb;
    dP[i] = go[i];
    dN[i] = k.shadow_eps * go[i];
    dWi[i] = gd[i];
    dDir[i] = T(0);
    dO[i] = T(0);
  }

  // coeff = (A + ((B * cos_dphi) * sin_a) * tan_b) / pi
  const T dsum = dcoeff * K::kInvPi;
  const T dA = dsum;
  const T dm2 = dsum * h.tan_b;
  const T dtan_b = dsum * h.m2;
  const T dm1 = dm2 * h.sin_a;
  const T dsin_a = dm2 * h.m1;
  const T dBc = dm1 * h.cos_dphi;
  const T dcos_dphi = dm1 * h.Bc;
  // tan_b = sqrt-guard(tan_b_sq) * stable_recip_cos(cos_b)
  const T dsqb = dtan_b * h.rc;
  const T drc = dtan_b * h.sqb;
  T dcos_b = -drc / (h.rc_m * h.rc_m) * dmax_dx(h.cos_b, K::kTauCos);
  if (h.tan_b_sq > T(0)) dcos_b -= T(2) * h.cos_b * (dsqb * T(0.5) / h.sqb);
  T dcos_a = T(0);
  if (h.sin_a_sq > T(0)) dcos_a -= T(2) * h.cos_a * (dsin_a * T(0.5) / h.sin_a);
  // cos_a = min(cos_ti, cos_to), cos_b = max(cos_ti, cos_to)
  const T dcos_ti = dcos_a * dmin_dx(h.cos_ti, h.cos_to) +
                    dcos_b * dmax_dx(h.cos_ti, h.cos_to);
  const T dcos_to = dcos_a * dmin_dx(h.cos_to, h.cos_ti) +
                    dcos_b * dmax_dx(h.cos_to, h.cos_ti);
  const T dcosw = dcos_ti * dclip01(h.cosw);
  // cos_to = clip(-(d . n), 0, 1)
  const T ddn = -(dcos_to * dclip01(h.x_to));
  for (int i = 0; i < 3; ++i) {
    dDir[i] += ddn * n[i];
    dN[i] += ddn * d[i];
  }
  // cos_dphi = ci * co + si * so over the projected wi and wo = -d
  const T dci = dcos_dphi * h.co, dco = dcos_dphi * h.ci;
  const T dsi = dcos_dphi * h.so, dso = dcos_dphi * h.si;
  if (h.li_ok) {
    dWi[0] += dci / h.li_s;
    dWi[1] += dsi / h.li_s;
    const T dli = -(dci * h.wi[0] + dsi * h.wi[1]) / (h.li_s * h.li_s);
    if (h.li_sq > T(0)) {
      const T dlsq = dli * T(0.5) / h.li;
      dWi[0] += T(2) * h.wi[0] * dlsq;
      dWi[1] += T(2) * h.wi[1] * dlsq;
    }
  }
  if (h.lo_ok) {
    T dwox = dco / h.lo_s, dwoy = dso / h.lo_s;
    const T dlo = -(dco * h.wox + dso * h.woy) / (h.lo_s * h.lo_s);
    if (h.lo_sq > T(0)) {
      const T dlsq = dlo * T(0.5) / h.lo;
      dwox += T(2) * h.wox * dlsq;
      dwoy += T(2) * h.woy * dlsq;
    }
    dDir[0] -= dwox;
    dDir[1] -= dwoy;
  }
  // A = 1 - (0.5 s2) / (s2 + 0.33), B = (0.45 s2) / (s2 + 0.09), s2 = sigma^2
  T ds2 = T(0);
  {
    const T dq = -dA;
    ds2 += T(0.5) * (dq / h.a_den) - dq * h.a_num / (h.a_den * h.a_den);
    ds2 += T(0.45f) * (dBc / h.b_den) - dBc * h.b_num / (h.b_den * h.b_den);
  }
  dg[26] += T(2) * h.sigma * ds2 * dclip01(param);

  // scatter: wi = degen ? n : lx u + ly v + lz n, cosw = max(0, n . wi)
  if (h.degen) {
    for (int i = 0; i < 3; ++i) dN[i] += dWi[i];
  } else {
    const T dndotwi = dcosw * dmax_dx(h.ndotwi, T(0));
    for (int i = 0; i < 3; ++i) {
      dN[i] += dndotwi * h.wi[i];
      dWi[i] += dndotwi * n[i];
    }
    T du[3], dv[3];
    for (int i = 0; i < 3; ++i) {
      du[i] = dWi[i] * h.lx;
      dv[i] = dWi[i] * h.ly;
      dN[i] += dWi[i] * h.lz;
    }
    // u = v x n
    const T* vv = h.vv;
    dv[0] += -du[1] * n[2] + du[2] * n[1];
    dv[1] += du[0] * n[2] - du[2] * n[0];
    dv[2] += -du[0] * n[1] + du[1] * n[0];
    dN[0] += du[1] * vv[2] - du[2] * vv[1];
    dN[1] += -du[0] * vv[2] + du[2] * vv[0];
    dN[2] += du[0] * vv[1] - du[1] * vv[0];
    // v = vr * vinv, vinv = 1 / guard(|vr|)
    T dvr[3];
    T dvinv = T(0);
    for (int i = 0; i < 3; ++i) {
      dvr[i] = dv[i] * h.vinv;
      dvinv += dv[i] * h.vr[i];
    }
    if (h.vlen > T(0)) {
      const T dvlen = -dvinv / (h.vlen * h.vlen);
      const T dvsq = dvlen * T(0.5) / h.vlen;
      for (int i = 0; i < 3; ++i) dvr[i] += T(2) * h.vr[i] * dvsq;
    }
    // vr = (-nz ay, nz ax, nx ay - ny ax)
    dN[2] += -dvr[0] * h.ay + dvr[1] * h.ax;
    dN[0] += dvr[2] * h.ay;
    dN[1] -= dvr[2] * h.ax;
  }

  if (!use_sph) {
    // n = in * ninv * tsign, in = w n0 + u n1 + v n2
    T din[3];
    T dninv = T(0);
    for (int i = 0; i < 3; ++i) {
      const T dtn = dN[i] * h.tsign;
      din[i] = dtn * h.ninv;
      dninv += dtn * h.in[i];
    }
    if (h.nlen_sq > T(0)) {
      const T s = sqrt_t(h.nlen_sq);
      const T dnsq = (-dninv / (s * s)) * T(0.5) / s;
      for (int i = 0; i < 3; ++i) din[i] += T(2) * h.in[i] * dnsq;
    }
    T dw = T(0), du_ = T(0), dv_ = T(0);
    for (int i = 0; i < 3; ++i) {
      dw += din[i] * g[9 + i];
      du_ += din[i] * g[12 + i];
      dv_ += din[i] * g[15 + i];
      dg[9 + i] = din[i] * h.w;
      dg[12 + i] = din[i] * h.u;
      dg[15 + i] = din[i] * h.v;
    }
    du_ -= dw;
    dv_ -= dw;
    // p = o + t d
    T dt = T(0);
    for (int i = 0; i < 3; ++i) {
      dO[i] += dP[i];
      dt += dP[i] * d[i];
      dDir[i] += dP[i] * h.t;
    }
    const T* e1 = h.e1;
    const T* e2 = h.e2;
    const T* pv = h.pv;
    const T* tv = h.tv;
    const T* qv = h.qv;
    // t = (e2 . qv) inv_det, v = (d . qv) inv_det, u = (tv . pv) inv_det
    T de1[3], de2[3], dqv[3], dpv[3], dtv[3];
    const T dts = dt * h.inv_det, dvs = dv_ * h.inv_det, dus = du_ * h.inv_det;
    const T dinv =
        dt * (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) +
        dv_ * (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) +
        du_ * (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]);
    for (int i = 0; i < 3; ++i) {
      de2[i] = dts * qv[i];
      dqv[i] = dts * e2[i] + dvs * d[i];
      dDir[i] += dvs * qv[i];
      dtv[i] = dus * pv[i];
      dpv[i] = dus * tv[i];
    }
    // inv_det: gradient of sign / max(|det|, floor)
    const T ddet = h.det == T(0) ? T(0)
                                 : -dinv / (h.det_m * h.det_m) *
                                       dmax_dx(abs_t(h.det), h.det_floor);
    for (int i = 0; i < 3; ++i) {
      de1[i] = ddet * pv[i];
      dpv[i] += ddet * e1[i];
    }
    // qv = tv x e1
    dtv[0] += e1[1] * dqv[2] - e1[2] * dqv[1];
    dtv[1] += e1[2] * dqv[0] - e1[0] * dqv[2];
    dtv[2] += e1[0] * dqv[1] - e1[1] * dqv[0];
    de1[0] += dqv[1] * tv[2] - dqv[2] * tv[1];
    de1[1] += dqv[2] * tv[0] - dqv[0] * tv[2];
    de1[2] += dqv[0] * tv[1] - dqv[1] * tv[0];
    // pv = d x e2
    dDir[0] += e2[1] * dpv[2] - e2[2] * dpv[1];
    dDir[1] += e2[2] * dpv[0] - e2[0] * dpv[2];
    dDir[2] += e2[0] * dpv[1] - e2[1] * dpv[0];
    de2[0] += dpv[1] * d[2] - dpv[2] * d[1];
    de2[1] += dpv[2] * d[0] - dpv[0] * d[2];
    de2[2] += dpv[0] * d[1] - dpv[1] * d[0];
    // tv = o - v0, e1 = v1 - v0, e2 = v2 - v0
    for (int i = 0; i < 3; ++i) {
      dO[i] += dtv[i];
      dg[i] = -dtv[i] - de1[i] - de2[i];
      dg[3 + i] = de1[i];
      dg[6 + i] = de2[i];
    }
  } else {
    // n = ((p - c) / r_safe) * ssign
    T dsr = T(0), dsc[3], dps[3];
    T dsn_dot = T(0);
    for (int i = 0; i < 3; ++i) {
      const T dsn = dN[i] * h.ssign;
      dps[i] = dP[i] + dsn / h.r_safe;
      dsc[i] = -(dsn / h.r_safe);
      dsn_dot += dsn * (h.p[i] - g[18 + i]);
    }
    if (h.sr > T(0)) dsr -= dsn_dot / (h.r_safe * h.r_safe);
    // p = o + t d
    T dt = T(0);
    for (int i = 0; i < 3; ++i) {
      dO[i] += dps[i];
      dt += dps[i] * d[i];
      dDir[i] += dps[i] * h.t;
    }
    // t = t_near >= t_min ? halfb - sq : halfb + sq
    const T dhalfb0 = dt;
    const T dsq = h.near_root ? -dt : dt;
    T ddelta = T(0);
    if (h.delta > T(0))
      ddelta = dsq * T(0.5) / sqrt_t(h.delta_m) *
               dmax_dx(h.delta, h.delta_floor);
    // delta = halfb^2 - (|oc|^2 - r^2), halfb = d . oc, oc = c - o
    const T dhalfb = dhalfb0 + T(2) * h.halfb * ddelta;
    const T dc_ = -ddelta;
    dsr -= T(2) * h.sr * dc_;
    for (int i = 0; i < 3; ++i) {
      const T doc = T(2) * h.oc[i] * dc_ + dhalfb * d[i];
      dDir[i] += dhalfb * h.oc[i];
      dsc[i] += doc;
      dO[i] -= doc;
      dg[18 + i] = dsc[i];
    }
    dg[21] = dsr;
  }
  for (int i = 0; i < 3; ++i) dD[i] = dDir[i];
}

// Table sources of ray_forward / ray_backward: `row(idx, b, buf)` gives the
// 27 values of table row idx, the winner of bounce b, in place or copied
// into `buf`. PointerTable: a table the thread addresses directly (shared
// memory, or host memory in the host build), read in place; the bounce is
// not needed.
struct PointerTable {
  const float* rows;  // (n_rows, 27)
  PTRE_HD const float* row(int idx, int, float*) const {
    return rows + idx * kRowStride;
  }
};

// PaddedTable: a (n_rows, kPadStride) copy of the table whose column 27 is
// 0, so that a row is 112 bytes, 16-byte aligned: on the card one row is
// seven 16-byte loads through the read-only path into `buf`.
constexpr int kPadStride = 28;
struct PaddedTable {
  const float* rows;  // (n_rows, kPadStride)
  PTRE_HD const float* row(int idx, int, float* buf) const {
    const float* src = rows + (int64_t)idx * kPadStride;
#ifdef __CUDA_ARCH__
    const float4* q = reinterpret_cast<const float4*>(src);
    for (int i = 0; i < 6; ++i) {
      const float4 w = __ldg(q + i);
      buf[4 * i] = w.x;
      buf[4 * i + 1] = w.y;
      buf[4 * i + 2] = w.z;
      buf[4 * i + 3] = w.w;
    }
    const float4 w = __ldg(q + 6);
    buf[24] = w.x;
    buf[25] = w.y;
    buf[26] = w.z;
#else
    for (int i = 0; i < kRowStride; ++i) buf[i] = src[i];
#endif
    return buf;
  }
};

// The summing step of fused_grad_kernel.cu's row-grouped accumulation, the
// same code in the kernel and its host build (host_grad.cpp). A grouped
// lane puts its row cotangent into row `lane` of its warp's (32,
// kPadStride) slice `red` (column 27 is 0); columns 4q .. 4q + 3 of a
// group's sum are then the rows of the lanes in `group` added from 0,
// lowest lane first.
PTRE_HD int lowest_lane(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

PTRE_HD void put_group_row(float* red, int lane, const float v[kRowStride]) {
  float* dst = red + lane * kPadStride;
#ifdef __CUDA_ARCH__
  float4* q = reinterpret_cast<float4*>(dst);
  for (int i = 0; i < 6; ++i) q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  q[6] = make_float4(v[24], v[25], v[26], 0.0f);
#else
  for (int i = 0; i < kRowStride; ++i) dst[i] = v[i];
  dst[kRowStride] = 0.0f;
#endif
}

PTRE_HD void group_sum4(const float* red, unsigned group, int q, float s[4]) {
  s[0] = s[1] = s[2] = s[3] = 0.0f;
  for (unsigned m = group; m != 0u; m &= m - 1u) {
    const float* row = red + lowest_lane(m) * kPadStride + 4 * q;
#ifdef __CUDA_ARCH__
    const float4 v = *reinterpret_cast<const float4*>(row);
    s[0] += v.x;
    s[1] += v.y;
    s[2] += v.z;
    s[3] += v.w;
#else
    for (int j = 0; j < 4; ++j) s[j] += row[j];
#endif
  }
}

// GatheredRows: the winners' rows gathered outside the kernel, (B, R, 27):
// ray `ray`'s row of bounce b, whatever its index (the replay kernels,
// replay_kernel.py _split_inputs). The row index only says which class was
// hit (idx >= sph_offset) and whether anything was (idx >= 0).
template <typename T>
struct GatheredRows {
  const T* g;  // (B, n_rays, 27)
  int64_t ray, n_rays;
  PTRE_HD const T* row(int, int b, T*) const {
    return g + ((int64_t)b * n_rays + ray) * kRowStride;
  }
};

// Accumulator of ray_backward that writes ray `ray`'s row cotangent of each
// bounce into d(g) (B, R, 27), in place of adding it into d(table): the
// gather's own backward sums them into d(table) outside (replay_kernel.py
// _bwd_kernel's dg rows). A bounce that was not live or did not hit writes
// zeros, so nothing but zeros reaches the gather's backward from it.
template <typename T>
struct GatheredRowsGrad {
  T* dg;  // (B, n_rays, 27)
  int64_t ray, n_rays;
  PTRE_HD void add_row(int idx, int b, const T v[kRowStride]) const {
    T* dst = dg + ((int64_t)b * n_rays + ray) * kRowStride;
    for (int i = 0; i < kRowStride; ++i) dst[i] = idx >= 0 ? v[i] : T(0);
  }
};

// The chain's state entering one bounce: what ray_backward keeps of the
// forward to reverse that bounce (fused_grad.py:227-236).
template <typename T>
struct BounceState {
  T o[3], d[3], c[3], u[2];
  int idx;
  bool act;
};

// Where ray_forward keeps the state entering each bounce and ray_backward
// reads it back: `store(b, ...)` in the forward, `load(b)` in reverse.
// LocalStates: the thread's own array of kMaxDepth states (indexed by the
// runtime bounce, so it lives in the stack frame).
template <typename T>
struct LocalStates {
  BounceState<T> st[kMaxDepth];
  PTRE_HD void store(int b, const T o[3], const T d[3], const T c[3], float u1,
                     float u2, int idx, bool act) {
    BounceState<T>& s = st[b];
    for (int i = 0; i < 3; ++i) {
      s.o[i] = o[i];
      s.d[i] = d[i];
      s.c[i] = c[i];
    }
    s.u[0] = T(u1);
    s.u[1] = T(u2);
    s.idx = idx;
    s.act = act;
  }
  PTRE_HD BounceState<T> load(int b) const { return st[b]; }
};

// StridedStates: the float32 fields o, d, c, u of each bounce in a
// [bounce][field][thread] slice (thread t's field f of bounce b at
// base[(b * kStateFields + f) * stride], base = slice + t: a block's threads
// store and load neighbouring words); the row index read again from the
// selections as ray_forward read it, `act` one bit a bounce in a register.
constexpr int kStateFields = 11;
struct StridedStates {
  float* base;
  int stride;
  const int32_t* sel;  // the ray's selections, bounce b at sel[b * sel_stride]
  int64_t sel_stride;
  int n_rows;
  bool valid;
  unsigned act_bits;

  PTRE_HD void store(int b, const float o[3], const float d[3],
                     const float c[3], float u1, float u2, int, bool act) {
    float* f = base + (int64_t)b * kStateFields * stride;
    for (int i = 0; i < 3; ++i) {
      f[i * stride] = o[i];
      f[(3 + i) * stride] = d[i];
      f[(6 + i) * stride] = c[i];
    }
    f[9 * stride] = u1;
    f[10 * stride] = u2;
    act_bits = (act_bits & ~(1u << b)) | ((act ? 1u : 0u) << b);
  }
  PTRE_HD BounceState<float> load(int b) const {
    const float* f = base + (int64_t)b * kStateFields * stride;
    BounceState<float> s;
    for (int i = 0; i < 3; ++i) {
      s.o[i] = f[i * stride];
      s.d[i] = f[(3 + i) * stride];
      s.c[i] = f[(6 + i) * stride];
    }
    s.u[0] = f[9 * stride];
    s.u[1] = f[10 * stride];
    int idx = valid ? sel[b * sel_stride] : -1;
    if (idx >= n_rows) idx = -1;  // as ray_forward
    s.idx = idx;
    s.act = ((act_bits >> b) & 1u) != 0u;
    return s;
  }
};

// The whole chain of one ray from its primary ray (replay_kernel._chain,
// :241): max_depth bounces over the recorded selections `sel` (bounce b at
// sel[b * sel_stride]; -1 where nothing was hit or the path had ended) ->
// the colour. With `saved` (LocalStates or StridedStates) it keeps the
// state entering each bounce. Uniforms are those the recording forward drew:
// the external rows, or Philox regenerated from (seed, ray, sample, draw).
template <typename T, class Table, class Uniforms, class Saved>
PTRE_HD void ray_forward(int max_depth, int sph_offset, int n_rows,
                         const Table& table, const T sky[6],
                         const ChainConsts<T>& k, bool valid, const T o[3],
                         const T d[3], const int32_t* sel, int64_t sel_stride,
                         Uniforms& un, T color[3], Saved* saved) {
  T O[3], D[3], C[3] = {T(1), T(1), T(1)};
  for (int i = 0; i < 3; ++i) {
    O[i] = valid ? o[i] : T(0);
    D[i] = valid ? d[i] : T(0);
  }
  bool act = valid;
  for (int b = 0; b < max_depth; ++b) {
    int idx = valid ? sel[b * sel_stride] : -1;
    if (idx >= n_rows) idx = -1;  // never read outside the table
    float u1 = 0.0f, u2 = 0.0f;
    if (act) un.pair(1 + b, &u1, &u2);
    if (saved != nullptr) saved->store(b, O, D, C, u1, u2, idx, act);
    T row[kRowStride];
    const T* g = idx >= 0 ? table.row(idx, b, row) : nullptr;
    T O2[3], D2[3], C2[3];
    act = chain_bounce(O, D, C, act, g, idx >= sph_offset, idx >= 0, T(u1),
                       T(u2), sky, k, O2, D2, C2);
    for (int i = 0; i < 3; ++i) {
      O[i] = O2[i];
      D[i] = D2[i];
      C[i] = C2[i];
    }
  }
  for (int i = 0; i < 3; ++i) color[i] = C[i];
}

// The whole backward of one ray (fused_grad._fused_bwd_kernel per lane, and
// replay_kernel._bwd_kernel's in-kernel vjp): recompute the chain forward
// (ray_forward), keeping the state at each bounce boundary in `saved`, then
// reverse the bounces from the last to the first. `acc.add_row(idx, b, dg)`
// receives every bounce's row cotangent — called the same number of times
// by every thread, with idx = -1 where nothing was hit, so a warp-level
// accumulator may synchronise inside it.
template <typename T, class Table, class Uniforms, class Acc, class Saved>
PTRE_HD void ray_backward(int max_depth, int sph_offset, int n_rows,
                          const Table& table, const T sky[6],
                          const ChainConsts<T>& k, bool valid, const T o[3],
                          const T d[3], const int32_t* sel, int64_t sel_stride,
                          Uniforms& un, const T dcol[3], T d_o[3], T d_d[3],
                          T dsky[6], Acc& acc, Saved& saved) {
  T color[3];
  ray_forward(max_depth, sph_offset, n_rows, table, sky, k, valid, o, d, sel,
              sel_stride, un, color, &saved);
  T gO[3] = {T(0), T(0), T(0)}, gD[3] = {T(0), T(0), T(0)}, gC[3];
  for (int i = 0; i < 3; ++i) gC[i] = valid ? dcol[i] : T(0);
  for (int b = max_depth - 1; b >= 0; --b) {
    const BounceState<T> s = saved.load(b);
    T row[kRowStride];
    const T* g = s.idx >= 0 ? table.row(s.idx, b, row) : nullptr;
    T dO[3], dD[3], dC[3], dg[kRowStride], ds[6];
    chain_bounce_adjoint(s.o, s.d, s.c, s.act, g, s.idx >= sph_offset,
                         s.idx >= 0, s.u[0], s.u[1], sky, k, gO, gD, gC, dO,
                         dD, dC, dg, ds);
    for (int i = 0; i < 3; ++i) {
      gO[i] = dO[i];
      gD[i] = dD[i];
      gC[i] = dC[i];
    }
    for (int i = 0; i < 6; ++i) dsky[i] += ds[i];
    acc.add_row(s.idx, b, dg);
  }
  for (int i = 0; i < 3; ++i) {
    d_o[i] = gO[i];
    d_d[i] = gD[i];
  }
}

// ray_backward with the states in the thread's own LocalStates.
template <typename T, class Table, class Uniforms, class Acc>
PTRE_HD void ray_backward(int max_depth, int sph_offset, int n_rows,
                          const Table& table, const T sky[6],
                          const ChainConsts<T>& k, bool valid, const T o[3],
                          const T d[3], const int32_t* sel, int64_t sel_stride,
                          Uniforms& un, const T dcol[3], T d_o[3], T d_d[3],
                          T dsky[6], Acc& acc) {
  LocalStates<T> saved;
  ray_backward(max_depth, sph_offset, n_rows, table, sky, k, valid, o, d, sel,
               sel_stride, un, dcol, d_o, d_d, dsky, acc, saved);
}

// The replay pair's per-ray bodies (replay_kernel.cu's kernels, and
// host_replay.cpp's loops): ray `ray` of R rays over the gathered rows g
// (B, R, 27), with the uniform source the params select. p.n_rows bounds
// the selections only: every row index addresses g by (bounce, ray).
// Forward: colour (R, 3). Backward: d(o), d(d) (R, 3), the ray's d(g) rows,
// and its d(sky) added into dsky.
template <typename T>
PTRE_HD void replay_ray_forward(const TraceParams& p, const T* g,
                                const T sky[6], const T* o, const T* d,
                                const int32_t* sel, const float* urand,
                                int64_t ray, T* color) {
  const ChainConsts<T> k = {T(p.t_min), T(p.shadow_eps), T(p.pdf_eps)};
  const GatheredRows<T> rows = {g, ray, p.n_rays};
  LocalStates<T>* none = nullptr;
  if (p.external_rng) {
    ExternalUniforms un = {urand, ray, p.n_rays};
    ray_forward(p.max_depth, p.sph_offset, p.n_rows, rows, sky, k, true,
                o + 3 * ray, d + 3 * ray, sel + ray, p.n_rays, un,
                color + 3 * ray, none);
  } else {
    PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)ray, p.sample);
    ray_forward(p.max_depth, p.sph_offset, p.n_rows, rows, sky, k, true,
                o + 3 * ray, d + 3 * ray, sel + ray, p.n_rays, un,
                color + 3 * ray, none);
  }
}

template <typename T>
PTRE_HD void replay_ray_backward(const TraceParams& p, const T* g,
                                 const T sky[6], const T* o, const T* d,
                                 const int32_t* sel, const float* urand,
                                 const T* dcol, int64_t ray, T* d_o, T* d_d,
                                 T* d_g, T dsky[6]) {
  const ChainConsts<T> k = {T(p.t_min), T(p.shadow_eps), T(p.pdf_eps)};
  const GatheredRows<T> rows = {g, ray, p.n_rays};
  GatheredRowsGrad<T> acc = {d_g, ray, p.n_rays};
  const int64_t v = 3 * ray;
  if (p.external_rng) {
    ExternalUniforms un = {urand, ray, p.n_rays};
    ray_backward(p.max_depth, p.sph_offset, p.n_rows, rows, sky, k, true,
                 o + v, d + v, sel + ray, p.n_rays, un, dcol + v, d_o + v,
                 d_d + v, dsky, acc);
  } else {
    PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)ray, p.sample);
    ray_backward(p.max_depth, p.sph_offset, p.n_rows, rows, sky, k, true,
                 o + v, d + v, sel + ray, p.n_rays, un, dcol + v, d_o + v,
                 d_d + v, dsky, acc);
  }
}

}  // namespace ptre
