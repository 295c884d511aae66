// Host build of the gradient kernels' per-ray code, for checks on machines
// without a GPU: the chain bounce and its hand-written adjoint (replay.cuh)
// in float and in double, the recording trace (trace.cuh record_ray) and the
// fused backward of one ray (replay.cuh ray_backward), looped over a batch.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_grad_host.so host_grad.cpp
//
// tests/test_torch_csrc_grad_host.py builds it this way and holds it against
// the plain PyTorch versions.

#include "replay.cuh"
#include "trace.cuh"

namespace {

// Batch layout: o, d, c, go, gd, gc (n, 3); active, use_sph, hit (n) int32;
// g (n, 27); u (n, 2); sky (6); consts (t_min, shadow_eps, pdf_eps).
// Out: o2, d2, c2, dO, dD, dC (n, 3); next_active (n) int32; dg (n, 27);
// dsky (n, 6).
template <typename T>
void chain_batch(int n, const T* o, const T* d, const T* c,
                 const int32_t* active, const T* g, const int32_t* use_sph,
                 const int32_t* hit, const T* u, const T* sky, const T* consts,
                 const T* go, const T* gd, const T* gc, T* o2, T* d2, T* c2,
                 int32_t* next_active, T* dO, T* dD, T* dC, T* dg, T* dsky) {
  const ptre::ChainConsts<T> k = {consts[0], consts[1], consts[2]};
  for (int r = 0; r < n; ++r) {
    const int v = 3 * r;
    const T* gr = g + ptre::kRowStride * r;
    next_active[r] = ptre::chain_bounce(
        o + v, d + v, c + v, active[r] != 0, gr, use_sph[r] != 0, hit[r] != 0,
        u[2 * r], u[2 * r + 1], sky, k, o2 + v, d2 + v, c2 + v);
    ptre::chain_bounce_adjoint(o + v, d + v, c + v, active[r] != 0, gr,
                               use_sph[r] != 0, hit[r] != 0, u[2 * r],
                               u[2 * r + 1], sky, k, go + v, gd + v, gc + v,
                               dO + v, dD + v, dC + v,
                               dg + ptre::kRowStride * r, dsky + 6 * r);
  }
}

// Adds every row cotangent straight into the (n_rows, 27) table gradient.
struct HostRowAccumulator {
  float* dtable;
  void add_row(int idx, const float dg[ptre::kRowStride]) {
    if (idx < 0) return;
    for (int i = 0; i < ptre::kRowStride; ++i)
      dtable[idx * ptre::kRowStride + i] += dg[i];
  }
};

}  // namespace

extern "C" void ptre_chain_host_f(int n, const float* o, const float* d,
                                  const float* c, const int32_t* active,
                                  const float* g, const int32_t* use_sph,
                                  const int32_t* hit, const float* u,
                                  const float* sky, const float* consts,
                                  const float* go, const float* gd,
                                  const float* gc, float* o2, float* d2,
                                  float* c2, int32_t* next_active, float* dO,
                                  float* dD, float* dC, float* dg,
                                  float* dsky) {
  chain_batch(n, o, d, c, active, g, use_sph, hit, u, sky, consts, go, gd, gc,
              o2, d2, c2, next_active, dO, dD, dC, dg, dsky);
}

extern "C" void ptre_chain_host_d(int n, const double* o, const double* d,
                                  const double* c, const int32_t* active,
                                  const double* g, const int32_t* use_sph,
                                  const int32_t* hit, const double* u,
                                  const double* sky, const double* consts,
                                  const double* go, const double* gd,
                                  const double* gc, double* o2, double* d2,
                                  double* c2, int32_t* next_active, double* dO,
                                  double* dD, double* dC, double* dg,
                                  double* dsky) {
  chain_batch(n, o, d, c, active, g, use_sph, hit, u, sky, consts, go, gd, gc,
              o2, d2, c2, next_active, dO, dD, dC, dg, dsky);
}

// record_kernel.cu's per-thread body over every ray.
extern "C" void ptre_trace_record_host(const ptre::TraceParams* params,
                                       const float* o, const float* d,
                                       const float* urand, const float* tris,
                                       const float* sphs, const float* mats,
                                       const float* sky, float* color,
                                       int32_t* sel) {
  const ptre::TraceParams& p = *params;
  const ptre::SceneTables sc = {tris, sphs, mats, sky,
                                p.n_tri, p.n_sph, p.num_mats};
  for (int64_t ray = 0; ray < p.n_rays; ++ray)
    ptre::record_ray(p, sc, ray, o, d, urand, color, sel);
}

// fused_grad_kernel.cu's per-thread body over every ray; dtable (n_rows, 27)
// and dsky (6) are accumulated into (the caller zeroes them).
extern "C" void ptre_fused_bwd_host(const ptre::TraceParams* params,
                                    const float* table, const float* sky,
                                    const float* o, const float* d,
                                    const int32_t* sel, const float* urand,
                                    const float* dcol, float* d_o, float* d_d,
                                    float* dtable, float* dsky) {
  const ptre::TraceParams& p = *params;
  const ptre::ChainConsts<float> k = {p.t_min, p.shadow_eps, p.pdf_eps};
  HostRowAccumulator acc = {dtable};
  const ptre::PointerTable tab = {table};
  for (int64_t r = 0; r < p.n_rays; ++r) {
    if (p.external_rng) {
      ptre::ExternalUniforms un = {urand, r, p.n_rays};
      ptre::ray_backward(p.max_depth, p.sph_offset, p.n_rows, tab, sky, k,
                         true, o + 3 * r, d + 3 * r, sel + r, p.n_rays, un,
                         dcol + 3 * r, d_o + 3 * r, d_d + 3 * r, dsky, acc);
    } else {
      ptre::PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)r, p.sample);
      ptre::ray_backward(p.max_depth, p.sph_offset, p.n_rows, tab, sky, k,
                         true, o + 3 * r, d + 3 * r, sel + r, p.n_rays, un,
                         dcol + 3 * r, d_o + 3 * r, d_d + 3 * r, dsky, acc);
    }
  }
}
