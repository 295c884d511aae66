// Host build of the gradient kernels' per-ray code, for checks on machines
// without a GPU: the chain bounce and its hand-written adjoint (replay.cuh)
// in float and in double, the recording trace (trace.cuh RecordJob through
// host_dense, the recording kernel's warp scheduler), the
// fused backward of one ray (replay.cuh ray_backward) as fused_grad_kernel.cu
// runs it — its states in a [bounce][field][thread] slice (StridedStates),
// its table in place (PointerTable, the dense instantiation) or padded to
// 28 columns (PaddedTable, the global one) — looped over a batch, and the
// kernel's row-grouped accumulation replayed warp by warp with its own
// summing code (replay.cuh put_group_row, group_sum4).
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_grad_host.so host_grad.cpp
//
// tests/test_torch_csrc_grad_host.py builds it this way and holds it against
// the plain PyTorch versions.

#include <vector>

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

// Adds every row cotangent straight into the (n_rows, stride) table
// gradient.
struct HostRowAccumulator {
  float* dtable;
  int stride;
  void add_row(int idx, int, const float dg[ptre::kRowStride]) {
    if (idx < 0) return;
    for (int i = 0; i < ptre::kRowStride; ++i) dtable[idx * stride + i] += dg[i];
  }
};

constexpr int kWarp = 32;
constexpr int kSlice = 256;  // fused_grad_kernel.cu kBwdBlock: the states' thread stride

// One ray of fused_grad_kernel.cu's backward_rays on the host: states in a
// kSlice-thread StridedStates slice at thread r % kSlice.
template <class Table, class Uniforms>
void host_ray(const ptre::TraceParams& p, const Table& tab, const float* sky,
              const ptre::ChainConsts<float>& k, int64_t r, const float* o,
              const float* d, const int32_t* sel, Uniforms& un,
              const float* dcol, float* d_o, float* d_d, float* dsky,
              HostRowAccumulator& acc, std::vector<float>& slice) {
  ptre::StridedStates st = {slice.data() + r % kSlice, kSlice, sel + r,
                            p.n_rays, p.n_rows, true, 0u};
  ptre::ray_backward(p.max_depth, p.sph_offset, p.n_rows, tab, sky, k, true,
                     o + 3 * r, d + 3 * r, sel + r, p.n_rays, un, dcol + 3 * r,
                     d_o + 3 * r, d_d + 3 * r, dsky, acc, st);
}

template <class Table>
void host_fused_bwd(const ptre::TraceParams& p, const Table& tab,
                    const float* sky, const float* o, const float* d,
                    const int32_t* sel, const float* urand, const float* dcol,
                    float* d_o, float* d_d, HostRowAccumulator& acc,
                    float* dsky) {
  const ptre::ChainConsts<float> k = {p.t_min, p.shadow_eps, p.pdf_eps};
  std::vector<float> slice((size_t)ptre::kStateFields * p.max_depth * kSlice);
  for (int64_t r = 0; r < p.n_rays; ++r) {
    if (p.external_rng) {
      ptre::ExternalUniforms un = {urand, r, p.n_rays};
      host_ray(p, tab, sky, k, r, o, d, sel, un, dcol, d_o, d_d, dsky, acc, slice);
    } else {
      ptre::PhiloxUniforms un(p.seed_lo, p.seed_hi, (uint32_t)r, p.sample);
      host_ray(p, tab, sky, k, r, o, d, sel, un, dcol, d_o, d_d, dsky, acc, slice);
    }
  }
}

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

// record_kernel.cu over every ray: the same derived rows, RecordJob and
// warp scheduler, each 64-ray tile's warp simulated lane by lane by
// host_dense. `stats`: null, or ptre::kStats counters added to as the
// counting instantiation adds to them; `lens`: null, or (R,) bounces a path.
extern "C" void ptre_trace_record_host(const ptre::TraceParams* params,
                                       const float* o, const float* d,
                                       const float* urand, const float* tris,
                                       const float* sphs, const float* mats,
                                       const float* sky, float* color,
                                       int32_t* sel, uint64_t* stats,
                                       int32_t* lens) {
  const ptre::TraceParams& p = *params;
  const ptre::SceneTables tab = {tris, sphs, mats, sky, p.n_tri, p.n_sph, p.num_mats};
  if (p.external_rng) {
    const ptre::RecordJob<ptre::ExternalSource> job = {p, {urand, p.n_rays}, o, d, color, sel};
    ptre::host_dense(job, tab, stats, lens);
  } else {
    const ptre::RecordJob<ptre::PhiloxSource> job = {
        p, {p.seed_lo, p.seed_hi, p.sample}, o, d, color, sel};
    ptre::host_dense(job, tab, stats, lens);
  }
}

// fused_grad_kernel.cu's per-thread body over every ray; dtable and dsky (6)
// are accumulated into (the caller zeroes them). `padded` 0: the table and
// dtable are (n_rows, 27), read in place (the dense instantiation); 1: both
// are (n_rows, 28), the table read as the global instantiation reads it.
extern "C" void ptre_fused_bwd_host(const ptre::TraceParams* params,
                                    const float* table, const float* sky,
                                    const float* o, const float* d,
                                    const int32_t* sel, const float* urand,
                                    const float* dcol, float* d_o, float* d_d,
                                    float* dtable, float* dsky, int padded) {
  const ptre::TraceParams& p = *params;
  HostRowAccumulator acc = {dtable, padded ? ptre::kPadStride : ptre::kRowStride};
  if (padded) {
    const ptre::PaddedTable tab = {table};
    host_fused_bwd(p, tab, sky, o, d, sel, urand, dcol, d_o, d_d, acc, dsky);
  } else {
    const ptre::PointerTable tab = {table};
    host_fused_bwd(p, tab, sky, o, d, sel, urand, dcol, d_o, d_d, acc, dsky);
  }
}

// fused_grad_kernel.cu's GroupedRowAccumulator::add_row over n rays' row
// cotangents dg (n, 27) at rows idx (n; -1: nothing), replayed warp by warp
// on 32 consecutive rays (a ragged last warp's missing lanes pass -1): the
// lanes grouped by row as __match_any_sync groups them; a lane alone adds
// its own 27 values; a lane of a group of two or more puts its row into the
// warp's (32, 28) slice, and, leader by leader from the lowest lane, each
// four columns of the group's sum (group_sum4, lowest lane first) are added
// once. Rows from sph_offset on (n_sph_acc of them) go to a separate
// (n_sph_acc, 27) accumulator `dsph`, as the global instantiation's shared
// one; the others into dtable (rows of `stride` floats). The caller zeroes
// both.
extern "C" void ptre_grouped_rows_host(int n, const int32_t* idx,
                                       const float* dg, float* dtable,
                                       int stride, int sph_offset,
                                       int n_sph_acc, float* dsph) {
  auto dest = [&](int row, int* cols) {
    const int s = row - sph_offset;
    const bool sph = s >= 0 && s < n_sph_acc;
    *cols = sph ? ptre::kRowStride : stride;
    return sph ? dsph + s * ptre::kRowStride : dtable + (int64_t)row * stride;
  };
  std::vector<float> red(kWarp * ptre::kPadStride);
  for (int w0 = 0; w0 < n; w0 += kWarp) {
    int lane_idx[kWarp];
    for (int l = 0; l < kWarp; ++l) lane_idx[l] = w0 + l < n ? idx[w0 + l] : -1;
    unsigned group[kWarp];
    for (int l = 0; l < kWarp; ++l) {
      group[l] = 0u;
      for (int m = 0; m < kWarp; ++m)
        if (lane_idx[m] == lane_idx[l]) group[l] |= 1u << m;
    }
    unsigned leaders = 0u;
    for (int l = 0; l < kWarp; ++l) {
      if (lane_idx[l] < 0) continue;
      const float* v = dg + (int64_t)(w0 + l) * ptre::kRowStride;
      if (group[l] == (1u << l)) {
        int cols;
        float* dst = dest(lane_idx[l], &cols);
        for (int k = 0; k < ptre::kRowStride; ++k) dst[k] += v[k];
      } else {
        ptre::put_group_row(red.data(), l, v);
        if (ptre::lowest_lane(group[l]) == l) leaders |= 1u << l;
      }
    }
    for (unsigned todo = leaders; todo != 0u; todo &= todo - 1u) {
      const int leader = ptre::lowest_lane(todo);
      int cols;
      float* dst = dest(lane_idx[leader], &cols);
      for (int q = 0; q < ptre::kPadStride / 4; ++q) {
        float s[4];
        ptre::group_sum4(red.data(), group[leader], q, s);
        for (int j = 0; j < 4; ++j)
          if (4 * q + j < cols) dst[4 * q + j] += s[j];
      }
    }
  }
}
