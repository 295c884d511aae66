// Host build of the replay kernels (replay_kernel.cu), for checks on
// machines without a GPU: their warp emulated on 32 lanes, with the same
// per-lane code (replay.cuh replay_idx, replay_step, replay_unstep) in float
// and in double — the vote entering each bounce that ends the warp's
// recompute once no lane's path is alive (its dead tail), the saved states
// in a [bounce][field][thread] slice of a block's threads (StridedStatesT),
// each bounce's d(g) either staged in the warp's (32, 27) slice and copied
// out as one slab or written as zeros where no lane hit or past the dead
// tail, and d(sky) summed as the kernel sums it (a butterfly over the warp,
// the block's warps in order, the blocks in order).
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_replay_host.so host_replay.cpp
//
// tests/test_torch_csrc_replay_host.py builds it this way and holds it
// against the plain PyTorch versions (ops/cuda/replay_kernel.py);
// tests/test_torch_replay_pair_warp.py against the first design's host build
// (csrc/baseline/replay_pair/host_first.cpp), bit for bit.

#include <vector>

#include "replay.cuh"
#include "trace.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarpsPerBlock = ptre::kReplayBlock / kLanes;

// Counters of the backward's slabs (`stats`, 3 int64): warp-bounces
// skipped past a dead tail, slabs written as zeros without staging (those
// included), slabs staged.
enum { kSkipped, kZeroSlabs, kStagedSlabs };

// The warp of rays r0 .. r0 + n - 1 (n <= 32), lanes past n idle: uniforms
// of each lane from the params' source.
struct WarpUniforms {
  bool external;
  ptre::ExternalUniforms ext[kLanes];
  ptre::PhiloxUniforms phi[kLanes];

  WarpUniforms(const ptre::TraceParams& p, const float* urand, int64_t r0)
      : external(p.external_rng != 0) {
    for (int l = 0; l < kLanes; ++l) {
      ext[l] = {urand, r0 + l, p.n_rays};
      phi[l] = ptre::PhiloxUniforms(p.seed_lo, p.seed_hi, (uint32_t)(r0 + l), p.sample);
    }
  }
};

template <typename T>
void start_lanes(const T* o, const T* d, int64_t r0, int n, ptre::ReplayLane<T>* ln) {
  for (int l = 0; l < kLanes; ++l) {
    for (int i = 0; i < 3; ++i) {
      ln[l].o[i] = l < n ? o[3 * (r0 + l) + i] : T(0);
      ln[l].d[i] = l < n ? d[3 * (r0 + l) + i] : T(0);
      ln[l].c[i] = T(1);
    }
    ln[l].act = l < n;
  }
}

// Bounce b of the chain forward on every lane; `saved` null or 32 states.
template <typename T, class Saved>
void step_lanes(const ptre::TraceParams& p, const T* g, const T sky[6],
                const ptre::ChainConsts<T>& k, const int32_t* sel, int b, int64_t r0,
                int n, WarpUniforms& un, ptre::ReplayLane<T>* ln, Saved* saved) {
  for (int l = 0; l < kLanes; ++l) {
    const int64_t ray = r0 + (l < n ? l : 0);
    const int idx = ptre::replay_idx(p, sel, b, r0 + l, l < n);
    const T* row = g + ((int64_t)b * p.n_rays + ray) * ptre::kRowStride;
    Saved* s = saved == nullptr ? nullptr : saved + l;
    if (un.external)
      ptre::replay_step(b, idx, row, p.sph_offset, un.ext[l], sky, k, ln[l], s);
    else
      ptre::replay_step(b, idx, row, p.sph_offset, un.phi[l], sky, k, ln[l], s);
  }
}

// The vote entering a bounce: some lane's path is alive.
template <typename T>
bool any_alive(const ptre::ReplayLane<T>* ln) {
  bool any = false;
  for (int l = 0; l < kLanes; ++l) any = any || ln[l].act;
  return any;
}

template <typename T>
void forward_warp(const ptre::TraceParams& p, const T* g, const T* sky, const T* o,
                  const T* d, const int32_t* sel, const float* urand, int64_t r0, int n,
                  T* color) {
  const ptre::ChainConsts<T> k = {T(p.t_min), T(p.shadow_eps), T(p.pdf_eps)};
  WarpUniforms un(p, urand, r0);
  ptre::ReplayLane<T> ln[kLanes];
  start_lanes(o, d, r0, n, ln);
  ptre::StridedStatesT<T>* none = nullptr;
  for (int b = 0; b < p.max_depth && any_alive(ln); ++b)
    step_lanes(p, g, sky, k, sel, b, r0, n, un, ln, none);
  for (int l = 0; l < n; ++l)
    for (int i = 0; i < 3; ++i) color[3 * (r0 + l) + i] = ln[l].c[i];
}

// One warp of the backward (warp `w` of its block, whose states slice is
// `states`); its d(sky) butterfly sum into `part`.
template <typename T>
void backward_warp(const ptre::TraceParams& p, const T* g, const T* sky, const T* o,
                   const T* d, const int32_t* sel, const float* urand, const T* dcol,
                   int64_t r0, int n, int w, T* states, T* d_o, T* d_d, T* d_g,
                   T part[6], int64_t* stats) {
  const ptre::ChainConsts<T> k = {T(p.t_min), T(p.shadow_eps), T(p.pdf_eps)};
  WarpUniforms un(p, urand, r0);
  ptre::ReplayLane<T> ln[kLanes];
  start_lanes(o, d, r0, n, ln);
  ptre::StridedStatesT<T> st[kLanes];
  T gO[kLanes][3], gD[kLanes][3], gC[kLanes][3], dsky[kLanes][6];
  for (int l = 0; l < kLanes; ++l) {
    const bool valid = l < n;
    st[l] = {states + w * kLanes + l, ptre::kReplayBlock, sel + r0 + (valid ? l : 0),
             p.n_rays, p.n_rows, valid, 0u};
    for (int i = 0; i < 3; ++i) {
      gO[l][i] = gD[l][i] = T(0);
      gC[l][i] = valid ? dcol[3 * (r0 + l) + i] : T(0);
    }
    for (int i = 0; i < 6; ++i) dsky[l][i] = T(0);
  }
  int live = p.max_depth;
  for (int b = 0; b < p.max_depth; ++b) {
    if (!any_alive(ln)) {
      live = b;
      break;
    }
    step_lanes(p, g, sky, k, sel, b, r0, n, un, ln, st);
  }
  T slice[kLanes * ptre::kRowStride];
  for (int b = p.max_depth - 1; b >= 0; --b) {
    T* dst = d_g + ((int64_t)b * p.n_rays + r0) * ptre::kRowStride;
    bool any_hit = false;
    if (b < live) {
      for (int l = 0; l < kLanes; ++l) {
        const ptre::BounceState<T> s = st[l].load(b);
        const int64_t ray = r0 + (l < n ? l : 0);
        const T* row = g + ((int64_t)b * p.n_rays + ray) * ptre::kRowStride;
        ptre::replay_unstep(s, row, p.sph_offset, sky, k, gO[l], gD[l], gC[l],
                            slice + l * ptre::kRowStride, dsky[l]);
        any_hit = any_hit || s.idx >= 0;
      }
    }
    const bool staged = any_hit;
    for (int i = 0; i < n * ptre::kRowStride; ++i) dst[i] = staged ? slice[i] : T(0);
    if (stats != nullptr) {
      stats[kSkipped] += b >= live;
      stats[staged ? kStagedSlabs : kZeroSlabs] += 1;
    }
  }
  for (int l = 0; l < n; ++l) {
    for (int i = 0; i < 3; ++i) {
      d_o[3 * (r0 + l) + i] = gO[l][i];
      d_d[3 * (r0 + l) + i] = gD[l][i];
    }
  }
  // v += shfl_xor(v, off) for off = 16 .. 1: lane 0's value
  for (int i = 0; i < 6; ++i) {
    T v[kLanes];
    for (int l = 0; l < kLanes; ++l) v[l] = dsky[l][i];
    for (int off = 16; off > 0; off >>= 1) {
      T nv[kLanes];
      for (int l = 0; l < kLanes; ++l) nv[l] = v[l] + v[l ^ off];
      for (int l = 0; l < kLanes; ++l) v[l] = nv[l];
    }
    part[i] = v[0];
  }
}

template <typename T>
void replay_fwd_all(const ptre::TraceParams& p, const T* g, const T* sky, const T* o,
                    const T* d, const int32_t* sel, const float* urand, T* color) {
  for (int64_t r0 = 0; r0 < p.n_rays; r0 += kLanes) {
    const int n = p.n_rays - r0 < kLanes ? (int)(p.n_rays - r0) : kLanes;
    forward_warp(p, g, sky, o, d, sel, urand, r0, n, color);
  }
}

// Every block of the backward; dsky (6) is accumulated into, block after
// block (the caller zeroes it), each block's partial the sum of its warps'
// in order.
template <typename T>
void replay_bwd_all(const ptre::TraceParams& p, const T* g, const T* sky, const T* o,
                    const T* d, const int32_t* sel, const float* urand, const T* dcol,
                    T* d_o, T* d_d, T* d_g, T* dsky, int64_t* stats) {
  std::vector<T> states((size_t)ptre::kStateFields * p.max_depth * ptre::kReplayBlock);
  for (int64_t b0 = 0; b0 < p.n_rays; b0 += ptre::kReplayBlock) {
    T block[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const int64_t r0 = b0 + w * kLanes;
      T part[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (r0 < p.n_rays) {
        const int n = p.n_rays - r0 < kLanes ? (int)(p.n_rays - r0) : kLanes;
        backward_warp(p, g, sky, o, d, sel, urand, dcol, r0, n, w, states.data(), d_o, d_d,
                      d_g, part, stats);
      }
      for (int i = 0; i < 6; ++i) block[i] += part[i];
    }
    for (int i = 0; i < 6; ++i) dsky[i] += block[i];
  }
}

}  // namespace

extern "C" void ptre_replay_fwd_host_f(const ptre::TraceParams* p, const float* g,
                                       const float* sky, const float* o, const float* d,
                                       const int32_t* sel, const float* urand,
                                       float* color) {
  replay_fwd_all(*p, g, sky, o, d, sel, urand, color);
}

extern "C" void ptre_replay_fwd_host_d(const ptre::TraceParams* p, const double* g,
                                       const double* sky, const double* o, const double* d,
                                       const int32_t* sel, const float* urand,
                                       double* color) {
  replay_fwd_all(*p, g, sky, o, d, sel, urand, color);
}

// stats: null, or 3 int64 counters (kSkipped, kZeroSlabs, kStagedSlabs)
// added into.
extern "C" void ptre_replay_bwd_host_f(const ptre::TraceParams* p, const float* g,
                                       const float* sky, const float* o, const float* d,
                                       const int32_t* sel, const float* urand,
                                       const float* dcol, float* d_o, float* d_d,
                                       float* d_g, float* dsky, int64_t* stats) {
  replay_bwd_all(*p, g, sky, o, d, sel, urand, dcol, d_o, d_d, d_g, dsky, stats);
}

extern "C" void ptre_replay_bwd_host_d(const ptre::TraceParams* p, const double* g,
                                       const double* sky, const double* o, const double* d,
                                       const int32_t* sel, const float* urand,
                                       const double* dcol, double* d_o, double* d_d,
                                       double* d_g, double* dsky, int64_t* stats) {
  replay_bwd_all(*p, g, sky, o, d, sel, urand, dcol, d_o, d_d, d_g, dsky, stats);
}
