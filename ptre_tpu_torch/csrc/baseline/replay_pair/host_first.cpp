// Host build of the replay pair's first design (replay_kernel.cu in this
// directory), against the frozen headers here: replay.cuh's per-ray bodies
// replay_ray_forward / replay_ray_backward, the code each thread of the
// first design ran, looped over every ray, in float and in double.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_replay_first.so host_first.cpp
//
// tests/test_torch_replay_pair_warp.py holds the redesigned kernels' host
// build (csrc/host_replay.cpp, a warp of 32 rays emulated) to it: g++
// contracts no a*b+c without -mfma, so the two run the same float
// operations unless the redesign reordered some.

#include "replay.cuh"
#include "trace.cuh"

namespace {

template <typename T>
void replay_fwd_all(const ptre::TraceParams& p, const T* g, const T* sky,
                    const T* o, const T* d, const int32_t* sel,
                    const float* urand, T* color) {
  for (int64_t r = 0; r < p.n_rays; ++r)
    ptre::replay_ray_forward(p, g, sky, o, d, sel, urand, r, color);
}

// dsky (6) is accumulated into over every ray (the caller zeroes it).
template <typename T>
void replay_bwd_all(const ptre::TraceParams& p, const T* g, const T* sky,
                    const T* o, const T* d, const int32_t* sel,
                    const float* urand, const T* dcol, T* d_o, T* d_d, T* d_g,
                    T* dsky) {
  for (int64_t r = 0; r < p.n_rays; ++r)
    ptre::replay_ray_backward(p, g, sky, o, d, sel, urand, dcol, r, d_o, d_d,
                              d_g, dsky);
}

}  // namespace

extern "C" void ptre_replay_fwd_host_f(const ptre::TraceParams* p,
                                       const float* g, const float* sky,
                                       const float* o, const float* d,
                                       const int32_t* sel, const float* urand,
                                       float* color) {
  replay_fwd_all(*p, g, sky, o, d, sel, urand, color);
}

extern "C" void ptre_replay_fwd_host_d(const ptre::TraceParams* p,
                                       const double* g, const double* sky,
                                       const double* o, const double* d,
                                       const int32_t* sel, const float* urand,
                                       double* color) {
  replay_fwd_all(*p, g, sky, o, d, sel, urand, color);
}

extern "C" void ptre_replay_bwd_host_f(const ptre::TraceParams* p,
                                       const float* g, const float* sky,
                                       const float* o, const float* d,
                                       const int32_t* sel, const float* urand,
                                       const float* dcol, float* d_o,
                                       float* d_d, float* d_g, float* dsky) {
  replay_bwd_all(*p, g, sky, o, d, sel, urand, dcol, d_o, d_d, d_g, dsky);
}

extern "C" void ptre_replay_bwd_host_d(const ptre::TraceParams* p,
                                       const double* g, const double* sky,
                                       const double* o, const double* d,
                                       const int32_t* sel, const float* urand,
                                       const double* dcol, double* d_o,
                                       double* d_d, double* d_g,
                                       double* dsky) {
  replay_bwd_all(*p, g, sky, o, d, sel, urand, dcol, d_o, d_d, d_g, dsky);
}
