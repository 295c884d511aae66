// Host build of the replay kernels' per-ray bodies (replay.cuh
// replay_ray_forward / replay_ray_backward), for checks on machines without
// a GPU: the same code replay_kernel.cu runs per thread, looped over every
// ray, in float and in double.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_replay_host.so host_replay.cpp
//
// tests/test_torch_csrc_replay_host.py builds it this way and holds it
// against the plain PyTorch versions (ops/cuda/replay_kernel.py).

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
