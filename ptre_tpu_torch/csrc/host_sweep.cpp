// Host build of the sweep kernel's per-ray body, for checks on machines
// without a GPU: the same test_triangle / test_sphere (sweep.cuh) that
// sweep_kernel.cu runs per thread, looped over the rays on the CPU, the
// rows read straight from the tables instead of staged.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_sweep.so host_sweep.cpp
//
// tests/test_torch_intersect.py builds it this way (g++ on x86-64 does not
// contract a*b+c without -mfma, as the kernel is built without it) and holds
// it against the plain PyTorch sweep, exactly.

#include "sweep.cuh"

extern "C" void ptre_sweep_host(const ptre::sweep::SweepParams* params,
                                const float* o, const float* d,
                                const float* tris, const float* sphs,
                                int32_t* out) {
  namespace sw = ptre::sweep;
  const sw::SweepParams& p = *params;
  for (int64_t i = 0; i < p.n_rays; ++i) {
    const float ro[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const float rd[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    sw::Best tri = {sw::kBig, 0, false};
    for (int j = 0; j < p.n_tri; ++j) {
      sw::test_triangle(tris + (int64_t)j * sw::kTriStride, j, ro, rd, p, tri);
    }
    const float bound = sw::sphere_bound(tri, p);
    sw::Best sph = {sw::kBig, 0, false};
    for (int s = 0; s < p.n_sph; ++s) {
      sw::test_sphere(sphs + (int64_t)s * sw::kSphStride, s, ro, rd, bound, p, sph);
    }
    sw::store(out, i, p.n_rays, tri, sph);
  }
}
