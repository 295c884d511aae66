// Host build of the sweep kernel's per-ray body, for checks on machines
// without a GPU: the same culled walk (sweep.cuh sweep_triangles, wave.cuh
// slab_pass_within and row_accepts) and sphere tests that sweep_kernel.cu's
// lanes run, looped over the rays on the CPU, the boxes and rows read
// straight from the tables instead of staged.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libptre_host_sweep.so host_sweep.cpp
//
// tests/test_torch_intersect.py builds it this way (g++ on x86-64 does not
// contract a*b+c without -mfma, as the kernel is built without it) and holds
// it against the brute-force plain PyTorch sweep, exactly.

#include "sweep.cuh"

// active: (n_rays,) bytes, 0 for a dead ray (selections 0, false, 0, false),
// or null (every ray live).
extern "C" void ptre_sweep_host(const ptre::sweep::SweepParams* params,
                                const float* o, const float* d, const uint8_t* active,
                                const float* rows, const float* boxes,
                                const float* boxes2, const float* sphs, int32_t* out) {
  namespace sw = ptre::sweep;
  const sw::SweepParams& p = *params;
  for (int64_t i = 0; i < p.n_rays; ++i) {
    sw::Best tri = {ptre::kBig, 0, false}, sph = {ptre::kBig, 0, false};
    if (active == nullptr || active[i] != 0) {
      const float ro[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
      const float rd[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      tri = sw::sweep_triangles(rows, boxes, boxes2, ro, rd, p);
      sph = sw::sweep_spheres(sphs, ro, rd, tri, p);
    }
    sw::store(out, i, p.n_rays, tri, sph);
  }
}
