// Per-ray bodies of the wavefront path and of the culled megakernel, shared
// by the CUDA mask, bounce and culled kernels (mask_kernel.cu,
// wave_kernel.cu, mega_kernel.cu) and their host build (host_wave.cpp), and
// the warp's leaf sweep that the bounce and culled kernels both run
// (sweep_leaf_warp, CUDA only; host_wave.cpp keeps its g++ twin).
//
// These are the one-ray forms of ptre_tpu/ops/pallas/wavefront.py
// _mask_kernel (:102) and _wave_kernel (:209), and of the sweep and finish
// of megakernel.py _mega_kernel (:237), which is the same arithmetic. Their
// plain PyTorch twins are wave_mask_reference / wave_bounce_reference in
// ops/cuda/wavefront.py and trace_culled_reference in ops/cuda/megakernel.py;
// all keep the reference's operation order, so they agree to float rounding.
//
// The state of a ray is 10 float32 rows of a (10, r_pad) array: o.xyz d.xyz
// rgb active, plus an int32 original ray id beside it that keys the scatter
// uniforms. Leaves are 64 Morton-consecutive rows of the triangle tables:
// the (n_leaf * 64, 32) pack_tri32 rows, which the finish reads by the
// winner's index, and the (n_leaf * 64, 12) compact intersection rows that
// the sweeps read (kRowStride). A leaf's box is a pack_tile_boxes row
// (lo.xyz hi.xyz pad); the per-ray culls read the boxes dilated by
// wavefront.CULL_PAD_REL (prepare_scene's cull_boxes and super_boxes).
//
// The winner's attributes follow the wave kernel, not path_bounce: the
// interpolated normal is normalised and then flipped by the geometric normal
// (wavefront.py:404-417), and the sphere normal (p - c) * (1/r) is not
// renormalised (:429-438). path_bounce flips first and normalises the
// merged normal afterwards (trace.cuh), which differs by ~1e-6.
#pragma once

#include "trace.cuh"

namespace ptre {

constexpr int kLeaf = 64;       // triangle rows per leaf: the sweep and cull granularity
constexpr int kBoxStride = 8;   // pack_tile_boxes row
constexpr int kMaxLanes = 256;  // rays per block, at most: one thread each
constexpr int kSuper = 8;       // leaves per supertile: the culled sweep's second level
// Compact intersection row: v0 (0-2), e1 = v1 - v0 (3-5), e2 = v2 - v0 (6-8),
// valid (9), the packet's own row as int32 bits (10), 0 (11): 48 bytes,
// three 16-byte loads. e1 and e2 are rounded once on the host, as one float32
// subtraction rounds them in a kernel.
constexpr int kRowStride = 12;
constexpr int kLeafFloats = kLeaf * kRowStride;  // a leaf's compact rows: 768 floats, 3 KB

// Arguments of the mask kernel, passed by value. Mirrored field for field by
// MaskParams in ops/cuda/wavefront.py (every field 4 bytes).
struct MaskParams {
  float t_min;
  int32_t r_pad, n_leaf;
};

// Arguments of the bounce kernel, passed by value. Mirrored field for field
// by WaveParams in ops/cuda/wavefront.py.
struct WaveParams {
  float t_min, t_max, det_eps, shadow_eps, pdf_eps;
  uint32_t seed_lo, seed_hi, sample;
  int32_t n_rays,       // original rays: the external uniforms' row length
      r_pad,            // state columns, a whole number of ray blocks
      n_leaf,           // leaves in the triangle table
      list_stride,      // shortlist row length
      n_sph, num_mats,
      bounce,           // uniforms: draw pair 1 + bounce
      external_rng,
      sph_offset,       // recording: unified-table row of sphere 0
      n_sel;            // recording: selection row length, the original rays
};

// Arguments of the culled megakernel, passed by value. Mirrored field for
// field by MegaParams in ops/cuda/megakernel.py. Of `w` the kernel reads the
// scalars, the seed, n_rays (the ray count, with either uniform source),
// n_leaf, n_sph, num_mats, external_rng, sph_offset and n_sel; it sets
// `bounce` itself.
struct MegaParams {
  WaveParams w;
  int32_t max_depth,
      n_super,  // supertiles: the leaf boxes hold n_super * kSuper rows
      cull;     // 0: sweep every leaf
};

struct WaveRay {
  float o[3], d[3], c[3];
  float act;  // > 0.5: live
};

PTRE_HD WaveRay load_ray(const float* state, int64_t col, int64_t r_pad) {
  WaveRay r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = state[k * r_pad + col];
    r.d[k] = state[(3 + k) * r_pad + col];
    r.c[k] = state[(6 + k) * r_pad + col];
  }
  r.act = state[9 * r_pad + col];
  return r;
}

PTRE_HD void store_ray(float* state, int64_t col, int64_t r_pad,
                       const WaveRay& r) {
  for (int k = 0; k < 3; ++k) {
    state[k * r_pad + col] = r.o[k];
    state[(3 + k) * r_pad + col] = r.d[k];
    state[(6 + k) * r_pad + col] = r.c[k];
  }
  state[9 * r_pad + col] = r.act;
}

// slab_inv, slab_interval and slab_pass: trace.cuh (the dense kernels'
// group boxes use them too).

// The union box (lo.xyz hi.xyz) of supertile s of `boxes`: its leaves s *
// kSuper .. below n_leaf (at least one), taken with fminf / fmaxf, so it is
// megakernel.pack_super_boxes of these boxes exactly (a padding leaf there is
// an empty box, which no min or max takes). Each leaf box lies inside it, so
// a ray that passes a leaf's slab test passes its supertile's: the test
// subtracts and multiplies without a*b+c, and round-to-nearest is monotone,
// so a wider box gives a t_near no later and a t_far no earlier on every
// axis (slab_inv is finite and non-zero).
PTRE_HD void super_union(const float* boxes, int n_leaf, int s, float out[6]) {
  const int l0 = s * kSuper;
  for (int k = 0; k < 6; ++k) out[k] = boxes[l0 * kBoxStride + k];
  for (int l = l0 + 1; l < l0 + kSuper && l < n_leaf; ++l) {
    for (int k = 0; k < 3; ++k) {
      out[k] = fminf(out[k], boxes[l * kBoxStride + k]);
      out[3 + k] = fmaxf(out[3 + k], boxes[l * kBoxStride + 3 + k]);
    }
  }
}

// The culled megakernel's slab test (megakernel.py:377-390): also bounded by
// the closest hit so far, so found intersections cull later boxes.
PTRE_HD bool slab_pass_within(const float* box, const float o[3],
                              const float iv[3], float t_min, float best_t) {
  float tn, tf;
  slab_interval(box, o, iv, &tn, &tf);
  return tn <= tf && tf >= t_min && tn <= best_t;
}

// The closest triangle so far: strict t < best in ascending row order keeps
// the lowest Morton row on a tie (wavefront.py:292-303).
struct TriBest {
  float t;
  int idx;
  bool hit;
};

// Moller-Trumbore of one ray against one compact row: whether the row
// accepts, and its t in *t_out (wavefront.py:261-290, intersect_kernel.py
// :95-212). |det| < det_eps rejects; an invalid row accepts nothing.
PTRE_HD bool row_accepts(const float* row, const float o[3], const float d[3],
                         float t_min, float t_max, float det_eps, float* t_out) {
  if (!(row[9] > 0.5f)) return false;
  const float dx = d[0], dy = d[1], dz = d[2];
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float e2x = row[6], e2y = row[7], e2z = row[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = 1.0f / (fabsf(det) < det_eps ? 1.0f : det);
  const float tvx = o[0] - row[0], tvy = o[1] - row[1], tvz = o[2] - row[2];
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  *t_out = t;
  return fabsf(det) >= det_eps && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
         u + v <= 1.0f && t >= t_min && t <= t_max;
}

// Moller-Trumbore of one ray against the 64 compact rows of leaf `leaf`,
// which start at `rows` (wavefront.py:261-303): strict t < best in
// ascending row order.
PTRE_HD void sweep_leaf(const float* rows, int leaf, const WaveRay& r,
                        const WaveParams& p, TriBest& best) {
  for (int j = 0; j < kLeaf; ++j) {
    float t;
    if (!row_accepts(rows + j * kRowStride, r.o, r.d, p.t_min, p.t_max, p.det_eps, &t)) {
      continue;
    }
    best.hit = true;
    if (t < best.t) {
      best.t = t;
      best.idx = leaf * kLeaf + j;
    }
  }
}

// A block's shortlist (mask_kernel.cu): the ascending ids of the set bits of
// its bit mask, bit l & 31 of word l >> 5 for leaf l. The routine borrows
// kListScratch words of the mask, which it has read by then, for its scan:
// one a warp, and the chunk's total in the last.
constexpr int kListScratch = kMaxLanes / 32 + 1;

PTRE_HD int popc32(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Where set bit `bit` of `word` goes among the word's set bits: the count of
// the set bits below it.
PTRE_HD int list_slot(unsigned word, int bit) { return popc32(word & ((1u << bit) - 1u)); }

#ifdef __CUDACC__
constexpr unsigned kFullWarp = 0xffffffffu;

// A warp's inclusive prefix sum of `v` over its lanes, by shuffles.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int k = 1; k < 32; k <<= 1) {
    const int up = __shfl_up_sync(kFullWarp, v, k);
    if (lane >= k) v += up;
  }
  return v;
}

// The shortlist of a block's bit mask `words` (n_words words in shared
// memory, at least kListScratch of them; the bits past the last leaf 0):
// list[0, cnt) the set bits' leaf ids in ascending order, *count = cnt; the
// list past cnt is not written, and the words are overwritten. Every thread
// of the block calls it after a barrier that follows the mask's last write.
// The words are taken blockDim.x at a time, a word a thread: an exclusive
// scan of their popcounts (shuffles within a warp, then warp 0 over the
// warps' totals, in the scratch words) gives each word's offset, carried
// from chunk to chunk; then a warp expands its non-zero words one at a time,
// lane l storing leaf 32 w + l, if set, at the word's offset plus
// list_slot, so a word's stores are consecutive.
__device__ __forceinline__ void bits_to_list(unsigned* words, int n_words, int32_t* list,
                                             int32_t* count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* scratch = reinterpret_cast<int*>(words);
  int base = 0;  // entries the chunks before this one wrote
  for (int c = 0; c < n_words; c += blockDim.x) {
    const unsigned word = c + tid < n_words ? words[c + tid] : 0u;
    const int pc = popc32(word);
    const int incl = warp_scan(pc);
    __syncthreads();  // the chunk's words are read, the last chunk's offsets too
    if (lane == 31) scratch[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0;
      const int x = warp_scan(v);
      if (lane < (int)(blockDim.x >> 5)) scratch[lane] = x - v;
      if (lane == 31) scratch[kListScratch - 1] = x;
    }
    __syncthreads();
    const int off = base + scratch[warp] + incl - pc;
    base += scratch[kListScratch - 1];
    for (unsigned nz = __ballot_sync(kFullWarp, word != 0u); nz != 0u; nz &= nz - 1u) {
      const int src = __ffs(nz) - 1;
      const unsigned w = __shfl_sync(kFullWarp, word, src);
      const int at = __shfl_sync(kFullWarp, off, src);
      if ((w >> lane) & 1u) list[at + list_slot(w, lane)] = ((c + (warp << 5) + src) << 5) + lane;
    }
  }
  if (tid == 0) *count = base;
}

// A float's order as an unsigned, -0.0 taken as +0.0: for floats a, b that
// are not NaN, a < b iff order_key(a) < order_key(b), a == b iff the keys
// are equal.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t + 0.0f);
  return (u & 0x80000000u) != 0 ? ~u : (u | 0x80000000u);
}

// The 64 rows of one leaf (compact rows in global memory, 16-byte aligned)
// against the ray of every lane of `passed`, in ascending lane order. Each
// lane loads rows lane and lane + 32 once, three 16-byte loads each through
// the read-only path; the warp then tests one passing ray at a time, two
// rows a lane (row_accepts), and takes the lexicographic (t, row) minimum of
// the rows that accept: the least t by a REDUX of order keys, then the
// lowest row that has it by two ballots (the first rows, then the second).
// The ray's lane merges it into its best with strict t < best. That is
// sweep_leaf's result: strict t < best over ascending rows keeps the
// smallest t at its lowest row, and a tie with an earlier leaf keeps the
// earlier (lower) row. Every lane of the warp calls it with the same
// `passed`.
__device__ __forceinline__ void sweep_leaf_warp(const float* rows, int leaf, unsigned passed,
                                                const WaveRay& r, const WaveParams& p,
                                                TriBest& best) {
  const int lane = threadIdx.x & 31;
  float rw[2][kRowStride];
  for (int h = 0; h < 2; ++h) {
    const float4* q = reinterpret_cast<const float4*>(rows + (lane + 32 * h) * kRowStride);
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    const float v[kRowStride] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
    for (int i = 0; i < kRowStride; ++i) rw[h][i] = v[i];
  }
  for (unsigned m = passed; m != 0; m &= m - 1) {
    const int src = __ffs(m) - 1;
    float o[3], d[3];
    for (int k = 0; k < 3; ++k) {
      o[k] = __shfl_sync(kFullWarp, r.o[k], src);
      d[k] = __shfl_sync(kFullWarp, r.d[k], src);
    }
    float t_row[2];
    bool acc[2];
    for (int h = 0; h < 2; ++h) {
      acc[h] = row_accepts(rw[h], o, d, p.t_min, p.t_max, p.det_eps, &t_row[h]);
    }
    if (!__any_sync(kFullWarp, acc[0] || acc[1])) continue;
    // a row that accepts nothing as +inf: the least key is an accepted row's
    const float inf = __int_as_float(0x7f800000);
    const float t_lane = fminf(acc[0] ? t_row[0] : inf, acc[1] ? t_row[1] : inf);
    const unsigned k_min = __reduce_min_sync(kFullWarp, order_key(t_lane));
    const unsigned lo = __ballot_sync(kFullWarp, acc[0] && order_key(t_row[0]) == k_min);
    const unsigned hi = __ballot_sync(kFullWarp, acc[1] && order_key(t_row[1]) == k_min);
    const int j_min = lo != 0 ? __ffs(lo) - 1 : 31 + __ffs(hi);
    const float t_min = __shfl_sync(kFullWarp, j_min < 32 ? t_row[0] : t_row[1], j_min & 31);
    if (lane == src) {
      best.hit = true;
      if (t_min < best.t) {
        best.t = t_min;
        best.idx = leaf * kLeaf + j_min;
      }
    }
  }
}
#endif  // __CUDACC__

// Near root of a sphere row, or the far one when the near root lies behind
// t_min (wavefront.py:326-332, :422-428). Returns the root; *delta and
// *t_near are the discriminant and the near root.
PTRE_HD float sphere_root(const float* sp, const float o[3], const float d[3],
                          float t_min, float* delta, float* t_near) {
  const float ocx = sp[0] - o[0], ocy = sp[1] - o[1], ocz = sp[2] - o[2];
  const float halfb = d[0] * ocx + d[1] * ocy + d[2] * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - sp[3] * sp[3];
  *delta = halfb * halfb - c;
  const float sq = sqrtf(fmaxf(*delta, 0.0f));
  *t_near = halfb - sq;
  return *t_near >= t_min ? *t_near : halfb + sq;
}

// Recorder policies of finish_bounce. NoWinner compiles to nothing, so the
// non-recording kernels' code and registers are those of a bounce without
// recording.
struct NoWinner {
  PTRE_HD void winner(int) const {}
};

// Writes a live ray's winner as a unified-table row (wavefront.py:345-349):
// triangle row j -> j, sphere s -> sph_offset + s, a miss -> -1. `dst` is
// the ray's slot of this bounce's selection row, or null for a ray past the
// original ones.
struct WinnerWriter {
  int32_t* dst;
  PTRE_HD void winner(int row) const {
    if (dst != nullptr) *dst = row;
  }
};

// The rest of one live ray's bounce after the triangle sweep
// (wavefront.py:311-466): spheres bounded by the closest triangle (far-root
// quirk: the acceptance bounds t_near), the winner's row read by index and
// its attributes re-derived, shading, and the next state in place.
// ``rec.winner(row)`` sees the winner.
template <class Uniforms, class Recorder>
PTRE_HD void finish_bounce(const WaveParams& p, const SceneTables& sc,
                           const TriBest& tb, const Uniforms& un,
                           const Recorder& rec, WaveRay& r) {
  const float ox = r.o[0], oy = r.o[1], oz = r.o[2];
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  const float tri_best = tb.hit ? tb.t : p.t_max;

  float sph_t = kBig;
  int sph_i = 0;
  bool sph_hit = false;
  for (int s = 0; s < sc.n_sph; ++s) {
    const float* sp = sc.sphs + s * kSphStride;
    if (!(sp[4] > 0.5f)) continue;
    float delta, t_near;
    const float t = sphere_root(sp, r.o, r.d, p.t_min, &delta, &t_near);
    const bool acc = delta >= 0.0f && t_near <= tri_best && t >= p.t_min;
    if (!acc) continue;
    sph_hit = true;
    if (t < sph_t) {
      sph_t = t;
      sph_i = s;
    }
  }

  const bool hit = tb.hit || sph_hit;
  rec.winner(!hit ? -1 : (sph_hit ? p.sph_offset + sph_i : tb.idx));
  float f[3], wi[3] = {dx, dy, dz};
  bool emissive = false;
  float px = 0.0f, py = 0.0f, pz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (!hit) {
    sky_color(dy, sc.sky, &f[0], &f[1], &f[2]);
  } else {
    float mat_id;
    if (sph_hit) {  // a sphere candidate already beat the triangles
      const float* sp = sc.sphs + sph_i * kSphStride;
      const float scx = sp[0], scy = sp[1], scz = sp[2], srad = sp[3];
      float delta, t_near;
      const float t_s = sphere_root(sp, r.o, r.d, p.t_min, &delta, &t_near);
      const float inv_r = 1.0f / (srad == 0.0f ? 1.0f : srad);
      px = ox + t_s * dx;
      py = oy + t_s * dy;
      pz = oz + t_s * dz;
      nx = (px - scx) * inv_r;
      ny = (py - scy) * inv_r;
      nz = (pz - scz) * inv_r;
      const float sign = dx * nx + dy * ny + dz * nz < 0.0f ? 1.0f : -1.0f;
      nx *= sign;
      ny *= sign;
      nz *= sign;
      mat_id = sp[5];
    } else {
      const float* tr = sc.tris + (int64_t)tb.idx * kTriStride;
      const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
      const float e1x = tr[3] - v0x, e1y = tr[4] - v0y, e1z = tr[5] - v0z;
      const float e2x = tr[6] - v0x, e2y = tr[7] - v0y, e2z = tr[8] - v0z;
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t_tri = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const float w = 1.0f - u - v;
      // normalise the interpolated normal, then flip it by the geometric one
      nx = w * tr[9] + u * tr[12] + v * tr[15];
      ny = w * tr[10] + u * tr[13] + v * tr[16];
      nz = w * tr[11] + u * tr[14] + v * tr[17];
      const float tlen = sqrtf(nx * nx + ny * ny + nz * nz);
      const float tinv = tlen > 0.0f ? 1.0f / tlen : 0.0f;
      nx *= tinv;
      ny *= tinv;
      nz *= tinv;
      const float gnx = e1y * e2z - e1z * e2y;
      const float gny = e1z * e2x - e1x * e2z;
      const float gnz = e1x * e2y - e1y * e2x;
      const float sign = dx * gnx + dy * gny + dz * gnz < 0.0f ? 1.0f : -1.0f;
      nx *= sign;
      ny *= sign;
      nz *= sign;
      px = ox + t_tri * dx;
      py = oy + t_tri * dy;
      pz = oz + t_tri * dz;
      mat_id = tr[19];
    }
    float u1, u2;
    un.pair(1 + p.bounce, &u1, &u2);
    scatter_shade(nx, ny, nz, dx, dy, dz, mat_id, u1, u2, sc, p.pdf_eps, f, wi,
                  &emissive);
  }

  for (int k = 0; k < 3; ++k) r.c[k] *= f[k];
  if (hit && !emissive) {  // next ray along the final normal (:455-466)
    r.o[0] = px + p.shadow_eps * nx;
    r.o[1] = py + p.shadow_eps * ny;
    r.o[2] = pz + p.shadow_eps * nz;
    for (int k = 0; k < 3; ++k) r.d[k] = wi[k];
    r.act = 1.0f;
  } else {
    r.act = 0.0f;
  }
}

// Draw pair k of a ray, the bits of PhiloxUniforms (philox.cuh) computed
// without its cache: a bounce draws one pair.
struct PhiloxPair {
  uint32_t key0, key1, ray, sample;

  PTRE_HD void pair(int k, float* u1, float* u2) const {
    const Philox4 b = philox4x32_10(ray, sample, (uint32_t)(k >> 1), 0u, key0, key1);
    const bool odd = (k & 1) != 0;
    *u1 = u01(odd ? b.w[2] : b.w[0]);
    *u2 = u01(odd ? b.w[3] : b.w[1]);
  }
};

// finish_bounce with the uniform source the params select: Philox keyed by
// (seed, original ray id, sample), or rows 2 + 2b and 3 + 2b of the external
// (2 + 2 * max_depth, n_rays) uniforms at the ray's id.
template <class Recorder>
PTRE_HD void finish_bounce_at(const WaveParams& p, const SceneTables& sc,
                              const TriBest& tb, int32_t id, const float* urand,
                              const Recorder& rec, WaveRay& r) {
  if (p.external_rng) {
    const ExternalUniforms un = {urand, id, p.n_rays};
    finish_bounce(p, sc, tb, un, rec, r);
  } else {
    const PhiloxPair un = {p.seed_lo, p.seed_hi, (uint32_t)id, p.sample};
    finish_bounce(p, sc, tb, un, rec, r);
  }
}

// The selection slot of ray `id` at bounce `bounce` of a (B, n_sel) int32
// array: null for a ray past the original ones (padding, always dead).
PTRE_HD int32_t* sel_slot(int32_t* sel, const WaveParams& p, int bounce,
                          int32_t id) {
  return id < p.n_sel ? sel + (int64_t)bounce * p.n_sel + id : nullptr;
}

}  // namespace ptre
