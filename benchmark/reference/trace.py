"""The reference path tracer: plain PyTorch, float32 (or a lower precision
for the control), differentiable where a training step needs it.

Semantics of the IoniqRE integrator (`path_tracer.cu:240-366`, `shape.cu`,
`material.cu`), as the program is documented to implement them:

* closest hit, triangles first (Moller-Trumbore, no back-face culling,
  |det| < det_eps rejected, t in [t_min, t_max], ties to the lowest row),
  then analytic spheres bounded by the closest triangle, with the far-root
  quirk (the near root alone is held to the bound); a sphere hit replaces the
  triangle's;
* a smooth triangle normal (1 - u - v) n0 + u n1 + v n2, normalised and
  flipped to face the ray by the geometric normal; a sphere normal (p - c) / r
  flipped the same way;
* Oren-Nayar (sigma clipped to [0, 1], world-frame azimuths) with a
  cosine-weighted scatter and the degenerate-pdf fallback, or an emissive
  material that ends the path with strength x colour; the sky gradient on a
  miss; the next ray leaves from p + shadow_eps n;
* a sample's colour is the product of the factors of its ``max_depth``
  bounces; a rendered sample is clamped to [0, 1] with non-finite values set
  to 0, a training sample is raw.

Each bounce is two phases: a detached search for the winners (a leaf cull
over boxes of 64 consecutive triangle rows, then every row of a passing
leaf), and a differentiable recompute of the winners' (t, p, n) in O(R),
whose gradients follow the program's documented conventions (`gradsafe`).
Gathers from small tables sum their backward in float64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import gradsafe as gs

LEAF = 64
_BIG = 1e30
#: relative growth of a leaf box: far beyond any rounding of the search
BOX_PAD = 1e-3


def f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Consts:
    t_min: float = f32(1e-6)
    t_max: float = f32(999.99)
    det_eps: float = f32(1e-6)
    shadow_eps: float = f32(1e-4)
    pdf_eps: float = f32(1e-5)


class _Gather(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's cotangents in float64."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=torch.float64, device=g.device)
        out.index_add_(0, idx, g.to(torch.float64))
        return out.to(g.dtype), None


def gather(table, idx):
    return _Gather.apply(table, idx)


class Search:
    """The detached closest-hit search over one scene state."""

    def __init__(self, world, tri_valid, sph_center, sph_radius, sph_valid, consts: Consts):
        with torch.no_grad():
            w = world.detach()
            self.v0 = w[:, 0]
            self.e1 = w[:, 1] - w[:, 0]
            self.e2 = w[:, 2] - w[:, 0]
            self.valid = tri_valid
            n_leaf = w.shape[0] // LEAF
            pts = w[:, :3].reshape(n_leaf, LEAF * 3, 3).float()
            ok = tri_valid.reshape(n_leaf, LEAF, 1).expand(n_leaf, LEAF, 3).reshape(
                n_leaf, LEAF * 3, 1)
            lo = torch.where(ok, pts, torch.full_like(pts, _BIG)).amin(dim=1)
            hi = torch.where(ok, pts, torch.full_like(pts, -_BIG)).amax(dim=1)
            live = ok.reshape(n_leaf, -1).any(dim=1)
            pad = BOX_PAD * (1.0 + (hi - lo).abs().amax(dim=1, keepdim=True)
                             + torch.maximum(lo.abs(), hi.abs()).amax(dim=1, keepdim=True))
            self.lo = torch.where(live[:, None], lo - pad, torch.full_like(lo, _BIG))
            self.hi = torch.where(live[:, None], hi + pad, torch.full_like(hi, -_BIG))
            self.sph_center = sph_center.detach()
            self.sph_radius = sph_radius.detach()
            self.sph_valid = sph_valid
        self.k = consts

    def _leaf_pairs(self, o, d):
        """(ray, leaf) pairs whose grown box the ray's [t_min, t_max] segment
        passes (float32, conservative)."""
        o, d = o.float(), d.float()
        tiny = d.abs() < 1e-30
        inv = 1.0 / torch.where(tiny, torch.ones_like(d), d)
        inv = torch.where(tiny, torch.full_like(d, 1e30), inv)
        rays, leaves = [], []
        step = max(1, (1 << 25) // max(1, self.lo.shape[0]))
        for a in range(0, o.shape[0], step):
            oc, ic = o[a:a + step, None], inv[a:a + step, None]
            t0 = (self.lo[None] - oc) * ic
            t1 = (self.hi[None] - oc) * ic
            tn = torch.minimum(t0, t1).amax(dim=-1)
            tf = torch.maximum(t0, t1).amin(dim=-1)
            ok = (tn <= tf) & (tf >= self.k.t_min) & (tn <= self.k.t_max)
            r, lf = ok.nonzero(as_tuple=True)
            rays.append(r + a)
            leaves.append(lf)
        return torch.cat(rays), torch.cat(leaves)

    def _triangles(self, o, d):
        """Per ray the closest accepted triangle: (t or _BIG, row, hit)."""
        R = o.shape[0]
        best_t = torch.full((R,), _BIG, dtype=torch.float32, device=o.device)
        best_i = torch.zeros((R,), dtype=torch.int64, device=o.device)
        rays, leaves = self._leaf_pairs(o, d)
        if rays.numel() == 0:
            return best_t, best_i, best_t < _BIG
        k = self.k
        pair_t, pair_i = [], []
        lane = torch.arange(LEAF, device=o.device)
        step = 1 << 18
        for a in range(0, rays.numel(), step):
            r, lf = rays[a:a + step], leaves[a:a + step]
            rows = lf[:, None] * LEAF + lane[None]
            v0, e1, e2 = self.v0[rows], self.e1[rows], self.e2[rows]
            oo, dd = o[r][:, None], d[r][:, None]
            dx, dy, dz = dd[..., 0], dd[..., 1], dd[..., 2]
            e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
            e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = 1.0 / torch.where(det.abs() < k.det_eps, torch.ones_like(det), det)
            tvx, tvy, tvz = (oo[..., 0] - v0[..., 0], oo[..., 1] - v0[..., 1],
                             oo[..., 2] - v0[..., 2])
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            acc = ((det.abs() >= k.det_eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                   & (u + v <= 1.0) & (t >= k.t_min) & (t <= k.t_max) & self.valid[rows])
            t = torch.where(acc, t.float(), torch.full_like(t, _BIG, dtype=torch.float32))
            tb, ib = t.min(dim=1)  # the first (lowest) row of the least t
            pair_t.append(tb)
            pair_i.append(rows.gather(1, ib[:, None])[:, 0])
        pt, pi = torch.cat(pair_t), torch.cat(pair_i)
        best_t.scatter_reduce_(0, rays, pt, reduce="amin")
        cand = torch.where(pt == best_t[rays], pi, torch.full_like(pi, 1 << 62))
        best_i = torch.full((R,), 1 << 62, dtype=torch.int64, device=o.device)
        best_i.scatter_reduce_(0, rays, cand, reduce="amin")
        hit = best_t < _BIG
        return best_t, torch.where(hit, best_i, torch.zeros_like(best_i)), hit

    def _spheres(self, o, d, bound):
        """Per ray the closest accepted sphere within ``bound``."""
        k = self.k
        c, r = self.sph_center.to(o.dtype), self.sph_radius.to(o.dtype)
        oc = c[None] - o[:, None]
        halfb = d[:, None, 0] * oc[..., 0] + d[:, None, 1] * oc[..., 1] + d[:, None, 2] * oc[..., 2]
        cc = oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1] + oc[..., 2] * oc[..., 2] - (r * r)[None]
        delta = halfb * halfb - cc
        sq = torch.sqrt(torch.clamp(delta, min=0.0))
        t_near = halfb - sq
        t = torch.where(t_near >= k.t_min, t_near, halfb + sq)
        acc = ((delta >= 0.0) & (t_near.float() <= bound[:, None]) & (t >= k.t_min)
               & self.sph_valid[None])
        t = torch.where(acc, t.float(), torch.full_like(t, _BIG, dtype=torch.float32))
        tb, ib = t.min(dim=1)
        return ib, acc.any(dim=1)

    @torch.no_grad()
    def winners(self, o, d):
        """(i_tri, hit_tri, i_sph, hit_sph) of every ray."""
        t_tri, i_tri, hit_tri = self._triangles(o, d)
        bound = torch.where(hit_tri, t_tri, torch.full_like(t_tri, self.k.t_max))
        i_sph, hit_sph = self._spheres(o, d, bound)
        return i_tri, hit_tri, i_sph, hit_sph


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _normalize(v):
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    safe = torch.where(n2 > 0, n2, torch.ones_like(n2))
    return v * torch.where(n2 > 0, 1.0 / torch.sqrt(safe), torch.zeros_like(n2))


def _triangle_hit(o, d, g):
    v0, v1, v2, n0, n1, n2 = g.unbind(dim=1)
    e1, e2 = v1 - v0, v2 - v0
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = gs.stable_inv_det(det, _dot(e1, e1), _dot(e2, e2))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    n = _normalize((1.0 - u - v)[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2)
    front = _dot(d, _cross(e1, e2)) < 0.0
    return o + t[:, None] * d, torch.where(front[:, None], n, -n)


def _sphere_hit(o, d, centre, radius, t_min):
    oc = centre - o
    halfb = _dot(d, oc)
    c = _dot(oc, oc) - radius * radius
    delta = halfb * halfb - c
    sq = gs.stable_sqrt_delta(delta, radius)
    t_near = halfb - sq
    t = torch.where(t_near >= t_min, t_near, halfb + sq)
    p = o + t[:, None] * d
    r_safe = torch.where(radius > 0.0, radius, torch.ones_like(radius))
    n = (p - centre) / r_safe[:, None]
    return p, torch.where((_dot(d, n) < 0.0)[:, None], n, -n)


def _onb(n):
    """Rows (u, v, w) of the basis with w = normalize(n); helper axis y where
    |w.x| > 0.9, else x."""
    w = _normalize(n)
    big_x = (w[..., 0].abs() > 0.9)[..., None]
    zero, one = torch.zeros_like(w[..., :1]), torch.ones_like(w[..., :1])
    a = torch.where(big_x, torch.cat([zero, one, zero], -1), torch.cat([one, zero, zero], -1))
    v = _cross(w, a)
    vl = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    v = v / torch.where(vl > 0, vl, torch.ones_like(vl))
    return _cross(v, w), v, w


def _scatter(u1, u2, d, p, n, kind, albedo, param, k: Consts):
    """(attenuation, cos/pdf, next origin, next direction, terminated)."""
    wo = -d
    bu, bv, bw = _onb(n)
    phi = f32(2.0 * math.pi) * u1
    r = torch.sqrt(u2)
    lx, ly, lz = torch.cos(phi) * r, torch.sin(phi) * r, torch.sqrt(1.0 - u2)
    wi = lx[:, None] * bu + ly[:, None] * bv + lz[:, None] * bw
    pdf = _dot(n, wi) / math.pi
    degen = pdf < k.pdf_eps
    wi = torch.where(degen[:, None], n, wi)
    pdf = torch.where(degen, torch.full_like(pdf, 1.0 / math.pi), pdf)
    cosw = gs.maximum(_dot(n, wi), 0.0)
    sigma = gs.clip(param, 0.0, 1.0)
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    li = gs.guarded_sqrt(wi[:, 0] ** 2 + wi[:, 1] ** 2)
    lo = gs.guarded_sqrt(wo[:, 0] ** 2 + wo[:, 1] ** 2)
    ci, si = gs.unit_xy(wi[:, 0], wi[:, 1], li)
    co, so = gs.unit_xy(wo[:, 0], wo[:, 1], lo)
    cos_dphi = ci * co + si * so
    cos_to = gs.clip(_dot(wo, n), 0.0, 1.0)
    cos_ti = gs.clip(cosw, 0.0, 1.0)
    cos_a = gs.minimum(cos_ti, cos_to)
    cos_b = gs.maximum(cos_ti, cos_to)
    sin_a = gs.guarded_sqrt(gs.maximum(1.0 - cos_a * cos_a, 0.0))
    tan_b = gs.guarded_sqrt(gs.maximum(1.0 - cos_b * cos_b, 0.0)) * gs.stable_recip_cos(cos_b)
    coeff = A + B * cos_dphi * sin_a * tan_b
    emissive = kind == 1
    one = torch.ones_like(pdf)
    atten = torch.where(emissive[:, None], param[:, None] * albedo,
                        albedo * (coeff / math.pi)[:, None])
    ratio = torch.where(emissive, one, gs.cosine_ratio(cosw, pdf))
    return atten, ratio, p + k.shadow_eps * n, wi, emissive


class Tracer:
    """Traces rays through one scene state. ``world`` (T, 6, 3) world-space
    triangles and ``params`` (the scene's float leaves, `scene.Scene.params`)
    may carry gradients; ``dtype`` is the precision of every float operation
    (float32, or bfloat16 for the control)."""

    def __init__(self, scene, world, params, consts: Consts, max_depth: int,
                 dtype=torch.float32):
        self.k = consts
        self.max_depth = max_depth
        self.dtype = dtype
        self.world = world.to(dtype)
        self.p = {key: v.to(dtype) for key, v in params.items()}
        self.tri_mat, self.sph_mat, self.mat_kind = scene.tri_mat, scene.sph_mat, scene.mat_kind
        self.search = Search(self.world, scene.tri_valid, self.p["sph_center"],
                             self.p["sph_radius"], scene.sph_valid, consts)
        self.sph_rows = torch.cat([self.p["sph_center"], self.p["sph_radius"][:, None]], dim=1)
        self.mat_rows = torch.cat([self.p["mat_albedo"], self.p["mat_param"][:, None]], dim=1)

    def _winners(self, o, d, active):
        """The search's winners of the live rays; a dead ray's are zeros (its
        factor is masked out)."""
        live = active.nonzero()[:, 0]
        R = o.shape[0]
        i_tri = torch.zeros(R, dtype=torch.int64, device=o.device)
        i_sph = torch.zeros_like(i_tri)
        hit_tri = torch.zeros(R, dtype=torch.bool, device=o.device)
        hit_sph = torch.zeros_like(hit_tri)
        if live.numel():
            a, b, c, e = self.search.winners(o[live], d[live])
            i_tri[live], hit_tri[live], i_sph[live], hit_sph[live] = a, b, c, e
        return i_tri, hit_tri, i_sph, hit_sph

    def colour(self, o, d, uniforms):
        """Raw colour (R, 3) of rays (o, d); ``uniforms(b)`` gives bounce b's
        (u1, u2) float32. Each bounce recomputes and scatters only the live
        rays that hit, each by its own winner's formula, and shades only the
        live rays that miss: no branch a ray did not take is evaluated, so
        none can put a non-finite value into the backward."""
        k = self.k
        o, d = o.to(self.dtype), d.to(self.dtype)
        R = o.shape[0]
        colour = torch.ones_like(o)
        active = torch.ones(R, dtype=torch.bool, device=o.device)
        for b in range(self.max_depth):
            i_tri, hit_tri, i_sph, hit_sph = self._winners(o.detach(), d.detach(), active)
            it = (active & hit_tri & ~hit_sph).nonzero()[:, 0]
            isp = (active & hit_sph).nonzero()[:, 0]
            miss = (active & ~hit_tri & ~hit_sph).nonzero()[:, 0]
            hits = torch.cat([it, isp])
            p_t, n_t = _triangle_hit(o[it], d[it], gather(self.world, i_tri[it]))
            srow = gather(self.sph_rows, i_sph[isp])
            p_s, n_s = _sphere_hit(o[isp], d[isp], srow[:, :3], srow[:, 3], k.t_min)
            p, n = torch.cat([p_t, p_s]), torch.cat([n_t, n_s])
            mat = torch.cat([self.tri_mat[i_tri[it]], self.sph_mat[i_sph[isp]]])
            mrow = gather(self.mat_rows, mat)
            u1, u2 = (u.to(self.dtype) for u in uniforms(b))
            atten, ratio, o_next, d_next, term = _scatter(
                u1[hits], u2[hits], d[hits], p, n, self.mat_kind[mat], mrow[:, :3], mrow[:, 3], k)
            dm = d[miss]
            a = (dm[:, 1] + 1.0) * 0.5
            sky = (1.0 - a)[:, None] * self.p["sky_bottom"] + a[:, None] * self.p["sky_top"]
            factor = torch.ones_like(o).index_put((hits,), ratio[:, None] * atten)
            colour = colour * factor.index_put((miss,), sky)
            go = hits[~term]
            active = torch.zeros_like(active).index_put((go,), torch.ones_like(go, dtype=torch.bool))
            o = o.index_put((go,), o_next[~term])
            d = d.index_put((go,), d_next[~term])
        return colour.float()


def clamp_sample(c):
    """A rendered sample: clamped to [0, 1], non-finite values set to 0."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(torch.isfinite(c), c, torch.zeros_like(c))


def average_weights(n: int):
    """float32 (1/n, (n - 1)/n) of the running average."""
    nf = np.float32(n)
    inv = np.float32(1.0) / nf
    return float(inv), float((nf - np.float32(1.0)) * inv)
