"""Batched ray–primitive intersection: the staged route's closest hit.

PyTorch port of `ptre_tpu/ops/intersect.py`. Semantics of the reference
(`shape.cu:13-46`, `:62-103`, `path_tracer.cu:252-295`), unchanged:

  * sphere: half-b quadratic with a unit direction; the near root alone is
    checked against t_max, and a near root below t_min falls back to the FAR
    root with only a t_min check (the far-root quirk);
  * triangle: Möller–Trumbore, no back-face culling, |det| < det_eps
    rejected, u/v barycentric tests, smooth normal (1-u-v) n0 + u n1 + v n2
    normalised and flipped to face the ray by the geometric normal's sign;
  * triangles first, then spheres bounded by the closest triangle; an
    accepted sphere replaces the triangle hit; ties within a class go to
    the lowest index, and a class with no hit selects index 0.

Two phases, as in the reference: a DETACHED sweep over every (ray,
primitive) pair (`sweep`) picks each ray's winner, then `closest_hit`
gathers the winner's row and re-derives (t, p, n) differentiably in O(R).

The sweep's dot and cross products are written out in the kernel's order
(a.x*b.x + a.y*b.y + a.z*b.z), one rounding per operation, so `sweep` is
the exact plain version of the sweep kernel (`ops/cuda/sweep_kernel.py`,
`csrc/sweep.cuh`, built without FMA contraction). The same quirks exist in
the dense bounce loops (`ops/cuda/megakernel.trace_block`,
`csrc/trace.cuh` ``path_bounce``); `tests/test_torch_intersect.py` holds
them to one another. Its (R, T) temporaries make `sweep` an O(R·T)-memory
function: callers on the card run it over chunks of rays.

Not ported: ``remat_pin`` (identity in value). Under rematerialisation
(`integrator.trace_staged`) the sweep runs outside the recomputed region and
its winners are passed in through ``sweep_fn``; the O(R) recompute repeats
the same operations on the same inputs (`gradsafe.remat`).
"""

from __future__ import annotations

import dataclasses

import torch

from ptre_tpu_torch.ops import gradsafe
from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.ops.cuda.take_rows import take_rows

_BIG = 1e30


@dataclasses.dataclass
class HitRecord:
    """Vectorised hit record (reference `shape.h:7-14`)."""

    t: torch.Tensor  # (R,)
    position: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3), flipped to face the ray
    front_face: torch.Tensor  # (R,) bool
    mat_id: torch.Tensor  # (R,) int
    hit: torch.Tensor  # (R,) bool


def _closest(t, accepted):
    """(best t or _BIG, lowest index of the least accepted t (0 without a
    hit, as argmin over all-_BIG gives), hit) over the last axis."""
    t_masked = torch.where(accepted, t, _BIG)
    if t_masked.shape[-1] == 0:
        zero = torch.zeros(t_masked.shape[:-1], dtype=torch.int32, device=t.device)
        return torch.full(t_masked.shape[:-1], _BIG, device=t.device), zero, zero.bool()
    idx = torch.argmin(t_masked, dim=-1, keepdim=True)
    best = torch.take_along_dim(t_masked, idx, dim=-1)[..., 0]
    hit = torch.any(accepted, dim=-1)
    return torch.where(hit, best, _BIG), idx[..., 0].to(torch.int32), hit


def _sphere_candidates(o, d, center, radius, valid, t_min, t_max):
    """Per-(ray, sphere) candidate t and acceptance, (R, S) each; ``t_max``
    a float or (R,)."""
    ocx = center[None, :, 0] - o[:, None, 0]
    ocy = center[None, :, 1] - o[:, None, 1]
    ocz = center[None, :, 2] - o[:, None, 2]
    halfb = d[:, None, 0] * ocx + d[:, None, 1] * ocy + d[:, None, 2] * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[None, :]
    delta = halfb * halfb - c
    sq = torch.sqrt(torch.clamp(delta, min=0.0))
    t_near = halfb - sq
    t = torch.where(t_near >= t_min, t_near, halfb + sq)
    if torch.is_tensor(t_max):
        t_max = t_max[:, None]
    accepted = ((delta >= 0.0) & (t_near <= t_max)  # near root only (`shape.cu:26-28`)
                & (t >= t_min) & valid[None, :].bool())
    return t, accepted


def intersect_spheres(o, d, center, radius, valid, t_min, t_max):
    """Closest accepted sphere per ray → (t, index, hit), (R,) each."""
    return _closest(*_sphere_candidates(o, d, center, radius, valid, t_min, t_max))


def _mt_t(o, d, v0, e1, e2, t_min, t_max, det_eps):
    """Möller–Trumbore t-only test of (R rays × T triangles) → (t, accepted)."""
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(torch.abs(det) < det_eps, torch.ones_like(det), det)
    tvx = o[:, None, 0] - v0[None, :, 0]
    tvy = o[:, None, 1] - v0[None, :, 1]
    tvz = o[:, None, 2] - v0[None, :, 2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    accepted = ((torch.abs(det) >= det_eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                & (u + v <= 1.0) & (t >= t_min) & (t <= t_max))
    return t, accepted


def intersect_triangles(o, d, v0, v1, v2, valid, t_min, t_max, det_eps=1e-6):
    """Closest accepted triangle per ray → (t, index, hit). ``v0``-``v2``
    are WORLD-space (T, 3) (`ScenePacket.world_triangles`)."""
    return intersect_triangle_edges(o, d, v0, v1 - v0, v2 - v0, valid, t_min, t_max,
                                    det_eps)


def intersect_triangle_edges(o, d, v0, e1, e2, valid, t_min, t_max, det_eps=1e-6):
    """`intersect_triangles` on (v0, e1 = v1 - v0, e2 = v2 - v0)."""
    t, accepted = _mt_t(o, d, v0, e1, e2, t_min, t_max, det_eps)
    return _closest(t, accepted & valid[None, :].bool())


def _plane_edges_t(o, d, v0, v1, v2, eps):
    """The reference's compiled-out plane + inside/outside edge test
    (`shape.cu:104-148`): t is rejected only when negative."""
    e1 = v1 - v0
    e2 = v2 - v0
    e12 = v2 - v1
    normal = vm.cross(e1, e2)
    ndotd = vm.dot3(d[:, None, :], normal[None])
    denom = torch.where(torch.abs(ndotd) < eps, torch.ones_like(ndotd), ndotd)
    dist = -vm.dot3(normal, v0)
    t = -(vm.dot3(o[:, None, :], normal[None]) + dist[None, :]) / denom
    p = o[:, None, :] + t[..., None] * d[:, None, :]

    def outside(a, edge):
        n2 = vm.cross(edge[None].expand_as(p), p - a[None])
        return vm.dot3(n2, normal[None]) < 0.0

    last = vm.dot3(vm.cross(p - v0[None], e2[None].expand_as(p)), normal[None]) >= 0.0
    inside = ~outside(v0, e1) & ~outside(v1, e12) & last
    return t, (torch.abs(ndotd) >= eps) & (t >= 0.0) & inside


def intersect_triangles_plane_edges(o, d, v0, v1, v2, valid, t_min, t_max, eps=1e-6):
    """Closest triangle by the plane/edge test (`shape.cu:104-148`)."""
    t, accepted = _plane_edges_t(o, d, v0, v1, v2, eps)
    if torch.is_tensor(t_max):
        t_max = t_max[:, None]
    accepted = accepted & valid[None, :].bool() & (t >= t_min) & (t <= t_max)
    return _closest(t, accepted)


def sphere_hit_attrs(o, d, t, center, radius):
    """Shading attributes of one sphere hit per ray (`shape.cu:39-45`)."""
    p = o + t[:, None] * d
    n = (p - center) / radius[:, None]
    front = vm.dot(d, n) < 0.0
    return p, torch.where(front[:, None], n, -n), front


def triangle_hit_attrs(o, d, t, v0, v1, v2, n0, n1, n2):
    """u/v and smooth normal of one triangle per ray (`shape.cu:96-101`)."""
    _, _, n, front = triangle_hit_attrs_t(o, d, v0, v1, v2, n0, n1, n2)
    return o + t[:, None] * d, n, front


def triangle_hit_attrs_t(o, d, v0, v1, v2, n0, n1, n2):
    """Differentiable recompute of (t, p, n, front) for one gathered
    triangle per ray, (R, 3) inputs; 1/det through `gradsafe.stable_inv_det`."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    inv_det = gradsafe.stable_inv_det(det, vm.dot(e1, e1), vm.dot(e2, e2))
    tvec = o - v0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    n = vm.normalize((1.0 - u - v)[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2)
    front = vm.dot(d, vm.cross(e1, e2)) < 0.0
    n = torch.where(front[:, None], n, -n)
    return t, o + t[:, None] * d, n, front


def sphere_hit_attrs_t(o, d, center, radius, t_min):
    """Differentiable recompute of (t, p, n, front) for one gathered sphere
    per ray: the near/far root rule of `shape.cu:13-46` on it, the root
    through `gradsafe.stable_sqrt_delta`, the normal divided by a radius
    guarded against 0 (a triangle row gathered through this path)."""
    oc = center - o
    halfb = vm.dot(d, oc)
    c = vm.dot(oc, oc) - radius * radius
    delta = halfb * halfb - c
    sq = gradsafe.stable_sqrt_delta(delta, radius)
    t_near = halfb - sq
    t = torch.where(t_near >= t_min, t_near, halfb + sq)
    p = o + t[:, None] * d
    r_safe = torch.where(radius > 0.0, radius, torch.ones_like(radius))
    n = (p - center) / r_safe[:, None]
    front = vm.dot(d, n) < 0.0
    return t, p, torch.where(front[:, None], n, -n), front


def sweep_edges(o, d, v0, e1, e2, tri_valid, center, radius, sph_valid, t_min,
                t_max, det_eps=1e-6):
    """The sweep on triangle rows (v0, e1, e2): (i_tri int32, hit_tri bool,
    i_sph int32, hit_sph bool), (R,) each. Spheres are bounded by the
    closest triangle (`path_tracer.cu:285-295`)."""
    with torch.no_grad():
        t_tri, i_tri, hit_tri = intersect_triangle_edges(o, d, v0, e1, e2, tri_valid,
                                                         t_min, t_max, det_eps)
        bound = torch.where(hit_tri, t_tri, torch.full_like(t_tri, t_max))
        _, i_sph, hit_sph = intersect_spheres(o, d, center, radius, sph_valid, t_min,
                                              bound)
    return i_tri, hit_tri, i_sph, hit_sph


def sweep(o, d, packet, world_tris, t_min, t_max, det_eps=1e-6):
    """Brute-force closest-hit sweep (`intersect.py:255-273`): per-ray
    winners, detached. The plain version of the sweep kernel."""
    v0, v1, v2 = world_tris[:3]
    return sweep_edges(o, d, v0, v1 - v0, v2 - v0, packet.tri_valid, packet.sph_center,
                       packet.sph_radius, packet.sph_valid, t_min, t_max, det_eps)


def closest_hit(o, d, packet, world_tris, t_min, t_max, det_eps=1e-6,
                sweep_fn=None) -> HitRecord:
    """Scene closest hit, triangles first, then spheres
    (`intersect.py:276-350`): the detached sweep (``sweep_fn``, same
    signature and returns as `sweep`, e.g. the kernel's wrapper), then ONE
    packed (R, 18) gather of the winning triangle, one (R, 4) of the winning
    sphere, and the differentiable O(R) recompute of (t, p, n)."""
    v0, v1, v2, n0, n1, n2 = world_tris
    i_tri, hit_tri, i_sph, hit_sph = (sweep_fn or sweep)(
        o.detach(), d.detach(), packet, tuple(w.detach() for w in world_tris),
        t_min, t_max, det_eps)
    i_tri, i_sph = i_tri.long(), i_sph.long()
    gt = take_rows(torch.cat([v0, v1, v2, n0, n1, n2], dim=1), i_tri)
    t_tri, p_tri, n_tri, f_tri = triangle_hit_attrs_t(
        o, d, gt[:, 0:3], gt[:, 3:6], gt[:, 6:9], gt[:, 9:12], gt[:, 12:15], gt[:, 15:18])
    gs = take_rows(torch.cat([packet.sph_center, packet.sph_radius[:, None]], dim=1), i_sph)
    t_sph, p_sph, n_sph, f_sph = sphere_hit_attrs_t(o, d, gs[:, 0:3], gs[:, 3], t_min)
    use_sph = hit_sph
    sel = use_sph[:, None]
    big = torch.full_like(t_tri, _BIG)
    return HitRecord(
        t=torch.where(use_sph, t_sph, torch.where(hit_tri, t_tri, big)),
        position=torch.where(sel, p_sph, p_tri),
        normal=torch.where(sel, n_sph, n_tri),
        front_face=torch.where(use_sph, f_sph, f_tri),
        mat_id=torch.where(use_sph, packet.sph_mat.long()[i_sph],
                           packet.tri_mat.long()[i_tri]),
        hit=hit_tri | hit_sph,
    )
