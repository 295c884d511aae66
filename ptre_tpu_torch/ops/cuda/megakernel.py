"""Scene packing, the plain PyTorch bounce loops, the recording forward of
the dense class and the culled megakernel of triangle-scale scenes.

Port of `ptre_tpu/ops/pallas/megakernel.py`:

  * `pack_tri32` / `pack_sph16` / `pack_mats` (`megakernel.py:169-223`) —
    the flat tables the kernel stages into shared memory;
  * `dense_supported` (`megakernel.py:1110`) — the ≤64-triangle,
    ≤64-sphere, ≤8-material class the serial-sweep kernel takes;
  * `trace_block` + `scatter_shade` — the plain PyTorch version of
    `_trace_block` (`megakernel.py:811`) and `_scatter_shade`
    (`megakernel.py:611`), vectorised over rays and looping over
    primitives. Their CUDA twins are `path_bounce` / `scatter_shade` in
    `csrc/trace.cuh`; the three are written in the same operation order so
    that they agree to float rounding;
  * `trace_fused_sel` — the recording forward of the gradient path
    (`_mega_kernel_dense` with ``record_sel``, `megakernel.py:734`): the
    wrapper of `csrc/record_kernel.cu` (counted in ``record_launches``),
    with `trace_record_reference` (``trace_block(record=True)``) as its
    plain version, and the argument checks shared by the CUDA wrappers;
  * `trace_culled` / `trace_culled_sel` — the culled megakernel
    (`_mega_kernel`, `megakernel.py:237`): the whole bounce loop of one
    sample over Morton-ordered 64-row leaves with a two-level slab cull
    bounded by the best hit, in one launch of `csrc/mega_kernel.cu` (counted
    in ``culled_launches``), with `trace_culled_reference` as its plain
    version. Its sweep and finish (`sweep_leaf_reference`,
    `finish_bounce_reference`) are the wavefront bounce's
    (`ops/cuda/wavefront.py`), so the two forwards agree bit for bit in
    their plain versions.

Integrator semantics are the reference's: closest hit with triangles first
and spheres bounded by the closest triangle (including the far-root quirk),
ties to the lowest index, emission as a terminal multiplicative factor, the
sky gradient on a miss, the degenerate-pdf fallback and shadow-epsilon
offsets along the final normal.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.ops.cuda import build

_BIG = float(np.float32(3e38))
_TAU = float(np.float32(2.0 * 3.14159265358979))
_INV_PI = float(np.float32(1.0 / 3.14159265358979))
MAX_MATS = 8
DENSE_MAX_TRI = 64  # shared memory: 64 * 32 * 4 B = 8 KiB
DENSE_MAX_SPH = 64


def f32(x) -> float:
    """A Python float holding ``x`` rounded to float32, so scalar operands
    enter every tensor op with the kernel's float32 value."""
    return float(np.float32(x))


def dense_supported(packet) -> bool:
    """Whether the dense (serial shared-memory sweep) kernel takes the packet."""
    return (
        max(int(packet.num_triangles), 1) <= DENSE_MAX_TRI
        and max(int(packet.num_spheres), 1) <= DENSE_MAX_SPH
        and packet.num_materials <= MAX_MATS
    )


def pack_tri32(v0, v1, v2, n0, n1, n2, valid, mat):
    """(T, 32): v0 v1 v2 (0-8), n0 n1 n2 (9-17), valid (18), mat (19)."""
    T = v0.shape[0]
    return torch.cat(
        [v0, v1, v2, n0, n1, n2, valid[:, None].float(), mat[:, None].float(),
         torch.zeros((T, 12), dtype=torch.float32, device=v0.device)], dim=1)


def pack_sph16(center, radius, valid, mat):
    """(S, 16): center (0-2), radius (3), valid (4), mat (5)."""
    S = center.shape[0]
    return torch.cat(
        [center, radius[:, None], valid[:, None].float(), mat[:, None].float(),
         torch.zeros((S, 10), dtype=torch.float32, device=center.device)], dim=1)


def pack_mats(kind, albedo, param):
    """(8, 8): kind (0), albedo (1-3), param (4); rows zero-padded to 8."""
    M = kind.shape[0]
    if M > MAX_MATS:
        raise ValueError(f"the dense kernel takes <= {MAX_MATS} materials, got {M}")
    out = torch.zeros((MAX_MATS, 8), dtype=torch.float32, device=kind.device)
    out[:M, 0] = kind.float()
    out[:M, 1:4] = albedo
    out[:M, 4] = param
    return out


#: sentinel magnitude of an empty box (`megakernel.py:61`): lo > hi, finite
BOX_INF = 1e30


def morton_order(v0, v1, v2, valid):
    """(T,) int64 permutation sorting triangles along a Z-curve of their
    centroids, invalid rows last (`megakernel.py:73-105`). The 30-bit codes
    are built in int64 (torch has no uint32) and sorted STABLY, as
    `jnp.argsort` sorts, so equal codes keep row order."""
    c = (v0 + v1 + v2) * (1.0 / 3.0)
    vf = valid.to(torch.float32)[:, None]
    big = torch.where(vf > 0.5, c, torch.zeros_like(c))
    n_valid = torch.clamp(torch.sum(vf), min=1.0)
    mean = torch.sum(big, dim=0) / n_valid
    lo = torch.amin(torch.where(vf > 0.5, c, mean), dim=0)
    hi = torch.amax(torch.where(vf > 0.5, c, mean), dim=0)
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((c - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    key = torch.where(valid.bool(), code, 0xFFFFFFFF)
    return torch.argsort(key, stable=True)


def empty_boxes(n: int, device=None):
    """(n, 8) always-miss box rows: lo = +BOX_INF > hi = -BOX_INF
    (`megakernel.py:132-136`)."""
    boxes = torch.zeros((n, 8), dtype=torch.float32, device=device)
    boxes[:, 0:3] = BOX_INF  # filled on the device: no host copy, no sync
    boxes[:, 3:6] = -BOX_INF
    return boxes


def pack_tile_boxes(v0, v1, v2, valid, tile: int):
    """(ceil(T / tile), 8) per-tile AABBs of Morton-ordered triangle rows:
    lo.xyz hi.xyz 0 0 (`megakernel.py:108-129`). Invalid rows and the
    padding of the last tile contribute an empty box."""
    T = v0.shape[0]
    pad = (-T) % tile
    vf = valid.to(torch.float32)[:, None]
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    lo = torch.where(vf > 0.5, lo, BOX_INF)
    hi = torch.where(vf > 0.5, hi, -BOX_INF)
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, 3), BOX_INF)])
        hi = torch.cat([hi, hi.new_full((pad, 3), -BOX_INF)])
    n_tiles = lo.shape[0] // tile
    tlo = torch.amin(lo.reshape(n_tiles, tile, 3), dim=1)
    thi = torch.amax(hi.reshape(n_tiles, tile, 3), dim=1)
    return torch.cat([tlo, thi, tlo.new_zeros((n_tiles, 2))], dim=1)


@dataclasses.dataclass
class PackedScene:
    """The kernel's view of a packet: world-space tables, on the packet's
    device. Built once per `render_step`, reused by every sample."""

    tris: torch.Tensor  # (n_tri, 32)
    sphs: torch.Tensor  # (n_sph, 16)
    mats: torch.Tensor  # (8, 8)
    sky: torch.Tensor  # (8,): bottom rgb, top rgb, 0, 0
    n_tri: int
    n_sph: int
    num_mats: int
    tri_rows: int  # the packet's padded triangle rows: sphere s is row T + s
    #              of the unified table (`ops/path_replay.build_table`)


def pack_scene(packet) -> PackedScene:
    """Pack a dense-class packet (`render_kernel.py:279-308`): the first
    max(count, 1) rows of each table — an empty class keeps one invalid
    padding row, so the sweep always has a row to read."""
    v0, v1, v2, n0, n1, n2 = packet.world_triangles()
    nt = max(int(packet.num_triangles), 1)
    ns = max(int(packet.num_spheres), 1)
    dev = packet.device
    if v0.shape[0] == 0:
        tris = torch.zeros((1, 32), dtype=torch.float32, device=dev)
    else:
        tris = pack_tri32(v0[:nt], v1[:nt], v2[:nt], n0[:nt], n1[:nt],
                          n2[:nt], packet.tri_valid[:nt], packet.tri_mat[:nt])
    if packet.sph_center.shape[0] == 0:
        sphs = torch.zeros((1, 16), dtype=torch.float32, device=dev)
    else:
        sphs = pack_sph16(packet.sph_center[:ns], packet.sph_radius[:ns],
                          packet.sph_valid[:ns], packet.sph_mat[:ns])
    sky = torch.cat([packet.sky_bottom, packet.sky_top,
                     torch.zeros(2, dtype=torch.float32, device=dev)])
    return PackedScene(
        tris=tris.contiguous(), sphs=sphs.contiguous(),
        mats=pack_mats(packet.mat_kind, packet.mat_albedo, packet.mat_param),
        sky=sky.contiguous(), n_tri=tris.shape[0],
        n_sph=sphs.shape[0], num_mats=int(packet.num_materials),
        tri_rows=int(packet.tri_v0.shape[0]))


@dataclasses.dataclass(frozen=True)
class TraceConsts:
    """Float32-rounded integrator scalars (`RenderConfig`)."""

    t_min: float
    t_max: float
    det_eps: float
    shadow_eps: float
    pdf_eps: float

    @classmethod
    def from_config(cls, config) -> "TraceConsts":
        return cls(f32(config.t_min), f32(config.t_max), f32(config.det_eps),
                   f32(config.shadow_eps), f32(config.pdf_eps))


def sky_color(dy, sky):
    """Miss shading: vertical gradient on the incoming direction's y
    (`megakernel.py:706-713`)."""
    a = (dy + 1.0) * 0.5
    return tuple((1.0 - a) * sky[c] + a * sky[3 + c] for c in range(3))


def scatter_shade(nx, ny, nz, dx, dy, dz, mat_id, u1, u2, mats, num_mats,
                  pdf_eps):
    """Material select + ONB cosine scatter + Oren–Nayar / emissive weight
    for hit rays (`megakernel.py:611-714`; the sky-on-miss select is the
    caller's). ``mats`` is the (8, 8) table as nested Python floats.
    Returns (f_r, f_g, f_b, wix, wiy, wiz, is_emissive)."""
    zero = torch.zeros_like(nx)
    m_kind, m_ar, m_ag, m_ab, m_param = zero, zero, zero, zero, zero
    for m in range(num_mats):
        is_m = torch.abs(mat_id - float(m)) < 0.5
        row = mats[m]
        m_kind = torch.where(is_m, row[0], m_kind)
        m_ar = torch.where(is_m, row[1], m_ar)
        m_ag = torch.where(is_m, row[2], m_ag)
        m_ab = torch.where(is_m, row[3], m_ab)
        m_param = torch.where(is_m, row[4], m_param)
    is_emissive = m_kind > 0.5

    # cosine-weighted sample in the ONB (onb.h + random.cu:96-107)
    phi = _TAU * u1
    sr_ = torch.sqrt(u2)
    lx = torch.cos(phi) * sr_
    ly = torch.sin(phi) * sr_
    lz = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    big_x = torch.abs(nx) > 0.9
    ax = torch.where(big_x, 0.0, 1.0 + zero)
    ay = torch.where(big_x, 1.0, zero)
    vx = ny * 0.0 - nz * ay
    vy = nz * ax - nx * 0.0
    vz = nx * ay - ny * ax
    vlen = torch.sqrt(vx * vx + vy * vy + vz * vz)
    vinv = 1.0 / torch.where(vlen > 0.0, vlen, 1.0 + zero)
    vx, vy, vz = vx * vinv, vy * vinv, vz * vinv
    ux = vy * nz - vz * ny
    uy = vz * nx - vx * nz
    uz = vx * ny - vy * nx
    wix = lx * ux + ly * vx + lz * nx
    wiy = lx * uy + ly * vy + lz * ny
    wiz = lx * uz + ly * vz + lz * nz

    ndotwi = nx * wix + ny * wiy + nz * wiz
    pdf = ndotwi * _INV_PI
    degen = pdf < pdf_eps
    wix = torch.where(degen, nx, wix)
    wiy = torch.where(degen, ny, wiy)
    wiz = torch.where(degen, nz, wiz)
    pdf = torch.where(degen, _INV_PI + zero, pdf)
    ndotwi = torch.where(degen, 1.0 + zero, ndotwi)
    cosw = torch.clamp(ndotwi, min=0.0)

    # Oren–Nayar A/B (material.cu:20-41), transcendental-free world-frame form
    sigma = torch.clamp(m_param, 0.0, 1.0)
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    wox, woy, woz = -dx, -dy, -dz
    li = torch.sqrt(wix * wix + wiy * wiy)
    lo = torch.sqrt(wox * wox + woy * woy)
    li_safe = torch.where(li > 0, li, 1.0 + zero)
    lo_safe = torch.where(lo > 0, lo, 1.0 + zero)
    ci_ = torch.where(li > 1e-12, wix / li_safe, 1.0 + zero)
    si_ = torch.where(li > 1e-12, wiy / li_safe, zero)
    co_ = torch.where(lo > 1e-12, wox / lo_safe, 1.0 + zero)
    so_ = torch.where(lo > 1e-12, woy / lo_safe, zero)
    cos_dphi = ci_ * co_ + si_ * so_
    cos_to = torch.clamp(wox * nx + woy * ny + woz * nz, 0.0, 1.0)
    cos_ti = torch.clamp(ndotwi, 0.0, 1.0)
    cos_a = torch.minimum(cos_ti, cos_to)
    cos_b = torch.maximum(cos_ti, cos_to)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    tan_b = torch.sqrt(torch.clamp(1.0 - cos_b * cos_b, min=0.0)) / torch.clamp(
        cos_b, min=1e-6)
    coeff = (A + B * cos_dphi * sin_a * tan_b) * _INV_PI

    w_pdf = torch.where(is_emissive, 1.0 + zero, cosw / pdf)
    f = [w_pdf * torch.where(is_emissive, m_param * alb, alb * coeff)
         for alb in (m_ar, m_ag, m_ab)]
    return f[0], f[1], f[2], wix, wiy, wiz, is_emissive


def trace_block(o, d, scene: PackedScene, consts: TraceConsts, get_uniforms,
                max_depth: int, record: bool = False):
    """Masked bounce loop over a batch of rays (any common shape) → linear
    color (r, g, b). ``o``/``d`` are (x, y, z) tuples of float32 tensors;
    ``get_uniforms(bounce)`` returns that bounce's (u1, u2).

    With ``record`` it also returns the selections, (max_depth, *shape)
    int32: per bounce the winner's unified table row (``j`` for triangle j,
    ``scene.tri_rows + s`` for sphere s), -1 where the bounce missed or the
    path had already ended (`_trace_block` `:933-937` records the same
    winner; its dead-ray rows differ, see `trace_fused_sel`).

    Every bounce runs on every ray: a dead ray's bounce is a no-op (its
    factor is 1), which is what the reference's per-block skip and the CUDA
    kernel's per-thread ``break`` rely on."""
    ox, oy, oz = o
    dx, dy, dz = d
    k = consts
    # per-primitive scalars computed once in float32 (as the kernel does
    # per thread), then read as Python floats: exact float32 values
    tr = scene.tris.float()
    v0 = tr[:, 0:3]
    e1 = tr[:, 3:6] - v0
    e2 = tr[:, 6:9] - v0
    gn = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    tri_rows = torch.cat([v0, e1, e2, tr[:, 9:20], gn], dim=1).tolist()
    sp = scene.sphs.float()
    sph_rows = sp[:, 0:6].tolist()
    # inverse radius guarded against r = 0 (`megakernel.py:925`)
    inv_r = (1.0 / torch.where(sp[:, 3] == 0.0, 1.0, sp[:, 3])).tolist()
    mats = scene.mats.float().tolist()
    sky = scene.sky.float().tolist()

    cr = torch.ones_like(ox)
    cg = torch.ones_like(ox)
    cb = torch.ones_like(ox)
    active = torch.ones_like(ox, dtype=torch.bool)
    zero = torch.zeros_like(ox)
    izero = torch.zeros_like(ox, dtype=torch.int32)
    sels = []
    for bounce in range(max_depth):
        # ---- triangle sweep: strict t < best keeps the lowest index -------
        tri_t = zero + _BIG
        tri_hit = torch.zeros_like(active)
        bnx, bny, bnz, tri_mat = zero, zero, zero, zero
        tri_idx = izero
        for j, row in enumerate(tri_rows):
            (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
             n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z, valid, mat,
             gnx, gny, gnz) = row
            if not valid > 0.5:
                continue  # an invalid row accepts nothing: it changes nothing
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = 1.0 / torch.where(torch.abs(det) < k.det_eps, 1.0 + zero, det)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            acc = ((torch.abs(det) >= k.det_eps) & (u >= 0.0) & (u <= 1.0)
                   & (v >= 0.0) & (u + v <= 1.0) & (t >= k.t_min)
                   & (t <= k.t_max))
            upd = acc & (t < tri_t)
            # interpolated normal, sign-flipped from the geometric normal
            # before normalising (`megakernel.py:878-889`)
            w_ = 1.0 - u - v
            sign = torch.where(dx * gnx + dy * gny + dz * gnz < 0.0, 1.0 + zero,
                          -1.0 + zero)
            inx = w_ * n0x + u * n1x + v * n2x
            iny = w_ * n0y + u * n1y + v * n2y
            inz = w_ * n0z + u * n1z + v * n2z
            tri_t = torch.where(upd, t, tri_t)
            bnx = torch.where(upd, inx * sign, bnx)
            bny = torch.where(upd, iny * sign, bny)
            bnz = torch.where(upd, inz * sign, bnz)
            tri_mat = torch.where(upd, mat, tri_mat)
            tri_idx = torch.where(upd, j, tri_idx)
            tri_hit = tri_hit | acc
        tri_best = torch.where(tri_hit, tri_t, k.t_max + zero)

        # ---- spheres, bounded by the closest triangle ---------------------
        sph_t = zero + _BIG
        sph_hit = torch.zeros_like(active)
        s_cx, s_cy, s_cz, s_ir, sph_mat = zero, zero, zero, zero, zero
        sph_idx = izero
        for s, ((cx, cy, cz, r, valid, mat), ir) in enumerate(zip(sph_rows, inv_r)):
            if not valid > 0.5:
                continue
            ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
            halfb = dx * ocx + dy * ocy + dz * ocz
            c = ocx * ocx + ocy * ocy + ocz * ocz - f32(r * r)
            delta = halfb * halfb - c
            sq = torch.sqrt(torch.clamp(delta, min=0.0))
            t_near = halfb - sq
            t = torch.where(t_near >= k.t_min, t_near, halfb + sq)
            # far-root quirk: acceptance bounds t_near, not t
            acc = (delta >= 0.0) & (t_near <= tri_best) & (t >= k.t_min)
            upd = acc & (t < sph_t)
            sph_t = torch.where(upd, t, sph_t)
            s_cx = torch.where(upd, cx, s_cx)
            s_cy = torch.where(upd, cy, s_cy)
            s_cz = torch.where(upd, cz, s_cz)
            s_ir = torch.where(upd, ir, s_ir)
            sph_mat = torch.where(upd, mat, sph_mat)
            sph_idx = torch.where(upd, s, sph_idx)
            sph_hit = sph_hit | acc

        hit = tri_hit | sph_hit
        use_sph = sph_hit
        if record:
            row = torch.where(use_sph, sph_idx + scene.tri_rows, tri_idx)
            sels.append(torch.where(active & hit, row, -1).to(torch.int32))

        # ---- merge winner, finish the normal ------------------------------
        t_hit = torch.where(use_sph, sph_t, tri_t)
        px = ox + t_hit * dx
        py = oy + t_hit * dy
        pz = oz + t_hit * dz
        snx = (px - s_cx) * s_ir
        sny = (py - s_cy) * s_ir
        snz = (pz - s_cz) * s_ir
        s_sign = torch.where(dx * snx + dy * sny + dz * snz < 0.0, 1.0 + zero,
                        -1.0 + zero)
        nx = torch.where(use_sph, snx * s_sign, bnx)
        ny = torch.where(use_sph, sny * s_sign, bny)
        nz = torch.where(use_sph, snz * s_sign, bnz)
        nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
        ninv = torch.where(nlen > 0.0, 1.0 / torch.where(nlen > 0.0, nlen, 1.0 + zero), zero)
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
        mat_id = torch.where(use_sph, sph_mat, tri_mat)

        u1, u2 = get_uniforms(bounce)
        f_r, f_g, f_b, wix, wiy, wiz, is_emissive = scatter_shade(
            nx, ny, nz, dx, dy, dz, mat_id, u1, u2, mats, scene.num_mats,
            k.pdf_eps)
        sky_r, sky_g, sky_b = sky_color(dy, sky)
        cr = cr * torch.where(active, torch.where(hit, f_r, sky_r), 1.0 + zero)
        cg = cg * torch.where(active, torch.where(hit, f_g, sky_g), 1.0 + zero)
        cb = cb * torch.where(active, torch.where(hit, f_b, sky_b), 1.0 + zero)

        # next ray along the final normal (`megakernel.py:967-977`)
        nxt = active & hit & ~is_emissive
        ox = torch.where(nxt, px + k.shadow_eps * nx, ox)
        oy = torch.where(nxt, py + k.shadow_eps * ny, oy)
        oz = torch.where(nxt, pz + k.shadow_eps * nz, oz)
        dx = torch.where(nxt, wix, dx)
        dy = torch.where(nxt, wiy, dy)
        dz = torch.where(nxt, wiz, dz)
        active = nxt
    if record:
        return cr, cg, cb, torch.stack(sels)
    return cr, cg, cb


# ---- recording forward of the gradient path ---------------------------------

#: kernel launches made by `trace_fused_sel` in this process
record_launches = 0
#: the counters a launch of the render or recording kernel adds to
#: ``stats`` (trace.cuh kStats): paths started, live ray-bounces (sweeps),
#: hits, warp-bounces issued, and the triangle rows tested (those of the row
#: groups whose box the ray passes)
DENSE_STATS = ("paths_started", "live_bounces", "hits", "warp_bounces", "rows_tested")
#: bounces the CUDA kernels keep per-thread state for (`kMaxDepth`, trace.cuh)
MAX_DEPTH = 8


class TraceParams(ctypes.Structure):
    """Arguments of the recording and fused backward kernels; field for
    field `ptre::TraceParams` (trace.cuh), every field 4 bytes."""

    _fields_ = [
        ("t_min", ctypes.c_float), ("t_max", ctypes.c_float),
        ("det_eps", ctypes.c_float), ("shadow_eps", ctypes.c_float),
        ("pdf_eps", ctypes.c_float),
        ("seed_lo", ctypes.c_uint32), ("seed_hi", ctypes.c_uint32),
        ("sample", ctypes.c_uint32),
        ("n_rays", ctypes.c_int32), ("n_tri", ctypes.c_int32),
        ("n_sph", ctypes.c_int32), ("num_mats", ctypes.c_int32),
        ("max_depth", ctypes.c_int32), ("sph_offset", ctypes.c_int32),
        ("n_rows", ctypes.c_int32), ("external_rng", ctypes.c_int32),
    ]


def trace_params(n_rays: int, consts: TraceConsts, max_depth: int, seed: int,
                 sample: int, external_rng: bool, scene: PackedScene = None,
                 sph_offset: int = 0, n_rows: int = 0) -> TraceParams:
    """The kernels' arguments. The recording kernel reads the ``scene``
    counts (and its sphere offset); the backward kernel ``sph_offset`` and
    the table's ``n_rows``."""
    p = TraceParams()
    p.t_min, p.t_max, p.det_eps = consts.t_min, consts.t_max, consts.det_eps
    p.shadow_eps, p.pdf_eps = consts.shadow_eps, consts.pdf_eps
    p.seed_lo, p.seed_hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    p.sample = sample & 0xFFFFFFFF
    p.n_rays, p.max_depth, p.external_rng = n_rays, max_depth, int(external_rng)
    p.sph_offset, p.n_rows = sph_offset, n_rows
    if scene is not None:
        p.n_tri, p.n_sph, p.num_mats = scene.n_tri, scene.n_sph, scene.num_mats
        p.sph_offset = scene.tri_rows
    return p


def trace_uniforms(o, max_depth: int, seed: int, sample: int, urand=None):
    """The (2 + 2*max_depth, R) uniforms of a trace: ``urand`` as given, or
    the Philox draws keyed by (seed, ray, sample, draw) the kernels make."""
    if urand is not None:
        return urand
    return rng.ray_uniforms(seed, sample, o.shape[0], 1 + max_depth, o.device)


def trace_record_reference(o, d, scene: PackedScene, consts: TraceConsts,
                           max_depth: int, seed: int = 0, sample: int = 0,
                           urand=None):
    """Plain PyTorch version of the recording kernel: (R, 3) rays → (color
    (R, 3) unclamped, selections (max_depth, R) int32)."""
    ur = trace_uniforms(o, max_depth, seed, sample, urand)
    cr, cg, cb, sel = trace_block(
        o.unbind(dim=1), d.unbind(dim=1), scene, consts,
        lambda b: (ur[2 + 2 * b], ur[3 + 2 * b]), max_depth, record=True)
    return torch.stack([cr, cg, cb], dim=1), sel


def check_tensors(ref: str, device, expected):
    """Raise unless every (name, tensor, shape, dtype) entry is a contiguous
    tensor of that dtype and shape on ``device``, the device of ``ref``."""
    for name, t, shape, dtype in expected:
        if t.device != device:
            raise RendererError(f"{name} is on {t.device}, {ref} on {device}")
        if t.dtype != dtype or not t.is_contiguous():
            want = str(dtype).replace("torch.", "")
            raise RendererError(f"{name} must be contiguous {want}, got "
                                f"{t.dtype} contiguous={t.is_contiguous()}")
        if tuple(t.shape) != tuple(shape):
            raise RendererError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def check_rays(o, d, max_depth: int, urand=None, extra=()):
    """The checks shared by the recording and backward kernels: (R, 3) float32
    rays, (2 + 2*max_depth, R) uniforms if given, ``extra`` entries, all on
    ``o``'s device, and ``1 <= max_depth <= MAX_DEPTH``."""
    R = o.shape[0] if o.dim() == 2 else -1
    expected = [("o", o, (R, 3), torch.float32), ("d", d, (R, 3), torch.float32)]
    if urand is not None:
        expected.append(("urand", urand, (2 + 2 * max_depth, R), torch.float32))
    check_tensors("o", o.device, expected + list(extra))
    if not 1 <= max_depth <= MAX_DEPTH:
        raise RendererError(f"the CUDA kernels take 1 <= max_depth <= {MAX_DEPTH}, "
                            f"got {max_depth}")


def check_stats(stats, lens, lens_shape):
    """The `check_tensors` entries of a dense kernel's ``stats`` ((5,)
    int64) and ``lens`` (``lens_shape`` int32, given only with ``stats``),
    each or none."""
    if lens is not None and stats is None:
        raise RendererError("lens is written by the counting instantiation: give stats too")
    return ([] if stats is None else [("stats", stats, (len(DENSE_STATS),), torch.int64)]) + (
        [] if lens is None else [("lens", lens, lens_shape, torch.int32)])


def check_scene(scene: PackedScene, ref: str, device):
    """Raise unless the packed scene lies on ``device`` (that of ``ref``) and
    is dense-class."""
    check_tensors(ref, device, [("tris", scene.tris, (scene.n_tri, 32), torch.float32),
                           ("sphs", scene.sphs, (scene.n_sph, 16), torch.float32),
                           ("mats", scene.mats, (MAX_MATS, 8), torch.float32),
                           ("sky", scene.sky, (8,), torch.float32)])
    if not (1 <= scene.n_tri <= DENSE_MAX_TRI and 1 <= scene.n_sph <= DENSE_MAX_SPH
            and scene.num_mats <= MAX_MATS):
        raise RendererError(
            f"the dense kernels take <= {DENSE_MAX_TRI} triangles, <= "
            f"{DENSE_MAX_SPH} spheres, <= {MAX_MATS} materials; got "
            f"{scene.n_tri}, {scene.n_sph}, {scene.num_mats}")


def trace_fused_sel(o, d, scene: PackedScene, consts: TraceConsts,
                    max_depth: int, seed: int = 0, sample: int = 0,
                    urand=None, stats=None, lens=None):
    """Trace one sample per ray and record per-bounce selections: the
    forward half of the gradient path (`megakernel.trace_fused_sel` with
    ``planar="color"``). Returns (color (R, 3) float32 unclamped,
    selections (max_depth, R) int32).

    CUDA tensors launch `csrc/record_kernel.cu` (counted in
    ``record_launches``); CPU tensors run `trace_record_reference`; anything
    else raises. Uniforms: ``urand`` (2 + 2*max_depth, R), or Philox draws
    keyed by (seed, ray, sample, draw) when None. ``stats`` (5,) int64 on
    the card, or None, receives the counters named in DENSE_STATS (the
    kernel's counting instantiation); ``lens`` (R,) int32, or None, each
    ray's path length in bounces (given only with ``stats``).

    The reference's dead-ray rows differ by design: its kernel writes tri,
    sph and use_sph for every lane of a live block and masks only the hit
    row with ``hit & active``; here a bounce that did not hit, or came after
    the path ended, is -1 — all the backward reads (`fused_grad.py:157-170`).
    """
    global record_launches
    if o.device.type == "cpu":
        return trace_record_reference(o, d, scene, consts, max_depth, seed,
                                      sample, urand)
    if o.device.type != "cuda":
        raise RendererError(f"trace_fused_sel runs on cuda or cpu, not {o.device}")
    check_rays(o, d, max_depth, urand, check_stats(stats, lens, (o.shape[0],)))
    check_scene(scene, "o", o.device)
    R = o.shape[0]
    color = torch.empty((R, 3), dtype=torch.float32, device=o.device)
    sel = torch.empty((max_depth, R), dtype=torch.int32, device=o.device)
    params = trace_params(R, consts, max_depth, seed, sample,
                          external_rng=urand is not None, scene=scene)
    lib = build.load_library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.ptre_trace_record(
            ctypes.addressof(params), o.data_ptr(), d.data_ptr(),
            None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
            scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr(),
            color.data_ptr(), sel.data_ptr(), None if stats is None else stats.data_ptr(),
            None if lens is None else lens.data_ptr(), stream)
    if rc != 0:
        raise RendererError(
            f"record kernel launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    record_launches += 1
    return color, sel


# ---- one bounce over 64-row leaves: the pieces the wavefront's bounce and the
# ---- culled megakernel share (csrc/wave.cuh) -----------------------------------

#: triangle rows per leaf: the sweep and cull granularity (`_CULL_TILE`)
LEAF = 64
#: leaves per supertile, the culled sweep's second level (`_SUPER_TILE`)
SUPER = 8


class WaveParams(ctypes.Structure):
    """Field for field `ptre::WaveParams` (wave.cuh), every field 4 bytes."""

    _fields_ = [
        ("t_min", ctypes.c_float), ("t_max", ctypes.c_float),
        ("det_eps", ctypes.c_float), ("shadow_eps", ctypes.c_float),
        ("pdf_eps", ctypes.c_float),
        ("seed_lo", ctypes.c_uint32), ("seed_hi", ctypes.c_uint32),
        ("sample", ctypes.c_uint32),
        ("n_rays", ctypes.c_int32), ("r_pad", ctypes.c_int32),
        ("n_leaf", ctypes.c_int32), ("list_stride", ctypes.c_int32),
        ("n_sph", ctypes.c_int32), ("num_mats", ctypes.c_int32),
        ("bounce", ctypes.c_int32), ("external_rng", ctypes.c_int32),
        ("sph_offset", ctypes.c_int32), ("n_sel", ctypes.c_int32),
    ]


class MegaParams(ctypes.Structure):
    """Field for field `ptre::MegaParams` (wave.cuh)."""

    _fields_ = [("w", WaveParams), ("max_depth", ctypes.c_int32),
                ("n_super", ctypes.c_int32), ("cull", ctypes.c_int32)]


def wave_params(consts: TraceConsts, seed: int, sample: int, scene, **fields) -> WaveParams:
    """The scalars, the seed and the scene's counts; ``fields`` the rest."""
    k = consts
    return WaveParams(
        t_min=k.t_min, t_max=k.t_max, det_eps=k.det_eps, shadow_eps=k.shadow_eps,
        pdf_eps=k.pdf_eps, seed_lo=seed & 0xFFFFFFFF, seed_hi=(seed >> 32) & 0xFFFFFFFF,
        sample=sample & 0xFFFFFFFF, n_leaf=scene.n_leaf, n_sph=scene.n_sph,
        num_mats=scene.num_mats, sph_offset=scene.tri_rows, **fields)


def pack_super_boxes(boxes, sup: int = SUPER):
    """(n_tiles, 8) tile boxes → (ceil(n_tiles / sup), 8) supertile union
    boxes, lo.xyz hi.xyz 0 0; padding tiles are empty
    (`megakernel.py:139-150`)."""
    pad = (-boxes.shape[0]) % sup
    if pad:
        boxes = torch.cat([boxes, empty_boxes(pad, boxes.device)])
    m = boxes.reshape(-1, sup, 8)
    lo = torch.amin(m[:, :, 0:3], dim=1)
    hi = torch.amax(m[:, :, 3:6], dim=1)
    return torch.cat([lo, hi, lo.new_zeros((lo.shape[0], 2))], dim=1)


def slab_inv(c):
    """Direction reciprocal clamped away from 0 (`wavefront.py:138-141`)."""
    return 1.0 / torch.where(torch.abs(c) < 1e-12,
                             torch.where(c >= 0.0, 1e-12, -1e-12), c)


def slab_interval(box, o, iv):
    """(t_near, t_far) of rays ``o`` (3 rows), inverse directions ``iv``
    through one box, six Python floats lo.xyz hi.xyz (wave.cuh
    slab_interval)."""
    tn = tf = None
    for c in range(3):
        lo, hi = box[c], box[3 + c]
        pos = iv[c] >= 0.0
        tnk = (torch.where(pos, lo, hi) - o[c]) * iv[c]
        tfk = (torch.where(pos, hi, lo) - o[c]) * iv[c]
        tn = tnk if tn is None else torch.maximum(tn, tnk)
        tf = tfk if tf is None else torch.minimum(tf, tfk)
    return tn, tf


def bounce_uniforms(ids, bounce: int, seed: int, sample: int, urand=None):
    """(u1, u2) of bounce ``bounce`` for the rays numbered ``ids``: rows 2 + 2b
    and 3 + 2b of ``urand`` (2 + 2 * max_depth, R) at the ids (ids past R
    belong to padding rays, which are dead: they read column 0), or the
    Philox pair 1 + b keyed by (seed, id, sample)."""
    if urand is None:
        return rng.pair_uniforms(seed, sample, ids, 1 + bounce)
    col = torch.where(ids < urand.shape[1], ids, 0).long()
    return urand[2 + 2 * bounce][col], urand[3 + 2 * bounce][col]


class TriBest:
    """The closest triangle so far of every ray of a state (wave.cuh
    TriBest): t, row and whether any row was accepted."""

    def __init__(self, state):
        r_pad, device = state.shape[1], state.device
        self.t = torch.full((r_pad,), _BIG, dtype=state.dtype, device=device)
        self.idx = torch.zeros(r_pad, dtype=torch.int64, device=device)
        self.hit = torch.zeros(r_pad, dtype=torch.bool, device=device)


def sweep_leaf_reference(tris, leaf: int, ray, state, k: TraceConsts, best: TriBest):
    """Plain version of wave.cuh sweep_leaf for the rays ``ray`` (indices
    into the state's columns): Moller-Trumbore against leaf ``leaf``'s 64
    rows, strict ``t < best`` with the first minimum of the leaf, so a tie
    keeps the lowest row (`wavefront.py:261-303`). Updates ``best``."""
    blk = tris[leaf * LEAF:(leaf + 1) * LEAF]
    v0x, v0y, v0z = (blk[None, :, c] for c in range(3))
    e1x, e1y, e1z = (blk[None, :, 3 + c] - blk[None, :, c] for c in range(3))
    e2x, e2y, e2z = (blk[None, :, 6 + c] - blk[None, :, c] for c in range(3))
    valid = blk[None, :, 18] > 0.5
    rox, roy, roz, rdx, rdy, rdz = (state[c][ray][:, None] for c in range(6))
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(torch.abs(det) < k.det_eps, 1.0, det)
    tvx, tvy, tvz = rox - v0x, roy - v0y, roz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    acc = ((torch.abs(det) >= k.det_eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t >= k.t_min) & (t <= k.t_max) & valid)
    tm = torch.where(acc, t, _BIG)
    gmin = torch.amin(tm, dim=1)
    garg = torch.argmin(tm, dim=1)  # the first minimum: the lowest row
    upd = gmin < best.t[ray]  # strict: an earlier (lower) leaf keeps a tie
    best.idx[ray] = torch.where(upd, garg + leaf * LEAF, best.idx[ray])
    best.t[ray] = torch.where(upd, gmin, best.t[ray])
    best.hit[ray] |= acc.any(dim=1)


def finish_bounce_reference(state, ids, best: TriBest, scene, k: TraceConsts, bounce: int,
                            seed: int = 0, sample: int = 0, urand=None):
    """Plain version of wave.cuh finish_bounce over a whole (10, r_pad)
    state after the triangle sweep (`wavefront.py:311-466`): spheres bounded
    by the closest triangle (far-root quirk), the winner's attributes
    re-derived from its row, shading, the next state. ``scene`` gives tris,
    sphs, n_sph, mats, sky, num_mats and tri_rows. Returns (next state, a new
    tensor; winners (r_pad,) int32: the unified-table row ``j`` for triangle
    row j, ``tri_rows + s`` for sphere s, -1 where the ray missed or was not
    live)."""
    r_pad = state.shape[1]
    ox, oy, oz, dx, dy, dz = state[0:6]
    active = state[9] > 0.5
    best_i, tri_hit = best.idx, best.hit
    tri_best = torch.where(tri_hit, best.t, k.t_max)

    # spheres bounded by the closest triangle, far-root quirk (:316-340)
    def sphere_root(sp):
        ocx, ocy, ocz = sp[..., 0] - ox[:, None], sp[..., 1] - oy[:, None], sp[..., 2] - oz[:, None]
        halfb = dx[:, None] * ocx + dy[:, None] * ocy + dz[:, None] * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - sp[..., 3] * sp[..., 3]
        delta = halfb * halfb - c
        sq = torch.sqrt(torch.clamp(delta, min=0.0))
        t_near = halfb - sq
        return torch.where(t_near >= k.t_min, t_near, halfb + sq), delta, t_near

    sph_t = torch.full_like(ox, _BIG)
    sph_i = torch.zeros(r_pad, dtype=torch.int64, device=state.device)
    sph_hit = torch.zeros_like(active)
    for js in range(0, scene.n_sph, LEAF):
        sp = scene.sphs[None, js:js + LEAF]
        t, delta, t_near = sphere_root(sp)
        acc = ((delta >= 0.0) & (t_near <= tri_best[:, None]) & (t >= k.t_min)
               & (sp[..., 4] > 0.5))
        tm = torch.where(acc, t, _BIG)
        tile_min = torch.amin(tm, dim=1)
        upd = tile_min < sph_t
        sph_i = torch.where(upd, js + torch.argmin(tm, dim=1), sph_i)
        sph_t = torch.where(upd, tile_min, sph_t)
        sph_hit = sph_hit | acc.any(dim=1)
    hit = tri_hit | sph_hit
    use_sph = sph_hit
    winners = torch.where(active & hit,
                          torch.where(use_sph, sph_i + scene.tri_rows, best_i),
                          -1).to(torch.int32)

    # the winner's attributes, re-derived from its row (:388-447)
    tr = scene.tris[best_i]
    g = [tr[:, c] for c in range(20)]
    e1x, e1y, e1z = g[3] - g[0], g[4] - g[1], g[5] - g[2]
    e2x, e2y, e2z = g[6] - g[0], g[7] - g[1], g[8] - g[2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvx, tvy, tvz = ox - g[0], oy - g[1], oz - g[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t_tri = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    w_ = 1.0 - u - v
    tnx = w_ * g[9] + u * g[12] + v * g[15]
    tny = w_ * g[10] + u * g[13] + v * g[16]
    tnz = w_ * g[11] + u * g[14] + v * g[17]
    tlen = torch.sqrt(tnx * tnx + tny * tny + tnz * tnz)
    tinv = torch.where(tlen > 0.0, 1.0 / torch.where(tlen > 0.0, tlen, 1.0), 0.0)
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    tsign = torch.where(dx * gnx + dy * gny + dz * gnz < 0.0, 1.0, -1.0)
    tnx, tny, tnz = tnx * tinv * tsign, tny * tinv * tsign, tnz * tinv * tsign

    sp = scene.sphs[sph_i]
    t_s = sphere_root(sp[:, None])[0][:, 0]
    inv_r = 1.0 / torch.where(sp[:, 3] == 0.0, 1.0, sp[:, 3])
    spx, spy, spz = ox + t_s * dx, oy + t_s * dy, oz + t_s * dz
    snx, sny, snz = (spx - sp[:, 0]) * inv_r, (spy - sp[:, 1]) * inv_r, (spz - sp[:, 2]) * inv_r
    ssign = torch.where(dx * snx + dy * sny + dz * snz < 0.0, 1.0, -1.0)
    snx, sny, snz = snx * ssign, sny * ssign, snz * ssign

    px = torch.where(use_sph, spx, ox + t_tri * dx)
    py = torch.where(use_sph, spy, oy + t_tri * dy)
    pz = torch.where(use_sph, spz, oz + t_tri * dz)
    nx = torch.where(use_sph, snx, tnx)
    ny = torch.where(use_sph, sny, tny)
    nz = torch.where(use_sph, snz, tnz)
    mat_id = torch.where(use_sph, sp[:, 5], g[19])

    u1, u2 = bounce_uniforms(ids, bounce, seed, sample, urand)
    f_r, f_g, f_b, wix, wiy, wiz, is_emissive = scatter_shade(
        nx, ny, nz, dx, dy, dz, mat_id, u1, u2, scene.mats.tolist(), scene.num_mats,
        k.pdf_eps)
    sky = sky_color(dy, scene.sky.tolist())
    f = [torch.where(hit, fc, sc) for fc, sc in zip((f_r, f_g, f_b), sky)]
    nxt = active & hit & ~is_emissive
    rows = [torch.where(nxt, px + k.shadow_eps * nx, ox),
            torch.where(nxt, py + k.shadow_eps * ny, oy),
            torch.where(nxt, pz + k.shadow_eps * nz, oz),
            torch.where(nxt, wix, dx), torch.where(nxt, wiy, dy),
            torch.where(nxt, wiz, dz)]
    rows += [state[6 + c] * fc for c, fc in enumerate(f)]
    rows.append(nxt.to(torch.float32))
    return torch.where(active[None, :], torch.stack(rows), state), winners


# ---- the culled megakernel (B11) ---------------------------------------------------

#: kernel launches made by `trace_culled` in this process
culled_launches = 0
#: rays per block of the culled megakernel, one CUDA thread each
CULLED_LANES = 256
#: the counters a launch of the culled megakernel adds to ``stats``: live
#: ray-bounces, supertile and leaf box tests made, (ray, leaf) pairs whose
#: leaf box the ray itself passes, and the (live lane, leaf) slots of the
#: warps' visits (a warp visits a leaf that one of its lanes passes)
CULLED_STATS = ("ray_bounces", "super_tests", "leaf_tests", "own_pairs", "warp_slots")


def trace_culled_reference(o, d, scene, consts: TraceConsts, max_depth: int,
                           seed: int = 0, sample: int = 0, urand=None, cull: bool = True,
                           record: bool = False, lanes: int = CULLED_LANES,
                           stats: dict = None):
    """Plain version of the culled megakernel: (R, 3) rays → colour (R, 3)
    unclamped, with ``record`` also the selections (max_depth, R) int32.

    Per bounce and per block of ``lanes`` rays the supertiles are walked in
    ascending order; a supertile, and then each of its leaves, is swept when
    some live ray of the block passes its box's slab test bounded by that
    ray's closest hit so far (`megakernel.py:365-401`), and every live ray
    of the block then sweeps the leaf. ``cull=False`` sweeps every leaf.
    Loops over leaves and reads the votes on the host. ``stats`` (with
    ``cull``) receives the work this run's rays needed: ``ray_bounces`` (live
    rays summed over the bounces), ``own_pairs`` ((ray, leaf) pairs whose
    leaf box the ray itself passed before its closest hit so far) and
    ``swept_pairs`` ((ray, leaf) pairs swept after the blocks' votes). These
    are the block votes of the kernel's first design; the kernel votes per
    warp and only a lane whose own ray passes a leaf sweeps it, which gives
    the same colours and selections (the cull is conservative). With
    ``lanes=32`` a block is a warp, so ``ray_bounces``, ``own_pairs`` and
    ``swept_pairs`` are the kernel's CULLED_STATS ``ray_bounces``,
    ``own_pairs`` and ``warp_slots``."""
    R = o.shape[0]
    dev = o.device
    r_pad = -(-R // lanes) * lanes
    nb = r_pad // lanes
    state = torch.zeros((10, r_pad), dtype=torch.float32, device=dev)
    state[0:3, :R] = o.T
    state[3:6, :R] = d.T
    state[6:10, :R] = 1.0
    ids = torch.arange(r_pad, dtype=torch.int32, device=dev)
    sel = torch.full((max_depth, R), -1, dtype=torch.int32, device=dev)
    box_rows = scene.cull_boxes[:, :6].tolist()
    super_rows = scene.super_boxes[:, :6].tolist()

    count = dict(ray_bounces=0, own_pairs=0, swept_pairs=0)

    def block_vote(box, best, live, iv, among=None):
        """(nb,) bool: some live ray of the block passes ``box``."""
        tn, tf = slab_interval(box, state[0:3], iv)
        ok = (tn <= tf) & (tf >= consts.t_min) & (tn <= best.t) & live
        vote = ok.view(nb, lanes).any(dim=1)
        if among is None:
            return vote
        if stats is not None:
            count["own_pairs"] += int(ok.sum())
        return vote & among

    for b in range(max_depth):
        live = state[9] > 0.5
        if not bool(live.any()):
            break  # the kernel's all-dead exit, for every block at once
        best = TriBest(state)
        count["ray_bounces"] += int(live.sum()) if stats is not None else 0
        if cull:
            iv = [slab_inv(state[3 + c]) for c in range(3)]
            for js, sbox in enumerate(super_rows):
                passed = block_vote(sbox, best, live, iv)
                if not bool(passed.any()):
                    continue
                for leaf in range(js * SUPER, min((js + 1) * SUPER, scene.n_leaf)):
                    vote = block_vote(box_rows[leaf], best, live, iv, among=passed)
                    ray = (vote.repeat_interleave(lanes) & live).nonzero().squeeze(1)
                    if ray.numel():
                        count["swept_pairs"] += ray.numel()
                        sweep_leaf_reference(scene.tris, leaf, ray, state, consts, best)
        else:
            ray = live.nonzero().squeeze(1)
            for leaf in range(scene.n_leaf):
                sweep_leaf_reference(scene.tris, leaf, ray, state, consts, best)
        state, winners = finish_bounce_reference(state, ids, best, scene, consts, b, seed,
                                                 sample, urand)
        sel[b] = winners[:R]
    if stats is not None:
        stats.update(count)
    color = state[6:9, :R].T.contiguous()
    return (color, sel) if record else color


def trace_culled(o, d, scene, consts: TraceConsts, max_depth: int, seed: int = 0,
                 sample: int = 0, urand=None, cull: bool = True, record: bool = False,
                 lanes: int = CULLED_LANES, stats=None):
    """Trace one sample per ray through the culled megakernel: (R, 3) rays →
    colour (R, 3) float32 unclamped, with ``record`` also the selections
    (max_depth, R) int32 (rows of ``scene.tris`` order, ``scene.tri_rows +
    s`` for sphere s, -1 for a miss or an ended path).

    ``scene``: a `wavefront.WaveScene` (`wavefront.prepare_scene`).
    ``urand`` (2 + 2*max_depth, R) or None for Philox draws keyed by (seed,
    ray, sample, draw). ``cull=False`` sweeps every leaf (the brute A/B).
    CUDA tensors launch `csrc/mega_kernel.cu` once (counted in
    ``culled_launches``); ``stats`` (5,) int64 on the card, or None,
    receives the counters named in CULLED_STATS (with ``cull``). CPU tensors
    run `trace_culled_reference`; anything else raises."""
    global culled_launches
    if o.device.type == "cpu":
        return trace_culled_reference(o, d, scene, consts, max_depth, seed, sample, urand,
                                      cull, record, lanes)
    if o.device.type != "cuda":
        raise RendererError(f"trace_culled runs on cuda or cpu, not {o.device}")
    R = o.shape[0] if o.dim() == 2 else -1
    n_super = scene.super_boxes.shape[0]
    expected = [("o", o, (R, 3), torch.float32), ("d", d, (R, 3), torch.float32),
                ("tris", scene.tris, (scene.tris.shape[0], 32), torch.float32),
                ("rows", scene.rows, (scene.tris.shape[0], 12), torch.float32),
                ("cull_boxes", scene.cull_boxes, (n_super * SUPER, 8), torch.float32),
                ("super_boxes", scene.super_boxes, (n_super, 8), torch.float32),
                ("sphs", scene.sphs, (scene.n_sph, 16), torch.float32),
                ("mats", scene.mats, (MAX_MATS, 8), torch.float32),
                ("sky", scene.sky, (8,), torch.float32)]
    if urand is not None:
        expected.append(("urand", urand, (2 + 2 * max_depth, R), torch.float32))
    if stats is not None:
        expected.append(("stats", stats, (len(CULLED_STATS),), torch.int64))
    if scene.num_mats > MAX_MATS:
        raise RendererError(f"the culled megakernel takes <= {MAX_MATS} materials")
    check_tensors("o", o.device, expected)
    if not (R >= 1 and max_depth >= 1 and 32 <= lanes <= 256 and lanes % 32 == 0):
        raise RendererError(f"the culled megakernel takes >= 1 ray, max_depth >= 1 and 32 "
                            f"<= lanes <= 256, a multiple of 32; got {R}, {max_depth}, {lanes}")
    if (scene.tris.shape[0] < scene.n_leaf * LEAF or n_super * SUPER < scene.n_leaf
            or scene.rows.data_ptr() % 16):
        raise RendererError("the culled megakernel takes n_leaf whole 64-row leaves, rows "
                            "16-byte aligned, and their boxes in whole supertiles")
    color = torch.empty((R, 3), dtype=torch.float32, device=o.device)
    sel = torch.empty((max_depth, R), dtype=torch.int32, device=o.device) if record else None
    p = MegaParams(
        w=wave_params(consts, seed, sample, scene, n_rays=R, n_sel=R,
                      external_rng=int(urand is not None)),
        max_depth=max_depth, n_super=n_super, cull=int(cull))
    lib = build.load_library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.ptre_trace_culled(
            ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
            None if urand is None else urand.data_ptr(), scene.tris.data_ptr(),
            scene.rows.data_ptr(), scene.cull_boxes.data_ptr(), scene.super_boxes.data_ptr(),
            scene.sphs.data_ptr(), scene.mats.data_ptr(), scene.sky.data_ptr(),
            color.data_ptr(), None if sel is None else sel.data_ptr(),
            None if stats is None else stats.data_ptr(), lanes, stream)
    if rc != 0:
        raise RendererError(
            f"culled megakernel launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    culled_launches += 1
    return (color, sel) if record else color


def trace_culled_sel(o, d, scene, consts: TraceConsts, max_depth: int, seed: int = 0,
                     sample: int = 0, urand=None, cull: bool = True):
    """The recording forward of the triangle-scale gradient path on the
    culled megakernel (`megakernel.py:1225-1297`): (colour, selections
    (max_depth, R) int32, perm). ``perm`` is the scene's Morton permutation
    of the packet's triangle rows, which the recorded rows index, or None
    for a scene packed in the packet's own order."""
    color, sel = trace_culled(o, d, scene, consts, max_depth, seed, sample, urand, cull,
                              record=True)
    return color, sel, scene.perm_tri
