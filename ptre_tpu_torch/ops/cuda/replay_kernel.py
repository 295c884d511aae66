"""The differentiable bounce chain of the path replay, plain PyTorch.

Port of `ptre_tpu/ops/pallas/replay_kernel.py` `_chain_bounce` (:54-238) and
`_chain` (:241): ONE bounce re-derived from the recorded winner's row of the
unified (P, 27) table — hit point and normal, ONB cosine scatter, Oren-Nayar
or emissive weight, sky on a miss, throughput product — written formula for
formula as the reference writes it, with the `gradsafe` forms and JAX's
gradient rules (``where`` routes the gradient to the branch taken; a max,
min or clip tie splits it). This is the one copy of the chain in the port:
`ops/path_replay.replay` loops it, and autograd through it is the plain
version of the fused backward kernel (`csrc/fused_grad_kernel.cu`), whose
hand-written adjoint `csrc/replay.cuh` is checked against it.

Row layout (``G_ROWS`` = 27): v0 v1 v2 n0 n1 n2 (0-17) | center (18-20),
radius (21) | kind (22), albedo (23-25), param (26).

Every scalar constant is a float32 value (`gradsafe.f32`), so the chain runs
in float32 as the reference does and in float64 with the CUDA adjoint's
constants. The TPU kernels `_fwd_kernel` / `_bwd_kernel` (ROADMAP B13) are
not ported here.
"""

from __future__ import annotations

import torch

from ptre_tpu_torch.ops import gradsafe as gs
from ptre_tpu_torch.ops.gradsafe import f32

G_ROWS = 27
_PI = 3.14159265358979
_TAU = f32(2.0 * _PI)
_INV_PI = f32(1.0 / _PI)


def _sqrt_guarded(x):
    """sqrt(x) for x > 0, else 0, with zero gradient at 0 (double where)."""
    pos = x > 0.0
    return torch.sqrt(torch.where(pos, x, torch.ones_like(x))) * pos.to(x.dtype)


def _div_pos(num, den):
    """``num / where(den > 0, den, 1)``: the guarded divide inside the
    reference's ``where(den > 1e-12, ..., default)``."""
    return num / torch.where(den > 0, den, torch.ones_like(den))


def chain_bounce(o, d, c, active, g, use_sph, hit, u1, u2, sky, consts):
    """One bounce of the replay chain.

    Args:
      o, d, c: (x, y, z) / (r, g, b) tuples of tensors: ray origin,
        direction and throughput before the bounce.
      active: bool tensor, the path is alive before the bounce.
      g: sequence of ``G_ROWS`` tensors, the winner's table row (any values
        where ``hit`` is False: they are not used).
      use_sph, hit: bool tensors, the recorded selection.
      u1, u2: the bounce's scatter uniforms (no gradient).
      sky: (bottom r, g, b, top r, g, b), tensors or floats.
      consts: ``t_min``, ``shadow_eps``, ``pdf_eps`` (float32 values).
    Returns (o', d', c', next_active).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    cr, cg, cb = c
    sbr, sbg, sbb, str_, stg, stb = sky
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)

    # --- triangle attrs (intersect.triangle_hit_attrs_t) ------------------
    v0x, v0y, v0z = g[0], g[1], g[2]
    e1x, e1y, e1z = g[3] - v0x, g[4] - v0y, g[5] - v0z
    e2x, e2y, e2z = g[6] - v0x, g[7] - v0y, g[8] - v0z
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = gs.stable_inv_det(det, e1x * e1x + e1y * e1y + e1z * e1z,
                                e2x * e2x + e2y * e2y + e2z * e2z)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t_tri = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    w_ = 1.0 - u - v
    inx = w_ * g[9] + u * g[12] + v * g[15]
    iny = w_ * g[10] + u * g[13] + v * g[16]
    inz = w_ * g[11] + u * g[14] + v * g[17]
    nlen_sq = inx * inx + iny * iny + inz * inz
    npos = nlen_sq > 0.0
    ninv = torch.where(npos, 1.0 / torch.sqrt(torch.where(npos, nlen_sq, one)), zero)
    tnx, tny, tnz = inx * ninv, iny * ninv, inz * ninv
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    tsign = torch.where(dx * gnx + dy * gny + dz * gnz < 0.0, one, -one)
    tnx, tny, tnz = tnx * tsign, tny * tsign, tnz * tsign
    p_tx = ox + t_tri * dx
    p_ty = oy + t_tri * dy
    p_tz = oz + t_tri * dz

    # --- sphere attrs (intersect.sphere_hit_attrs_t) ----------------------
    scx, scy, scz, sr = g[18], g[19], g[20], g[21]
    ocx, ocy, ocz = scx - ox, scy - oy, scz - oz
    halfb = dx * ocx + dy * ocy + dz * ocz
    c_ = ocx * ocx + ocy * ocy + ocz * ocz - sr * sr
    delta = halfb * halfb - c_
    sq = gs.stable_sqrt_delta(delta, sr)
    t_near = halfb - sq
    t_sph = torch.where(t_near >= consts.t_min, t_near, halfb + sq)
    p_sx = ox + t_sph * dx
    p_sy = oy + t_sph * dy
    p_sz = oz + t_sph * dz
    r_safe = torch.where(sr > 0.0, sr, one)
    snx = (p_sx - scx) / r_safe
    sny = (p_sy - scy) / r_safe
    snz = (p_sz - scz) / r_safe
    ssign = torch.where(dx * snx + dy * sny + dz * snz < 0.0, one, -one)
    snx, sny, snz = snx * ssign, sny * ssign, snz * ssign

    px = torch.where(use_sph, p_sx, p_tx)
    py = torch.where(use_sph, p_sy, p_ty)
    pz = torch.where(use_sph, p_sz, p_tz)
    nx = torch.where(use_sph, snx, tnx)
    ny = torch.where(use_sph, sny, tny)
    nz = torch.where(use_sph, snz, tnz)

    kind = g[22]
    alb_r, alb_g, alb_b = g[23], g[24], g[25]
    param = g[26]
    is_emissive = kind > 0.5

    # --- ONB cosine scatter (path_replay._scatter_from_uniforms) ----------
    phi = _TAU * u1
    sr_ = torch.sqrt(u2)
    lx = torch.cos(phi) * sr_
    ly = torch.sin(phi) * sr_
    lz = torch.sqrt(gs.maximum(1.0 - u2, 0.0))
    big_x = torch.abs(nx) > f32(0.9)
    ax = torch.where(big_x, zero, one)
    ay = torch.where(big_x, one, zero)
    vx = -nz * ay
    vy = nz * ax
    vz = nx * ay - ny * ax
    vlen = _sqrt_guarded(vx * vx + vy * vy + vz * vz)
    vinv = 1.0 / torch.where(vlen > 0.0, vlen, one)
    vx, vy, vz = vx * vinv, vy * vinv, vz * vinv
    ux = vy * nz - vz * ny
    uy = vz * nx - vx * nz
    uz = vx * ny - vy * nx
    wix = lx * ux + ly * vx + lz * nx
    wiy = lx * uy + ly * vy + lz * ny
    wiz = lx * uz + ly * vz + lz * nz
    ndotwi = nx * wix + ny * wiy + nz * wiz
    pdf = ndotwi * _INV_PI
    degen = pdf < consts.pdf_eps
    wix = torch.where(degen, nx, wix)
    wiy = torch.where(degen, ny, wiy)
    wiz = torch.where(degen, nz, wiz)
    pdf = torch.where(degen, _INV_PI * one, pdf)
    ndotwi = torch.where(degen, one, ndotwi)
    cosw = gs.maximum(zero, ndotwi)

    # --- Oren-Nayar coefficient (path_replay._oren_nayar_coeff) -----------
    sigma = gs.clip(param, 0.0, 1.0)
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + f32(0.33))
    B_ = f32(0.45) * s2 / (s2 + f32(0.09))
    wox, woy = -dx, -dy
    li = _sqrt_guarded(wix * wix + wiy * wiy)
    lo = _sqrt_guarded(wox * wox + woy * woy)
    tiny = f32(1e-12)
    ci = torch.where(li > tiny, _div_pos(wix, li), one)
    si = torch.where(li > tiny, _div_pos(wiy, li), zero)
    co = torch.where(lo > tiny, _div_pos(wox, lo), one)
    so = torch.where(lo > tiny, _div_pos(woy, lo), zero)
    cos_dphi = ci * co + si * so
    cos_to = gs.clip(-(dx * nx + dy * ny + dz * nz), 0.0, 1.0)
    cos_ti = gs.clip(cosw, 0.0, 1.0)
    cos_a = torch.minimum(cos_ti, cos_to)
    cos_b = torch.maximum(cos_ti, cos_to)
    sin_a = _sqrt_guarded(gs.maximum(1.0 - cos_a * cos_a, 0.0))
    tan_b = _sqrt_guarded(gs.maximum(1.0 - cos_b * cos_b, 0.0)) * gs.stable_recip_cos(cos_b)
    coeff = (A + B_ * cos_dphi * sin_a * tan_b) * _INV_PI

    att_r = torch.where(is_emissive, param * alb_r, alb_r * coeff)
    att_g = torch.where(is_emissive, param * alb_g, alb_g * coeff)
    att_b = torch.where(is_emissive, param * alb_b, alb_b * coeff)
    w_pdf = torch.where(is_emissive, one, gs.cosine_ratio(cosw, pdf))

    a_sky = (dy + 1.0) * 0.5
    sky_r = (1.0 - a_sky) * sbr + a_sky * str_
    sky_g = (1.0 - a_sky) * sbg + a_sky * stg
    sky_b = (1.0 - a_sky) * sbb + a_sky * stb

    f_r = torch.where(hit, w_pdf * att_r, sky_r)
    f_g = torch.where(hit, w_pdf * att_g, sky_g)
    f_b = torch.where(hit, w_pdf * att_b, sky_b)
    cr = cr * torch.where(active, f_r, one)
    cg = cg * torch.where(active, f_g, one)
    cb = cb * torch.where(active, f_b, one)

    next_active = active & hit & ~is_emissive
    eps = consts.shadow_eps
    o_next = (torch.where(next_active, px + eps * nx, ox),
              torch.where(next_active, py + eps * ny, oy),
              torch.where(next_active, pz + eps * nz, oz))
    d_next = (torch.where(next_active, wix, dx),
              torch.where(next_active, wiy, dy),
              torch.where(next_active, wiz, dz))
    return o_next, d_next, (cr, cg, cb), next_active
