"""The differentiable bounce chain of the path replay and the replay pair.

Port of `ptre_tpu/ops/pallas/replay_kernel.py` `_chain_bounce` (:54-238) and
`_chain` (:241): ONE bounce re-derived from the recorded winner's row of the
unified (P, 27) table — hit point and normal, ONB cosine scatter, Oren-Nayar
or emissive weight, sky on a miss, throughput product — written formula for
formula as the reference writes it, with the `gradsafe` forms and JAX's
gradient rules (``where`` routes the gradient to the branch taken; a max,
min or clip tie splits it). This is the one copy of the chain in the port:
`ops/path_replay.replay_table` and `replay_fwd_reference` loop it, and
autograd through it is the plain version of the fused backward kernel
(`csrc/fused_grad_kernel.cu`) and of the replay kernels
(`csrc/replay_kernel.cu`), whose hand-written adjoint `csrc/replay.cuh` is
checked against it.

Row layout (``G_ROWS`` = 27): v0 v1 v2 n0 n1 n2 (0-17) | center (18-20),
radius (21) | kind (22), albedo (23-25), param (26).

Every scalar constant is a float32 value (`gradsafe.f32`), so the chain runs
in float32 as the reference does and in float64 with the CUDA adjoint's
constants.

The replay pair (`_fwd_kernel` :277 / `_bwd_kernel` :289, tied together by
`_make_core` :383 and called as `replay_core` :408) is `replay_core` here:
the chain over winner rows gathered outside the kernels, ``g`` (B, R, 27),
ray r's row of bounce b at ``g[b, r]``. `replay_fwd` and `replay_bwd` launch
`csrc/replay_kernel.cu` on CUDA tensors and run their plain versions
(`replay_fwd_reference`, `replay_bwd_reference`: this module's chain, and
autograd through it) on CPU tensors; `ReplayCore` ties them together as the
reference's ``custom_vjp`` does. The selections (B, R) int32 give each
bounce's class and hit flags (``idx >= sph_offset``, ``idx >= 0``), the
reference's flags rows; its planar (8, 8, L) blocks, lane padding and
padded-lane masking are TPU layout matters and have no counterpart.
Uniforms: ``urand`` (2 + 2B, R), or Philox keyed by (seed, ray, sample,
draw), as the recording kernel drew them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ptre_tpu_torch.ops import gradsafe as gs
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.gradsafe import f32
from ptre_tpu_torch.utils.errors import RendererError

G_ROWS = 27
#: kernel launches made by `replay_fwd` and `replay_bwd` in this process
fwd_launches = 0
bwd_launches = 0
#: the replay kernels' row bound on a selection (`TraceParams.n_rows`): their
#: rows are addressed by (bounce, ray), so no index reads outside them
_ANY_ROW = 2 ** 31 - 1
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


# ---- the replay pair: chain over gathered rows, forward and backward ---------------


def replay_fwd_reference(o, d, g, sel, sky6, sph_offset: int, consts, max_depth: int,
                         seed: int = 0, sample: int = 0, urand=None):
    """Plain version of the replay forward kernel: `chain_bounce` over the
    gathered rows ``g`` (B, R, 27) from the primary rays → colour (R, 3), in
    the dtype of the inputs, differentiable w.r.t. ``o``, ``d``, ``g`` and
    ``sky6`` (the reference's ``_chain``)."""
    ur = mk.trace_uniforms(o, max_depth, seed, sample, urand).to(o.dtype)
    sky = tuple(sky6[i] for i in range(6))
    o_, d_ = o.unbind(dim=1), d.unbind(dim=1)
    one = torch.ones_like(o_[0])
    c_ = (one, one, one)
    active = torch.ones_like(one, dtype=torch.bool)
    for b in range(max_depth):
        idx = sel[b]
        o_, d_, c_, active = chain_bounce(
            o_, d_, c_, active, g[b].unbind(dim=1), idx >= sph_offset, idx >= 0,
            ur[2 + 2 * b], ur[3 + 2 * b], sky, consts)
    return torch.stack(c_, dim=1)


def replay_bwd_reference(o, d, g, sel, sky6, dcol, sph_offset: int, consts,
                         max_depth: int, seed: int = 0, sample: int = 0, urand=None):
    """Plain version of the replay backward kernel: autograd of
    `replay_fwd_reference` with the colour cotangent ``dcol`` (R, 3).
    Returns (d o (R, 3), d d (R, 3), d g (B, R, 27), d sky6 (6,)); d(g) is
    zero where a bounce was not live or did not hit."""
    leaves = [t.detach().requires_grad_(True) for t in (o, d, g, sky6)]
    with torch.enable_grad():
        color = replay_fwd_reference(*leaves[:3], sel, leaves[3], sph_offset, consts,
                                     max_depth, seed, sample, urand)
        return tuple(torch.autograd.grad(color, leaves, grad_outputs=dcol))


def _replay_args(kernel, o, d, g, sel, sky6, max_depth, urand, extra=()):
    """Check the replay kernels' inputs on ``o``'s CUDA device; returns R."""
    if o.device.type != "cuda":
        raise RendererError(f"{kernel} runs on cuda or cpu, not {o.device}")
    R = o.shape[0] if o.dim() == 2 else -1
    mk.check_rays(o, d, max_depth, urand, [
        ("g", g, (max_depth, R, G_ROWS), torch.float32),
        ("sel", sel, (max_depth, R), torch.int32),
        ("sky6", sky6, (6,), torch.float32)] + list(extra))
    return R


def replay_fwd(o, d, g, sel, sky6, sph_offset: int, consts, max_depth: int,
               seed: int = 0, sample: int = 0, urand=None):
    """The replay forward: colour (R, 3) of the chain over the gathered rows
    ``g`` (B, R, 27). CUDA tensors launch the forward kernel once (counted in
    ``fwd_launches``); CPU tensors run `replay_fwd_reference`; anything else
    raises."""
    global fwd_launches
    if o.device.type == "cpu":
        return replay_fwd_reference(o, d, g, sel, sky6, sph_offset, consts, max_depth,
                                    seed, sample, urand)
    R = _replay_args("replay_fwd", o, d, g, sel, sky6, max_depth, urand)
    params = mk.trace_params(R, consts, max_depth, seed, sample, urand is not None,
                             sph_offset=sph_offset, n_rows=_ANY_ROW)
    color = torch.empty((R, 3), dtype=torch.float32, device=o.device)
    lib = build.load_library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.ptre_replay_fwd(ctypes.addressof(params), g.data_ptr(), sky6.data_ptr(),
                                 o.data_ptr(), d.data_ptr(), sel.data_ptr(),
                                 None if urand is None else urand.data_ptr(),
                                 color.data_ptr(), stream)
    if rc != 0:
        raise RendererError(f"replay forward kernel launch failed: "
                            f"{lib.ptre_cuda_error_string(rc).decode()}")
    fwd_launches += 1
    return color


def replay_bwd(o, d, g, sel, sky6, dcol, sph_offset: int, consts, max_depth: int,
               seed: int = 0, sample: int = 0, urand=None):
    """The replay backward: (d o, d d (R, 3), d g (B, R, 27), d sky6 (6,))
    for the colour cotangent ``dcol`` (R, 3). CUDA tensors launch the
    backward kernel once (counted in ``bwd_launches``) and sum its per-block
    d(sky) partials; CPU tensors run `replay_bwd_reference`; anything else
    raises. Deterministic: nothing is summed by atomics."""
    global bwd_launches
    if o.device.type == "cpu":
        return replay_bwd_reference(o, d, g, sel, sky6, dcol, sph_offset, consts,
                                    max_depth, seed, sample, urand)
    R = _replay_args("replay_bwd", o, d, g, sel, sky6, max_depth, urand,
                     [("dcol", dcol, (o.shape[0], 3), torch.float32)])
    params = mk.trace_params(R, consts, max_depth, seed, sample, urand is not None,
                             sph_offset=sph_offset, n_rows=_ANY_ROW)
    lib = build.load_library()
    d_o, d_d, d_g = torch.empty_like(o), torch.empty_like(d), torch.empty_like(g)
    dsky_part = torch.empty((lib.ptre_replay_blocks(R), 8), dtype=torch.float32,
                            device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.ptre_replay_bwd(ctypes.addressof(params), g.data_ptr(), sky6.data_ptr(),
                                 o.data_ptr(), d.data_ptr(), sel.data_ptr(),
                                 None if urand is None else urand.data_ptr(),
                                 dcol.data_ptr(), d_o.data_ptr(), d_d.data_ptr(),
                                 d_g.data_ptr(), dsky_part.data_ptr(), stream)
    if rc != 0:
        raise RendererError(f"replay backward kernel launch failed: "
                            f"{lib.ptre_cuda_error_string(rc).decode()}")
    bwd_launches += 1
    return d_o, d_d, d_g, dsky_part[:, :6].sum(dim=0)


@dataclasses.dataclass
class _ReplaySpec:
    """Non-tensor arguments of `ReplayCore`, and the tensors that get no
    gradient (the selections, the uniforms)."""

    sel: torch.Tensor
    sph_offset: int
    consts: object
    max_depth: int
    seed: int
    sample: int
    urand: Optional[torch.Tensor]


class ReplayCore(torch.autograd.Function):
    """`replay_fwd` forward, `replay_bwd` backward (the reference's
    ``_make_core`` custom_vjp): gradients reach ``o``, ``d``, ``g`` and
    ``sky6``."""

    @staticmethod
    def forward(ctx, o, d, g, sky6, spec: _ReplaySpec):
        ctx.save_for_backward(o, d, g, sky6)
        ctx.spec = spec
        return replay_fwd(o, d, g, spec.sel, sky6, spec.sph_offset, spec.consts,
                          spec.max_depth, spec.seed, spec.sample, spec.urand)

    @staticmethod
    def backward(ctx, dcolor):
        o, d, g, sky6 = ctx.saved_tensors
        s = ctx.spec
        d_o, d_d, d_g, dsky6 = replay_bwd(o, d, g, s.sel, sky6, dcolor.contiguous(),
                                          s.sph_offset, s.consts, s.max_depth, s.seed,
                                          s.sample, s.urand)
        return d_o, d_d, d_g, dsky6, None


def replay_core(o, d, g, sel, sky6, sph_offset: int, consts, max_depth: int,
                seed: int = 0, sample: int = 0, urand=None):
    """Differentiable replay chain over gathered rows → colour (R, 3)
    (`replay_kernel.replay_core`, :408). ``o``, ``d``: (R, 3) primary rays;
    ``g``: (B, R, 27) winner rows (`path_replay.gather_rows`); ``sel``: (B,
    R) int32 selections; ``sky6``: (6,); ``sph_offset``: the table's sphere
    offset T; ``consts``: `TraceConsts`. Gradients flow to ``o``, ``d``,
    ``g`` and ``sky6``. CUDA tensors run the two kernels, CPU tensors their
    plain versions; any other device raises."""
    if o.device.type not in ("cuda", "cpu"):
        raise RendererError(f"replay_core runs on cuda or cpu, not {o.device}")
    spec = _ReplaySpec(sel, sph_offset, consts, max_depth, seed, sample, urand)
    return ReplayCore.apply(o.contiguous(), d.contiguous(), g.contiguous(),
                            sky6.contiguous(), spec)
