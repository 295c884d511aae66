"""Differentiable (SoftRas) rasterizer: the forward and backward kernels'
wrappers, their plain versions, and the autograd Function that pairs them.

Port of `ptre_tpu/ops/pallas/soft_raster.py`. The one-shot soft path
(`rasterizer._raster_tile(soft=True)`) holds (samples x triangles) tensors;
this module streams the same math over 64-row chunks of the
`pack_raster_tris` table:

  * forward (`soft_forward`, `csrc/soft_raster_kernel.cu` replacing
    `_soft_fwd_kernel`, `soft_raster.py:144`): per sample an ONLINE softmax
    over the chunks, groups of 8 rows at a time, carrying (max logit m,
    denominator D, coverage weight W, colour numerator N); out come the
    planar image and the six residual planes (m, D, W, Nr, Ng, Nb). A chunk
    is skipped where its box, dilated by 14 sigma, misses the samples, and
    the kernels evaluate a row only for the samples inside its own box so
    dilated (`csrc/raster.cuh` gate_box): beyond 14 sigma a pair's coverage
    is below the 1e-6 threshold, so it adds exactly nothing, and a group
    that adds nothing leaves the state bit for bit as it was.
  * backward (`soft_backward`, the same unit, replacing `_soft_bwd_kernel`,
    `soft_raster.py:251`): the same chunks again; per pair the cotangents of
    (coverage, logit, colour) from the saved residuals
    (`soft_raster.py:301-335`), then the vector-Jacobian product of
    `pair_terms` — a hand-written adjoint in `csrc/raster.cuh` (the TPU
    kernel traces `jax.vjp` in-kernel) — summed into d(table).
  * `SoftRaster` stands in for `_make_core`'s `jax.custom_vjp`
    (`soft_raster.py:393`): d(table), and None for the boxes and scalars.
    The table → (transforms, camera) chain is ordinary torch autograd
    through `pack_raster_tris`.

CUDA tensors launch the kernels (counted in ``fwd_launches`` and
``bwd_launches``; with ``stats``, their counting instantiations); CPU
tensors run `soft_forward_reference` / `soft_backward_reference`; anything
else raises.
"""

from __future__ import annotations

import ctypes

import torch

from ptre_tpu_torch.ops import gradsafe as gs
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import raster_kernel as rk
from ptre_tpu_torch.utils.errors import RendererError

#: box dilation in sigmas: sigmoid(-14) < 1e-6, the coverage threshold
DILATE_SIGMA = 14.0
#: depth softmax 1/temperature (`rasterizer.py` logits = -z / 0.01)
INV_TAU = 100.0
#: pairs at or below this coverage add nothing
COV_MIN = gs.f32(1e-6)
#: rows per online-softmax update (`soft_raster.py:197`)
GROUP = 8
#: residual planes: m, D, W, Nr, Ng, Nb
RES_PLANES = 6
#: the table's columns that carry a soft gradient, by what they hold
#: (`raster_kernel.pack_raster_tris`, `_soft_cols`; raster.cuh grad_col)
GRAD_GROUPS = {"screen xy": (0, 1, 2, 3, 4, 5), "NDC z": (6, 7, 8), "1/w": (9, 10, 11),
               "keep": (12,), "normal/w": tuple(range(13, 22)), "1/area": (22,),
               "1/edge^2": (27, 28, 29)}
_BIG = mk.f32(3e38)
_EPS_D = gs.f32(1e-12)
_EPS_N = gs.f32(1e-20)

#: kernel launches made by `soft_forward` and `soft_backward` in this process
fwd_launches = 0
bwd_launches = 0
#: the counters a launch with ``stats`` adds to: visited (block, chunk)
#: pairs, rows that pass the row gate of a visit, (sample, row) pairs
#: evaluated (the sample inside the row's gate box), and those above the
#: coverage threshold
STATS = ("visits", "rows_passed", "pairs_evaluated", "pairs_included")


def _soft_cols(packet, cam, config):
    """The `pack_raster_tris` table with the inverse squared edge lengths in
    cols 27-29 (three divisions fewer per pair), and the chunk boxes
    (`soft_raster.py:60-73`)."""
    cols, cbox = rk.pack_raster_tris(packet, cam, config)

    def inv_len2(xa, ya, xb, yb):
        ex, ey = cols[:, xb] - cols[:, xa], cols[:, yb] - cols[:, ya]
        return 1.0 / (ex * ex + ey * ey + _EPS_D)

    lens = torch.stack([inv_len2(0, 1, 2, 3), inv_len2(2, 3, 4, 5), inv_len2(4, 5, 0, 1)],
                       dim=1)
    return torch.cat([cols[:, :27], lens, cols[:, 30:]], dim=1), cbox


def dilate(cbox, sigma: float):
    """Chunk boxes grown by 14 sigma on every side (`soft_raster.py:439-443`)."""
    d = DILATE_SIGMA * float(sigma)
    return cbox + torch.tensor([-d, d, -d, d, 0.0, 0.0, 0.0, 0.0], device=cbox.device)


def pair_terms(blk, px, py, scal):
    """(cov, logit, c_r, c_g, c_b) of rows ``blk`` (..., 32) against samples
    (px, py), broadcast (`soft_raster.py:76-129`), in the kernel's operation
    order, differentiable in ``blk`` with JAX's gradient rules (`gradsafe`:
    half at a max, min or clip tie)."""
    sigma_inv = scal[12]
    c = lambda j: blk[..., j]  # noqa: E731
    w0, w1, w2, z = rk.barycentric(c, px, py)
    z_ok = ((z >= 0.0) & (z <= 1.0)).to(z.dtype)

    def edge_dist(xa, ya, xb, yb, ilen):
        ax, ay = c(xa), c(ya)
        ex, ey = c(xb) - ax, c(yb) - ay
        t = gs.clip(((px - ax) * ex + (py - ay) * ey) * c(ilen), 0.0, 1.0)
        dx = px - (ax + t * ex)
        dy = py - (ay + t * ey)
        return torch.sqrt(dx * dx + dy * dy + _EPS_D)

    dist = gs.minimum(edge_dist(0, 1, 2, 3, 27),
                      gs.minimum(edge_dist(2, 3, 4, 5, 28), edge_dist(4, 5, 0, 1, 29)))
    inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    cov = c(12) * z_ok * torch.sigmoid(torch.where(inside, dist, -dist) * sigma_inv)
    logit = -gs.clip(z, 0.0, 1.0) * INV_TAU

    # perspective-correct normal → HLSL ambient + diffuse
    den = w0 * c(9) + w1 * c(10) + w2 * c(11)
    inv_den = 1.0 / torch.where(den == 0.0, 1.0, den)
    nx = (w0 * c(13) + w1 * c(16) + w2 * c(19)) * inv_den
    ny = (w0 * c(14) + w1 * c(17) + w2 * c(20)) * inv_den
    nz = (w0 * c(15) + w1 * c(18) + w2 * c(21)) * inv_den
    ninv = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz + _EPS_N)
    diffuse = gs.maximum(-((nx * ninv) * scal[6] + (ny * ninv) * scal[7]
                           + (nz * ninv) * scal[8]), 0.0)
    return (cov, logit) + tuple((scal[k] + diffuse) * scal[3 + k] for k in range(3))


def _windows(tris, cbox, scal, rows_ss: int, width_ss: int, ss: int):
    """Sample coordinates and the live chunks' windows of the plain versions."""
    dev = tris.device
    ys = rk.sample_ys(rows_ss, ss, scal[13], scal[14], dev)
    xs = torch.arange(width_ss, device=dev, dtype=torch.float32) + 0.5
    return ys, xs, rk.chunk_windows(cbox, ys, width_ss)


def soft_forward_reference(tris, cbox, scal, rows_ss: int, width_ss: int, ss: int):
    """Plain version of the forward kernel: (image (3, rows_ss, width_ss),
    residuals (6, rows_ss, width_ss)). Per live chunk, the samples of its
    window take its rows group by group into their online-softmax state,
    with the reference's empty-state guards (`soft_raster.py:197-226`).
    Differentiable in ``tris`` (the state is updated out of place)."""
    s = [mk.f32(v) for v in scal.tolist()]
    ys, xs, wins = _windows(tris, cbox, s, rows_ss, width_ss, ss)
    dev = tris.device
    shape = (rows_ss, width_ss)
    st = [torch.full(shape, -_BIG, device=dev)] + [torch.zeros(shape, device=dev)
                                                   for _ in range(5)]
    for k, r0, r1, c0, c1 in wins:
        for a, b in rk.slabs(r0, r1, c1 - c0, rk.CHUNK):
            py = ys[a:b, None, None]
            px = xs[None, c0:c1, None]
            m, D, W, nr, ng, nb = (x[a:b, c0:c1].clone() for x in st)
            for g in range(rk.CHUNK // GROUP):
                lo = k * rk.CHUNK + g * GROUP
                cov, logit, cr, cg, cb = pair_terms(tris[lo:lo + GROUP], px, py, s)
                inc = cov > COV_MIN
                lm = torch.where(inc, logit, -_BIG)
                m_new = gs.maximum(m, torch.amax(lm, dim=-1))
                dm = m - m_new
                scale = (torch.exp(gs.maximum(dm, -_BIG * 0.5))
                         * (m > -_BIG * 0.5).to(torch.float32))
                e = torch.where(inc, torch.exp(lm - m_new[..., None]), 0.0)
                ce = cov * e
                D = D * scale + e.sum(-1)
                W = W * scale + ce.sum(-1)
                nr = nr * scale + (ce * cr).sum(-1)
                ng = ng * scale + (ce * cg).sum(-1)
                nb = nb * scale + (ce * cb).sum(-1)
                m = m_new
            for x, v in zip(st, (m, D, W, nr, ng, nb)):
                x[a:b, c0:c1] = v
    m, D, W, nr, ng, nb = st
    inv_d = torch.where(D > 0.0, 1.0 / torch.where(D > 0.0, D, 1.0), 0.0)
    bg = gs.maximum(1.0 - W * inv_d, 0.0)
    img = torch.stack([n * inv_d + bg * s[9 + i] for i, n in enumerate((nr, ng, nb))])
    return img, torch.stack(st)


def row_state(res, dimg, scal):
    """Per-sample terms of the softmax layer's cotangents, from the saved
    residuals and the image cotangent (`soft_raster.py:291-310`):
    (m, 1/D, s = W/D, g_clear, g_out)."""
    m, D, W = res[0], res[1], res[2]
    inv_d = torch.where(D > 0.0, 1.0 / torch.where(D > 0.0, D, 1.0), 0.0)
    s = W * inv_d
    live_bg = (s < 1.0).to(torch.float32)
    g_clear = (dimg[0] * scal[9] + dimg[1] * scal[10] + dimg[2] * scal[11]) * live_bg
    g_out = (dimg[0] * res[3] + dimg[1] * res[4] + dimg[2] * res[5]) * inv_d
    return m, inv_d, s, g_clear, g_out


def soft_backward_reference(tris, cbox, scal, res, dimg, rows_ss: int, width_ss: int,
                            ss: int):
    """Plain version of the backward kernel: d(table), the shape of
    ``tris``. Per live chunk and its window, the pairs above the coverage
    threshold get the kernel's cotangents (`soft_raster.py:328-336`), and
    torch autograd of `pair_terms` over those pairs gives their d(rows)."""
    s = [mk.f32(v) for v in scal.tolist()]
    ys, xs, wins = _windows(tris, cbox, s, rows_ss, width_ss, ss)
    m, inv_d, s_, g_clear, g_out = row_state(res, dimg, s)
    dtab = torch.zeros_like(tris)
    tris = tris.detach()
    for k, r0, r1, c0, c1 in wins:
        blk = tris[k * rk.CHUNK:(k + 1) * rk.CHUNK]
        for a, b in rk.slabs(r0, r1, c1 - c0, rk.CHUNK):
            py = ys[a:b, None].expand(b - a, c1 - c0)
            px = xs[None, c0:c1].expand(b - a, c1 - c0)
            with torch.no_grad():
                inc = pair_terms(blk, px[..., None], py[..., None], s)[0] > COV_MIN
            r_i, c_i, t_i = inc.nonzero(as_tuple=True)
            if r_i.numel() == 0:
                continue
            leaf = blk.clone().requires_grad_(True)
            with torch.enable_grad():
                cov, logit, cr, cg, cb = pair_terms(leaf[t_i], px[r_i, c_i], py[r_i, c_i], s)
            rr, cc = r_i + a, c_i + c0
            gr, gg, gb = (dimg[i][rr, cc] for i in range(3))
            with torch.no_grad():
                e = torch.exp(torch.clamp(logit - m[rr, cc], max=0.0))
                p = e * inv_d[rr, cc]
                gc = gr * cr + gg * cg + gb * cb
                gcl = g_clear[rr, cc]
                dl = p * (cov * gc - g_out[rr, cc]) - gcl * p * (cov - s_[rr, cc])
                dcov = p * gc - gcl * p
                wi = cov * p
            (dblk,) = torch.autograd.grad((cov, logit, cr, cg, cb), leaf,
                                          (dcov, dl, wi * gr, wi * gg, wi * gb))
            dtab[k * rk.CHUNK:(k + 1) * rk.CHUNK] += dblk
    return dtab


def included_pairs(tris, cbox, scal, rows_ss: int, width_ss: int, ss: int) -> int:
    """The (sample, row) pairs above the coverage threshold: the pairs whose
    adjoint the backward runs (the plain backward's first pass)."""
    s = [mk.f32(v) for v in scal.tolist()]
    ys, xs, wins = _windows(tris, cbox, s, rows_ss, width_ss, ss)
    n = 0
    with torch.no_grad():
        for k, r0, r1, c0, c1 in wins:
            blk = tris[k * rk.CHUNK:(k + 1) * rk.CHUNK]
            for a, b in rk.slabs(r0, r1, c1 - c0, rk.CHUNK):
                cov = pair_terms(blk, xs[None, c0:c1, None], ys[a:b, None, None], s)[0]
                n += int((cov > COV_MIN).sum())
    return n


def _launch(fn_name: str, args, dev):
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RendererError(f"{fn_name} launch failed: "
                            f"{lib.ptre_cuda_error_string(rc).decode()}")


def _stats_arg(stats, dev):
    """The kernels' ``stats`` pointer: None, or (4,) int64 on the card."""
    if stats is None:
        return None
    mk.check_tensors("tris", dev, [("stats", stats, (len(STATS),), torch.int64)])
    return stats.data_ptr()


def soft_forward(tris, cbox, scal, rows_ss: int, width_ss: int, ss: int, stats=None):
    """(image (3, rows_ss, width_ss), residuals (6, rows_ss, width_ss)) of
    the dilated-box soft table. CUDA tensors launch the forward kernel
    (counted in ``fwd_launches``); ``stats`` (4,) int64 on the card, or
    None, receives the counters named in STATS. CPU tensors run
    `soft_forward_reference`; anything else raises."""
    global fwd_launches
    if tris.device.type == "cpu":
        return soft_forward_reference(tris, cbox, scal, rows_ss, width_ss, ss)
    if tris.device.type != "cuda":
        raise RendererError(f"soft_forward runs on cuda or cpu, not {tris.device}")
    rk.check_launch("soft_forward", tris, cbox, rows_ss, width_ss, ss)
    dev = tris.device
    img = torch.empty((3, rows_ss, width_ss), dtype=torch.float32, device=dev)
    res = torch.empty((RES_PLANES, rows_ss, width_ss), dtype=torch.float32, device=dev)
    p = rk.raster_params(scal, rows_ss, width_ss, ss, cbox.shape[0])
    _launch("ptre_soft_fwd", (ctypes.addressof(p), tris.data_ptr(), cbox.data_ptr(),
                              img.data_ptr(), res.data_ptr(), _stats_arg(stats, dev)), dev)
    fwd_launches += 1
    return img, res


def soft_backward(tris, cbox, scal, res, dimg, rows_ss: int, width_ss: int, ss: int,
                  stats=None):
    """d(table) of the soft image's cotangent ``dimg`` (3, rows_ss,
    width_ss). CUDA tensors launch the backward kernel (counted in
    ``bwd_launches``; d(table) is summed by float atomics, so it varies from
    run to run at float rounding); ``stats`` as `soft_forward`'s. CPU
    tensors run `soft_backward_reference`; anything else raises."""
    global bwd_launches
    if tris.device.type == "cpu":
        return soft_backward_reference(tris, cbox, scal, res, dimg, rows_ss, width_ss, ss)
    if tris.device.type != "cuda":
        raise RendererError(f"soft_backward runs on cuda or cpu, not {tris.device}")
    rk.check_launch("soft_backward", tris, cbox, rows_ss, width_ss, ss)
    mk.check_tensors("tris", tris.device, [
        ("res", res, (RES_PLANES, rows_ss, width_ss), torch.float32),
        ("dimg", dimg, (3, rows_ss, width_ss), torch.float32)])
    dtab = torch.zeros_like(tris)
    p = rk.raster_params(scal, rows_ss, width_ss, ss, cbox.shape[0])
    _launch("ptre_soft_bwd", (ctypes.addressof(p), tris.data_ptr(), cbox.data_ptr(),
                              res.data_ptr(), dimg.data_ptr(), dtab.data_ptr(),
                              _stats_arg(stats, tris.device)), tris.device)
    bwd_launches += 1
    return dtab


class SoftRaster(torch.autograd.Function):
    """img_p (3, rows_ss, width_ss) = core(table, boxes, scalars): the
    forward kernel, and the backward kernel as its VJP (`soft_raster.py
    :393-416`)."""

    @staticmethod
    def forward(ctx, tris, cbox, scal, rows_ss, width_ss, ss):
        img, res = soft_forward(tris.detach(), cbox, scal, rows_ss, width_ss, ss)
        ctx.save_for_backward(tris, cbox, scal, res)
        ctx.window = (rows_ss, width_ss, ss)
        return img

    @staticmethod
    def backward(ctx, dimg):
        tris, cbox, scal, res = ctx.saved_tensors
        dtab = soft_backward(tris.detach(), cbox, scal, res, dimg.contiguous(), *ctx.window)
        return dtab, None, None, None, None, None


def rasterize_soft_fused(packet, cam, config, sigma: float = 0.5, y0: float = 0.0,
                         stride: int = 1, rows=None):
    """Differentiable SoftRas rasterize → (rows, W, 3), resolved: the same
    function as `rasterizer.raster_rows(soft=True, backend="oneshot")`,
    streamed; gradients reach the packet's transforms and geometry and the
    camera through `pack_raster_tris` and `SoftRaster`. ``y0``, ``stride``,
    ``rows`` select the output-row window."""
    ss = config.supersample
    rows = config.height if rows is None else rows
    cols, cbox = _soft_cols(packet, cam, config)
    scal = rk.raster_scalars(config, 1.0 / sigma, y0, stride)
    img_p = SoftRaster.apply(cols.contiguous(), dilate(cbox, sigma), scal, rows * ss,
                             config.width * ss, ss)
    return rk.resolve(img_p, rows, config.width, ss)
