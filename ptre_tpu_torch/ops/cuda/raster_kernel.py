"""Hard z-buffer tile rasterizer: triangle table packing, the plain version
of the kernel and its wrapper.

Port of `ptre_tpu/ops/pallas/raster_kernel.py`:

  * `pack_raster_tris` (`raster_kernel.py:100`): the vertex stage, viewport
    transform, culling and the (T_pad, 32) table, its dropped rows
    sanitised, sorted along a screen Z-curve (`_morton2_order`, `:68`) and
    cut into 64-row chunks with their boxes. Differentiable PyTorch: the
    SoftRas path takes its gradient through it.
  * `raster_tiles`: the wrapper of `csrc/raster_kernel.cu`, replacing
    `_raster_kernel` (`:255`), counted in ``launches``. CUDA tensors launch
    the kernel (forward only: a table that needs a gradient raises; with
    ``stats`` its counting instantiation); CPU tensors run
    `raster_reference`, the plain version; anything else raises.
    `hard_gate_boxes` are the kernel's row gate (`csrc/raster.cuh`
    hard_gate_box) in PyTorch, for counting the pairs it evaluates.

The image is planar (3, rows * ss, width * ss) over a (y0, stride) window of
output rows: window row r samples y = (y0 + stride * (r // ss)) * ss + r %
ss + 0.5 (`rasterizer.raster_rows`). Any size, window and stride is taken:
the kernel masks ragged tiles itself, where the TPU kernel needed widths in
whole 128-lane tiles, heights in 8-row groups, the whole frame and the table
resident in VMEM.

Not ported: `_tile_shortlists` (`:226`). The TPU needed per-tile
shortlists because a scalar gate per (tile, chunk) costs it hundreds of
nanoseconds; here each block tests every chunk's box itself, a
block-uniform branch that costs a few instructions per chunk.
"""

from __future__ import annotations

import bisect
import ctypes
import math

import torch

from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.render.rasterizer import transform_vertices
from ptre_tpu_torch.utils.errors import RendererError

#: triangle rows per chunk: the cull and staging unit (`raster_kernel.py:41`)
CHUNK = 64
#: a CUDA block is a TILE x TILE sample tile, one thread per sample
TILE = 16
#: empty z-buffer depth (`raster_kernel.py:42`)
FAR = mk.f32(1.0e9)
#: the never-hit box bound of a dropped row (`raster_kernel.py:164`)
BIG = mk.f32(3e38)
#: sample pairs (samples x triangles) one step of a plain version holds
PLAIN_PAIRS = 1 << 22

#: kernel launches made by `raster_tiles` in this process
launches = 0
#: the counters a launch with ``stats`` adds to: visited (block, chunk)
#: pairs, rows that pass the row gate of a visit, (sample, row) pairs
#: evaluated (the sample inside the row's gate box), and those that cover
STATS = ("visits", "rows_passed", "pairs_evaluated", "pairs_covering")
#: float32's unit roundoff, 2^-24 (`raster.cuh` kRoundoff)
ROUNDOFF = mk.f32(5.9604645e-8)


class RasterParams(ctypes.Structure):
    """Field for field `ptre::rast::RasterParams` (raster.cuh)."""

    _fields_ = [("scal", ctypes.c_float * 16), ("rows_ss", ctypes.c_int32),
                ("width_ss", ctypes.c_int32), ("ss", ctypes.c_int32),
                ("n_chunks", ctypes.c_int32)]


def raster_params(scal, rows_ss: int, width_ss: int, ss: int, n_chunks: int) -> RasterParams:
    """The kernels' by-value arguments; ``scal`` the (16,) CPU scalars."""
    return RasterParams(scal=(ctypes.c_float * 16)(*scal.tolist()), rows_ss=rows_ss,
                        width_ss=width_ss, ss=ss, n_chunks=n_chunks)


def raster_scalars(config, sigma_inv: float = 0.0, y0: float = 0.0, stride: int = 1):
    """(16,) float32 CPU scalars: ambient rgb, albedo rgb, normalised light,
    clear rgb, 1/sigma (soft only), y0, stride, 0 (`raster_kernel.py:472-481`,
    `soft_raster.py:445-457`; the hard kernel reads y0 and stride too)."""
    f32 = torch.float32
    light = vm.normalize(torch.tensor(config.light_dir, dtype=f32))
    ambient = config.ambient_strength * torch.tensor(config.clear_color, dtype=f32)
    return torch.cat([ambient, torch.tensor(config.albedo, dtype=f32), light,
                      torch.tensor(config.clear_color, dtype=f32),
                      torch.tensor([sigma_inv, y0, stride, 0.0], dtype=f32)])


def _morton2_order(cx, cy, keep):
    """(T,) int64 permutation along a screen-space Z-curve of the box
    centres, dropped rows last (`raster_kernel.py:68-97`). The 32-bit codes
    are built in int64 (torch has no uint32 sort) and sorted STABLY, as
    `jnp.argsort` sorts."""
    inf = float("inf")
    lo_x = torch.amin(torch.where(keep, cx, inf))
    hi_x = torch.amax(torch.where(keep, cx, -inf))
    lo_y = torch.amin(torch.where(keep, cy, inf))
    hi_y = torch.amax(torch.where(keep, cy, -inf))

    def quant(v, lo, hi):
        q = torch.clamp((v - lo) / torch.clamp(hi - lo, min=1e-6) * 65535.0, 0.0, 65535.0)
        return torch.where(keep, q, 0.0).to(torch.int64)

    def spread(x):  # interleave 16 bits with 1-bit gaps
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    code = spread(quant(cx, lo_x, hi_x)) | (spread(quant(cy, lo_y, hi_y)) << 1)
    key = torch.where(keep, code, 0xFFFFFFFF)
    return torch.argsort(key, stable=True)


def pack_raster_tris(packet, cam, config):
    """Vertex stage + viewport transform → ((T_pad, 32) table, (C, 8) chunk
    boxes) on the packet's device (`raster_kernel.py:100-198`).

    Table cols: 0-5 screen xy per corner; 6-8 NDC z; 9-11 1/w; 12 keep; 13-21
    world normal * 1/w per corner; 22 1/area; 23-26 screen box (minx, maxx,
    miny, maxy); 27-31 zero. Dropped rows (invalid, a corner at w <= 0,
    culled or zero area) are zeroed with a never-hit box, the rows sorted by
    `_morton2_order` and padded with zero rows to whole chunks. A chunk box
    is (minx, maxx, miny, maxy, any_keep, 0, 0, 0) over its kept rows; the
    boxes are detached (the soft VJP returns no gradient for them). The
    table is differentiable in the packet's and camera's float leaves."""
    ss = config.supersample
    Ws, Hs = config.width * ss, config.height * ss
    dev = packet.device
    view = cam.view_matrix().to(dev)
    proj = cam.projection_matrix().to(dev)
    tri_v = torch.stack([packet.tri_v0, packet.tri_v1, packet.tri_v2], dim=1)
    tri_n = torch.stack([packet.tri_n0, packet.tri_n1, packet.tri_n2], dim=1)
    ndc, w, n_world = transform_vertices(tri_v, tri_n, packet.tri_dc, packet.transforms,
                                         view, proj)
    sx = (ndc[..., 0] + 1.0) * 0.5 * Ws  # (T, 3)
    sy = (1.0 - ndc[..., 1]) * 0.5 * Hs
    z = ndc[..., 2]
    iw = 1.0 / w

    # signed area (positive = CW front in y-down screen space)
    area = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
            - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0]))
    keep = packet.tri_valid.bool() & (torch.amin(w, dim=1) > 0.0)
    keep = keep & ((area > 0.0) if config.cull_backfaces else (torch.abs(area) > 0.0))
    inv_area = 1.0 / torch.where(area == 0.0, 1.0, area)

    T = sx.shape[0]
    n_iw = n_world * iw[..., None]  # (T, 3, 3)
    cols = torch.cat([
        sx[:, 0:1], sy[:, 0:1], sx[:, 1:2], sy[:, 1:2], sx[:, 2:3], sy[:, 2:3],
        z, iw, keep[:, None].to(torch.float32), n_iw.reshape(-1, 9), inv_area[:, None],
        torch.amin(sx, dim=1, keepdim=True), torch.amax(sx, dim=1, keepdim=True),
        torch.amin(sy, dim=1, keepdim=True), torch.amax(sy, dim=1, keepdim=True),
        torch.zeros((T, 5), dtype=torch.float32, device=dev)], dim=1)
    # dropped rows can carry NaN/inf from the w-divide, which poisons even
    # masked arithmetic (0 * NaN): zero them, with a never-hit box
    keep_rows = cols[:, 12] > 0.5
    safe = torch.zeros(32, dtype=torch.float32, device=dev)
    safe[23], safe[24], safe[25], safe[26] = BIG, -BIG, BIG, -BIG
    cols = torch.where(keep_rows[:, None], cols, safe)

    perm = _morton2_order((cols[:, 23] + cols[:, 24]) * 0.5,
                          (cols[:, 25] + cols[:, 26]) * 0.5, keep_rows)
    cols = cols[perm]
    pad = (-T) % CHUNK
    if pad:
        cols = torch.cat([cols, cols.new_zeros((pad, 32))])

    return cols, chunk_boxes(cols)


def chunk_boxes(cols):
    """(C, 8) boxes of a table's 64-row chunks, detached: (minx, maxx, miny,
    maxy, any_keep, 0, 0, 0) over each chunk's kept rows."""
    ck = cols.detach().reshape(-1, CHUNK, 32)
    keep_c = ck[:, :, 12] > 0.5
    zero = torch.zeros(ck.shape[0], dtype=torch.float32, device=cols.device)
    return torch.stack([
        torch.amin(torch.where(keep_c, ck[:, :, 23], BIG), dim=1),
        torch.amax(torch.where(keep_c, ck[:, :, 24], -BIG), dim=1),
        torch.amin(torch.where(keep_c, ck[:, :, 25], BIG), dim=1),
        torch.amax(torch.where(keep_c, ck[:, :, 26], -BIG), dim=1),
        keep_c.any(dim=1).to(torch.float32), zero, zero, zero], dim=1)


def sample_ys(rows_ss: int, ss: int, y0: float, stride: float, device=None):
    """(rows_ss,) float32 sample y of each window row, rounded as the kernel
    rounds it (`raster.cuh` row_y)."""
    r = torch.arange(rows_ss, device=device)
    out_row = mk.f32(y0) + mk.f32(stride) * torch.div(r, ss, rounding_mode="floor").to(torch.float32)
    return (out_row * float(ss) + (r % ss).to(torch.float32)) + 0.5


def visited_pairs(cbox, rows_ss: int, width_ss: int, ss: int, y0: float = 0.0,
                  stride: float = 1.0) -> int:
    """The (block, chunk) pairs the kernels visit: chunks whose box passes
    the block-uniform gate of a TILE x TILE sample tile (`raster.cuh`
    chunk_hits). One host read."""
    dev = cbox.device
    n_by, n_bx = -(-rows_ss // TILE), -(-width_ss // TILE)
    ys = sample_ys(rows_ss, ss, y0, stride, dev)
    r0 = torch.arange(n_by, device=dev) * TILE
    y_first = ys[r0]
    y_last = ys[torch.clamp(r0 + TILE - 1, max=rows_ss - 1)]
    x_lo = torch.arange(n_bx, device=dev, dtype=torch.float32) * TILE
    b = cbox[None, None]
    hit = ((b[..., 4] > 0.5)
           & (b[..., 0] < (x_lo + TILE)[None, :, None]) & (b[..., 1] >= x_lo[None, :, None])
           & (b[..., 2] < (y_last + 1.0)[:, None, None])
           & (b[..., 3] >= (y_first - 0.5)[:, None, None]))
    return int(hit.sum())


def box_pairs(tris, ys, width_ss: int, grow: float = 0.0, boxes=None) -> int:
    """The (sample, row) pairs of the kept rows whose sample lies inside the
    row's own screen box (cols 23-26) grown by ``grow`` on every side, or
    inside ``boxes`` (T, 4) (minx, maxx, miny, maxy; `hard_gate_boxes`): the
    pairs that can cover (hard), or reach the coverage threshold (soft,
    grown by 14 sigma). ``ys``: the window rows' sample y (`sample_ys`),
    ascending. One host read."""
    keep = tris[:, 12] > 0.5
    b = (tris[:, 23:27] if boxes is None else boxes)[keep].double()
    lo = torch.clamp(torch.ceil(b[:, 0] - grow - 0.5), min=0)  # column c samples x = c + 0.5
    hi = torch.clamp(torch.floor(b[:, 1] + grow - 0.5), max=width_ss - 1)
    ysd = ys.double().contiguous()
    ny = (torch.searchsorted(ysd, (b[:, 3] + grow).contiguous(), right=True)
          - torch.searchsorted(ysd, (b[:, 2] - grow).contiguous())).clamp(min=0)
    return int((torch.clamp(hi - lo + 1, min=0) * ny).sum())


def window_span(rows_ss: int, width_ss: int, ss: int, y0: float = 0.0,
                stride: float = 1.0) -> float:
    """The largest |coordinate| of a sample of the window, plus ss + 1
    (`raster.cuh` window_span), rounded as the kernel rounds it."""
    ys = sample_ys(rows_ss, ss, y0, stride)
    y = max(abs(float(ys[0])), abs(float(ys[-1])))
    return mk.f32(mk.f32(max(float(width_ss), y)) + float(ss + 1))


def hard_gate_boxes(tris, span: float):
    """(T, 4) float32 gate boxes of the hard kernel's row gate (`raster.cuh`
    hard_gate_box, the same float32 operations): each row's screen box grown
    by the rounding reach of its coverage test, infinite where the reach
    cannot be bounded (a sliver). Meaningful for kept rows only."""
    c = tris.detach()
    box = c[:, 23:27]
    sb = torch.maximum(c[:, 24] - c[:, 23], c[:, 26] - c[:, 25])
    m = box.abs().amax(dim=1)
    q = (2.0 * ROUNDOFF * sb) * c[:, 22].abs()
    reach = (64.0 * q) * (sb * sb)
    dmax = span + m
    sr = sb + dmax
    sound = (reach <= 0.01 * sb) & ((32.0 * q) * (sr * sr + sb * sb) <= dmax)
    r = torch.where(sound, reach, float("inf"))
    return torch.stack([box[:, 0] - r, box[:, 1] + r, box[:, 2] - r, box[:, 3] + r], dim=1)


def chunk_windows(cbox, ys, width_ss: int, margin: float = 1.0):
    """Per live chunk (k, r0, r1, c0, c1): the window rows and columns whose
    sample centres lie within ``margin`` of the chunk's box — every sample a
    row of the chunk could cover (or, for dilated soft boxes, reach above
    the coverage threshold). The plain versions visit only these."""
    ys = ys.tolist()
    out = []
    for k, (minx, maxx, miny, maxy, live, *_rest) in enumerate(cbox.tolist()):
        if not live > 0.5:
            continue
        r0 = bisect.bisect_left(ys, miny - margin)
        r1 = bisect.bisect_right(ys, maxy + margin)
        # column c samples x = c + 0.5; clamp before int() (boxes may be huge)
        c0 = int(math.floor(min(max(minx - margin - 0.5, 0.0), width_ss)))
        c1 = min(int(math.floor(min(max(maxx + margin - 0.5, -1.0), width_ss))) + 1, width_ss)
        if r0 < r1 and c0 < c1:
            out.append((k, r0, r1, c0, c1))
    return out


def slabs(r0: int, r1: int, n_cols: int, per_row: int):
    """Row ranges of [r0, r1) holding at most PLAIN_PAIRS pairs each."""
    step = max(PLAIN_PAIRS // max(n_cols * per_row, 1), 1)
    return [(a, min(a + step, r1)) for a in range(r0, r1, step)]


def barycentric(c, px, py):
    """(w0, w1, w2, z) of samples (px, py) in rows c (a column accessor), in
    the kernel's operation order (`raster.cuh` barycentric)."""
    w0 = ((c(2) - px) * (c(5) - py) - (c(4) - px) * (c(3) - py)) * c(22)
    w1 = ((c(4) - px) * (c(1) - py) - (c(0) - px) * (c(5) - py)) * c(22)
    w2 = 1.0 - w0 - w1
    z = w0 * c(6) + w1 * c(7) + w2 * c(8)
    return w0, w1, w2, z


def shade_winner(rows, px, py, scal):
    """(P, 3) HLSL shade of each sample's winner row: exact re-interpolation
    of the perspective-correct normal (`raster_kernel.py:387-416`)."""
    c = lambda j: rows[:, j]  # noqa: E731
    w0, w1, w2, _ = barycentric(c, px, py)
    den = w0 * c(9) + w1 * c(10) + w2 * c(11)
    inv_den = 1.0 / torch.where(den == 0.0, 1.0, den)
    nx = (w0 * c(13) + w1 * c(16) + w2 * c(19)) * inv_den
    ny = (w0 * c(14) + w1 * c(17) + w2 * c(20)) * inv_den
    nz = (w0 * c(15) + w1 * c(18) + w2 * c(21)) * inv_den
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    ninv = torch.where(nlen > 0.0, 1.0 / torch.where(nlen > 0.0, nlen, 1.0), 0.0)
    q = -((nx * ninv) * scal[6] + (ny * ninv) * scal[7] + (nz * ninv) * scal[8])
    diffuse = torch.where(q > 0.0, q, 0.0)
    return torch.stack([(scal[k] + diffuse) * scal[3 + k] for k in range(3)], dim=1)


def raster_reference(tris, cbox, scal, rows_ss: int, width_ss: int, ss: int):
    """Plain version of the hard kernel: planar (3, rows_ss, width_ss).

    Per live chunk, the samples of its window (`chunk_windows`) test its 64
    rows at once; a sample's winner is the lowest sorted row among its
    closest covering rows (first minimum within a chunk, strict < across
    ascending chunks). Then each winner is re-interpolated and shaded; a
    sample with no winner takes the clear colour."""
    s = [mk.f32(v) for v in scal.tolist()]
    dev = tris.device
    ys = sample_ys(rows_ss, ss, s[13], s[14], dev)
    xs = torch.arange(width_ss, device=dev, dtype=torch.float32) + 0.5
    best_z = torch.full((rows_ss, width_ss), FAR, device=dev)
    best_i = torch.full((rows_ss, width_ss), -1, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for k, r0, r1, c0, c1 in chunk_windows(cbox, ys, width_ss):
            blk = tris[k * CHUNK:(k + 1) * CHUNK].detach()
            c = lambda j: blk[:, j]  # noqa: E731
            px = xs[None, c0:c1, None]
            for a, b in slabs(r0, r1, c1 - c0, CHUNK):
                py = ys[a:b, None, None]
                w0, w1, w2, z = barycentric(c, px, py)
                covered = ((w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & (z >= 0.0)
                           & (z <= 1.0) & (c(12) > 0.5))
                gmin, garg = torch.min(torch.where(covered, z, FAR), dim=-1)
                upd = gmin < best_z[a:b, c0:c1]
                best_i[a:b, c0:c1] = torch.where(upd, garg + k * CHUNK, best_i[a:b, c0:c1])
                best_z[a:b, c0:c1] = torch.where(upd, gmin, best_z[a:b, c0:c1])
    hit = (best_i >= 0).reshape(-1)
    py = ys[:, None].expand(rows_ss, width_ss).reshape(-1)
    px = xs[None, :].expand(rows_ss, width_ss).reshape(-1)
    rgb = shade_winner(tris[best_i.reshape(-1).clamp(min=0)], px, py, s)
    clear = torch.tensor(s[9:12], device=dev)
    out = torch.where(hit[:, None], rgb, clear)
    return out.T.reshape(3, rows_ss, width_ss)


def check_launch(what: str, tris, cbox, rows_ss: int, width_ss: int, ss: int):
    """The checks shared by the three raster kernels' wrappers: the table in
    whole 64-row chunks, 16-byte aligned, its chunk boxes and a non-empty
    window."""
    n_chunks = cbox.shape[0] if cbox.dim() == 2 else -1
    mk.check_tensors("tris", tris.device, [
        ("tris", tris, (n_chunks * CHUNK, 32), torch.float32),
        ("cbox", cbox, (n_chunks, 8), torch.float32)])
    if n_chunks < 1 or tris.data_ptr() % 16:
        raise RendererError(f"{what}: the table must hold whole 64-row chunks, 16-byte "
                            f"aligned; got {tuple(tris.shape)}")
    if rows_ss < 1 or width_ss < 1 or ss < 1:
        raise RendererError(f"{what}: empty window {rows_ss}x{width_ss} (ss {ss})")


def raster_tiles(tris, cbox, scal, rows_ss: int, width_ss: int, ss: int, stats=None):
    """The planar (3, rows_ss, width_ss) hard-rasterized window. CUDA
    tensors launch `csrc/raster_kernel.cu` (counted in ``launches``);
    ``stats`` (4,) int64 on the card, or None, receives the counters named
    in STATS. CPU tensors run `raster_reference`; anything else raises. The
    kernel is forward-only: a table that needs a gradient raises on CUDA."""
    global launches
    if tris.device.type == "cpu":
        return raster_reference(tris, cbox, scal, rows_ss, width_ss, ss)
    if tris.device.type != "cuda":
        raise RendererError(f"raster_tiles runs on cuda or cpu, not {tris.device}")
    if tris.requires_grad and torch.is_grad_enabled():
        raise RendererError("the hard raster kernel is forward-only: rasterize with "
                            "soft=True for gradients, or under torch.no_grad()")
    check_launch("raster_tiles", tris, cbox, rows_ss, width_ss, ss)
    if stats is not None:
        mk.check_tensors("tris", tris.device, [("stats", stats, (len(STATS),), torch.int64)])
    out = torch.empty((3, rows_ss, width_ss), dtype=torch.float32, device=tris.device)
    p = raster_params(scal, rows_ss, width_ss, ss, cbox.shape[0])
    lib = build.load_library()
    with torch.cuda.device(tris.device):
        stream = torch.cuda.current_stream(tris.device).cuda_stream
        rc = lib.ptre_raster_hard(ctypes.addressof(p), tris.data_ptr(), cbox.data_ptr(),
                                  out.data_ptr(), None if stats is None else stats.data_ptr(),
                                  stream)
    if rc != 0:
        raise RendererError(
            f"raster kernel launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    launches += 1
    return out


def resolve(img_p, rows: int, width: int, ss: int):
    """Planar (3, rows * ss, width * ss) → (rows, width, 3) box resolve (the
    ResolveSubresource analogue, `rasterizer.cu:142`)."""
    img = img_p.permute(1, 2, 0)
    return img.reshape(rows, ss, width, ss, 3).mean(dim=(1, 3))


def rasterize_fused(packet, cam, config, y0: float = 0.0, stride: int = 1, rows=None):
    """The hard rasterizer through `raster_tiles` → (rows, W, 3), resolved
    (`raster_kernel.py:460-486`, plus the output-row window)."""
    ss = config.supersample
    rows = config.height if rows is None else rows
    tris, cbox = pack_raster_tris(packet, cam, config)
    scal = raster_scalars(config, 0.0, y0, stride)
    out = raster_tiles(tris, cbox, scal, rows * ss, config.width * ss, ss)
    return resolve(out, rows, config.width, ss)
