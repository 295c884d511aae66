"""Wavefront path tracing for triangle-scale scenes: sorted ray blocks, a
per-bounce cull mask compacted into leaf shortlists, and a shortlist sweep.

Port of `ptre_tpu/ops/pallas/wavefront.py`. Per bounce:

  1. after bounce 0, the live rays are sorted by `coherence_key` (stable
     argsort; dead rays sink to the back, where whole blocks pass through);
  2. bounce 0 culls by screen-space binning (`leaf_screen_boxes`,
     `screen_block_mask`: the rays of a pixel-tile block can only hit leaves
     whose projected box overlaps the tile); later bounces run the MASK
     kernel, the slab verdict of every (ray block, leaf box) ORed over the
     block's live rays;
  3. PyTorch compacts the (nb, n_leaf) mask into ascending leaf shortlists
     (`shortlists_from_mask`);
  4. the BOUNCE kernel walks each block's shortlist; a ray sweeps a listed
     leaf's rows only where it passes the leaf's box itself, bounded by its
     closest hit so far; then it tests the spheres, re-derives the winner
     and shades it, and writes the next state.

A final scatter puts the colours back in ray order. With ``record`` the
bounce also writes every live ray's winner into a (B, R) int32 selection
array by the ray's original id: the forward of the triangle-scale gradient
path (`ops/cuda/fused_grad.trace_grad`).

  * `wave_mask` / `wave_bounce` are the wrappers of `csrc/mask_kernel.cu` and
    `csrc/wave_kernel.cu` (launches counted in ``mask_launches`` and
    ``bounce_launches``); on CPU tensors they run `wave_mask_reference` /
    `wave_bounce_reference`, the plain versions, vectorised over (rays x one
    64-row leaf). Anything else raises; nothing falls back.
  * `trace` runs the bounce loop (`wavefront.py:709-871`); `prepare_scene` packs a
    packet once, so a caller can reuse it for every sample.

The state is (10, r_pad) float32 rows o.xyz d.xyz rgb active, and an int32
original ray id per column. The TPU carried 2B rows of uniforms through every
sort because its kernel could not regenerate them (`:747-770`); here the
kernel draws bounce b's pair from Philox keyed by (seed, id, sample), pair
1 + b, as the dense render kernel keys it, or reads rows 2 + 2b and 3 + 2b
of an external (2 + 2 * max_depth, R) uniform tensor at the id.

The image does not depend on the culling, the binning, the sort or the lane
count: culling is conservative, and a ray's closest hit is the lowest-index
minimum over its candidates, ties to the lowest Morton row. Like the
reference, `trace` skips the sort when fewer than ``SORT_MIN_LIVE`` of the
rays live, and every bounce once none does; both cost one host read of the
live count per bounce.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from ptre_tpu_torch.utils.device import constant
from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.utils.metrics import span
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk

#: triangle rows per leaf: the sweep and cull granularity
LEAF = mk.LEAF
#: leaves the mask kernel takes: its block keeps one verdict bit a leaf in
#: shared memory, of which an sm_90 block may opt in to 227 KB
#: (`csrc/mask_kernel.cu`; the boxes past 1,024 leaves are read from global
#: memory). The bounce kernel, the culled megakernel and the fused backward
#: read the triangle and sphere rows from global memory and take any count.
MAX_MASK_LEAVES = 227 * 1024 * 8
#: rays per block, one CUDA thread each; at bounce 0 a TILE_ROWS x
#: (LANES // TILE_ROWS) pixel tile
LANES = 256
TILE_ROWS = 8
#: the sort is skipped below this live-ray fraction (`wavefront.py:91`)
SORT_MIN_LIVE = 0.125
#: rows of the ray state: o.xyz d.xyz rgb active
STATE_ROWS = 10
#: dilation in pixels of the leaf screen boxes beyond the jitter range, and
#: the clip w at or below which a triangle's box is the whole screen
#: (`wavefront.py:557-561`)
SCREEN_DILATE = 1.0
W_EPS = 1e-6
_SCREEN_BIG = mk.f32(3e38)
#: the per-ray culls (bounce kernel, culled megakernel, staged sweep) test the
#: leaf and supertile boxes grown on every side by this share of the scene's
#: largest vertex coordinate, so that a box never culls a row the
#: Moller-Trumbore test accepts: a box edge, a flat axis-aligned leaf or a
#: grazing ray, where the slab test and the triangle test round t apart by
#: ulps of the coordinates involved (ray origins up to ~100x the scene's
#: extent stay inside the margin). The mask kernel keeps the reference's
#: exact boxes.
CULL_PAD_REL = 1e-5

#: kernel launches made by `wave_mask` and `wave_bounce` in this process
mask_launches = 0
bounce_launches = 0


def supports(packet) -> bool:
    """Whether the wavefront path takes the packet (`wavefront.py:74-79`),
    by the port's own kernels' limits: at most `MAX_MASK_LEAVES` leaves and
    `mk.MAX_MATERIALS` materials (float32 ids). The reference's VMEM caps on
    triangle and sphere rows and its 8-row SMEM material select
    (`megakernel.py:59`) are not carried over: the kernels read a material
    table of any size."""
    return (packet.num_materials <= mk.MAX_MATERIALS
            and -(-packet.tri_valid.shape[0] // LEAF) <= MAX_MASK_LEAVES)


# ---- glue: sort keys, shortlists, screen binning, packing ------------------

def coherence_key(state, lo, hi):
    """(r_pad,) int32 sort key of one bounce's rays (`wavefront.py:513-535`):
    direction octant, 6-bit xy direction bins and a 15-bit Morton cell of
    the origin in the scene box; dead rays get 0x40000000 and sort last."""
    o = state[0:3]
    d = state[3:6]
    act = state[9] > 0.5
    span = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((o - lo[:, None]) / span[:, None] * 31.0, 0.0, 31.0).to(torch.int32)

    def spread(x):
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    mo = spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2)
    oct_ = ((d[0] >= 0).to(torch.int32) * 4 + (d[1] >= 0).to(torch.int32) * 2
            + (d[2] >= 0).to(torch.int32))
    db = torch.clamp(((d[0:2] + 1.0) * 3.99).to(torch.int32), 0, 7)
    key = (oct_ << 21) | ((db[0] * 8 + db[1]) << 15) | mo
    return torch.where(act, key, 0x40000000).to(torch.int32)


def shortlists_from_mask(mask):
    """(nb, n_leaf) bool survival mask → (shortlists (nb, n_leaf) int32,
    counts (nb,) int32). Row b lists the surviving leaves of block b in
    ascending order (the Morton tie-break order, as `top_k` gives it in
    `wavefront.py:180-201`), then n_leaf. The reference also pads its
    counts to whole sweep groups and appends a group of pad entries; the
    kernel here needs neither."""
    nb, n_leaf = mask.shape
    cnt = mask.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    idx = torch.arange(n_leaf, device=mask.device)[None, :]
    short = torch.where(idx < cnt[:, None], order, n_leaf).to(torch.int32)
    return short.contiguous(), cnt


def leaf_screen_boxes(v0, v1, v2, tri_valid, cam, leaf: int, n_leaf: int):
    """(n_leaf, 4) screen boxes (minx, maxx, miny, maxy) of the leaves in the
    continuous pixel coordinates of ``cam``'s primary rays
    (`wavefront.py:564-615`). Conservative: a triangle with a vertex at or
    behind the eye plane (w <= W_EPS) covers the whole screen, an invalid
    row nothing; each box is dilated by SCREEN_DILATE pixels."""
    W, H = float(cam.width), float(cam.height)
    cam_ops.check_device(cam, v0.device, "the triangles")
    vp = cam_ops.derived(cam, "view_projection",
                         lambda c: c.view_matrix() @ c.projection_matrix())
    big = _SCREEN_BIG
    sxs, sys_, ws = [], [], []
    for v in (v0, v1, v2):
        ndc, w = vm.project_points(v, vp)
        sxs.append((ndc[:, 0] + 1.0) * 0.5 * W)
        sys_.append((1.0 - ndc[:, 1]) * 0.5 * H)
        ws.append(w)
    sx = torch.stack(sxs, dim=1)
    sy = torch.stack(sys_, dim=1)
    wmin = torch.minimum(torch.minimum(ws[0], ws[1]), ws[2])
    safe = wmin > W_EPS
    minx = torch.where(safe, torch.amin(sx, dim=1) - SCREEN_DILATE, -big)
    maxx = torch.where(safe, torch.amax(sx, dim=1) + SCREEN_DILATE, big)
    miny = torch.where(safe, torch.amin(sy, dim=1) - SCREEN_DILATE, -big)
    maxy = torch.where(safe, torch.amax(sy, dim=1) + SCREEN_DILATE, big)
    valid = tri_valid.bool()
    boxes = torch.stack([torch.where(valid, minx, big), torch.where(valid, maxx, -big),
                         torch.where(valid, miny, big), torch.where(valid, maxy, -big)],
                        dim=1)
    pad = n_leaf * leaf - boxes.shape[0]
    empty = constant((big, -big, big, -big), boxes.device).expand(pad, 4)
    boxes = torch.cat([boxes, empty]).reshape(n_leaf, leaf, 4)
    return torch.stack([torch.amin(boxes[:, :, 0], dim=1), torch.amax(boxes[:, :, 1], dim=1),
                        torch.amin(boxes[:, :, 2], dim=1), torch.amax(boxes[:, :, 3], dim=1)],
                       dim=1)


def screen_block_mask(leaf_screen, height: int, width: int, rows: int, cols: int):
    """(nb, n_leaf) bool: does a leaf's screen box overlap the pixel tile of
    each block of the `tile_order` layout (`wavefront.py:618-635`)? Tile
    (ti, tj) spans [tj*cols - 0.5, (tj+1)*cols - 0.5) in x, likewise in y:
    the ±0.5 px jitter range around its pixels."""
    n_ti, n_tj = height // rows, width // cols
    dev = leaf_screen.device
    ty0 = torch.arange(n_ti, dtype=torch.float32, device=dev)[:, None, None] * rows - 0.5
    tx0 = torch.arange(n_tj, dtype=torch.float32, device=dev)[None, :, None] * cols - 0.5
    hit = ((leaf_screen[None, None, :, 0] <= tx0 + cols)
           & (leaf_screen[None, None, :, 1] >= tx0)
           & (leaf_screen[None, None, :, 2] <= ty0 + rows)
           & (leaf_screen[None, None, :, 3] >= ty0))
    return hit.reshape(n_ti * n_tj, -1)


def tile_order(height: int, width: int, rows: int = TILE_ROWS,
               cols: int = LANES // TILE_ROWS, *, device):
    """Primary-ray permutation, row-major pixels → (rows x cols) pixel tiles,
    one ray block each (`wavefront.py:697-706`); None if the image does not
    tile evenly."""
    if height % rows or width % cols:
        return None
    ids = torch.arange(height * width, dtype=torch.int64, device=device)
    t = ids.reshape(height // rows, rows, width // cols, cols)
    return t.permute(0, 2, 1, 3).reshape(-1)


@dataclasses.dataclass
class WaveScene:
    """A packet packed for `trace` (`wavefront.py:538-550, 638-694`), on the
    packet's device. Built once per `render_step`, reused by every sample."""

    tris: torch.Tensor  # (n_leaf * LEAF, 32) Morton-ordered pack_tri32 rows
    rows: torch.Tensor  # (n_leaf * LEAF, 12) the same leaves' compact
    #                     intersection rows (`pack_rows`), which the sweeps read
    boxes: torch.Tensor  # (n_leaf, 8) leaf boxes, pack_tile_boxes
    sphs: torch.Tensor  # (S, 16) pack_sph16
    mats: torch.Tensor  # (max(num_mats, mk.STAGED_MATS), 8) pack_mats
    sky: torch.Tensor  # (8,): bottom rgb, top rgb, 0, 0
    scene_lo: torch.Tensor  # (3,) bounds of the valid triangles: the
    scene_hi: torch.Tensor  # (3,) coherence key's Morton cells
    n_leaf: int
    n_sph: int
    num_mats: int
    tri_rows: int  # T, the packet's padded triangle rows: rows >= T of `tris`
    #               are dead, and sphere s is row T + s of the unified table
    cull_boxes: torch.Tensor  # (n_super * 8, 8) `boxes` dilated (CULL_PAD_REL),
    #                           in whole supertiles
    super_boxes: torch.Tensor  # (n_super, 8) their unions, pack_super_boxes
    mask_supers: torch.Tensor  # (n_super, 8) the unions of `boxes` themselves:
    #                            the mask kernel's upper level past 1,024 leaves
    perm_tri: torch.Tensor = None  # (T,) Morton permutation of packet rows
    leaf_screen: torch.Tensor = None  # (n_leaf, 4) with a screen camera


def pack_rows(tris, perm):
    """(N, 12) compact intersection rows of (N, 32) float32 pack_tri32 rows
    (wave.cuh kRowStride): v0, e1 = v1 - v0, e2 = v2 - v0 (each one float32
    subtraction, the bits a kernel computes), valid, then row m's packet row
    ``perm[m]`` as int32 bits, 0 past the packet's rows, and 0."""
    v0 = tris[:, 0:3]
    rows = torch.cat([v0, tris[:, 3:6] - v0, tris[:, 6:9] - v0, tris[:, 18:19],
                      tris.new_zeros((tris.shape[0], 2))], dim=1).contiguous()
    rows.view(torch.int32)[:perm.shape[0], 10] = perm.to(torch.int32)
    return rows


def cull_tables(boxes, scale):
    """(cull_boxes, super_boxes) of the (n_leaf, 8) leaf boxes: grown by
    CULL_PAD_REL * ``scale`` on every side (an empty box stays empty), padded
    with empty boxes to whole supertiles, and the supertiles' unions."""
    pad = CULL_PAD_REL * scale
    grown = torch.cat([boxes[:, 0:3] - pad, boxes[:, 3:6] + pad, boxes[:, 6:]], dim=1)
    cull = torch.cat([grown, mk.empty_boxes((-boxes.shape[0]) % mk.SUPER,
                                            device=boxes.device)])
    return cull.contiguous(), mk.pack_super_boxes(cull).contiguous()


@torch.no_grad()
def prepare_scene(packet, screen_cam=None, leaf: int = LEAF,
                  morton: bool = True) -> WaveScene:
    """Pack ``packet`` for `trace`, `megakernel.trace_culled` and the staged
    sweep (`sweep_kernel`): world-space triangles in Morton order, in whole
    leaves of ``leaf`` rows (the last one padded with invalid rows), as
    32-float and compact rows, their boxes (also grown for the per-ray culls
    and padded to whole supertiles with empty boxes, and the supertiles'
    union boxes), the spheres, materials (`mk.pack_mats`) and sky, the
    scene bounds, and with ``screen_cam`` the leaves' screen boxes for
    bounce-0 binning; the union boxes of the leaves' own boxes by supertile
    for the mask. ``morton=False`` keeps the
    packet's own row order (``perm_tri`` None): the unculled megakernel of
    `megakernel.py:1255-1267`. Unlike the reference, no leaf is added for
    shortlist padding, the leaf count is not rounded up to 128, and the
    triangle table is not padded to whole supertiles. Detached."""
    v0, v1, v2, n0, n1, n2 = packet.world_triangles()
    dev = packet.device
    tri_valid, tri_mat = packet.tri_valid, packet.tri_mat
    T = v0.shape[0]
    perm = None
    if T and morton:
        perm = mk.morton_order(v0, v1, v2, tri_valid)
        v0, v1, v2, n0, n1, n2 = (x[perm] for x in (v0, v1, v2, n0, n1, n2))
        tri_valid, tri_mat = tri_valid[perm], tri_mat[perm]
    n_leaf = -(-T // leaf)
    tris = mk.pack_tri32(v0, v1, v2, n0, n1, n2, tri_valid, tri_mat)
    tris = torch.cat([tris, tris.new_zeros((n_leaf * leaf - T, 32))])
    if n_leaf:
        boxes = mk.pack_tile_boxes(v0, v1, v2, tri_valid, leaf)
        pts_lo = torch.minimum(torch.minimum(v0, v1), v2)
        pts_hi = torch.maximum(torch.maximum(v0, v1), v2)
        vf = tri_valid.to(torch.float32)[:, None]
        scene_lo = torch.amin(torch.where(vf > 0.5, pts_lo, 1e30), dim=0)
        scene_hi = torch.amax(torch.where(vf > 0.5, pts_hi, -1e30), dim=0)
    else:
        tris = tris.new_zeros((leaf, 32))  # one invalid leaf: a non-empty table
        boxes = mk.empty_boxes(1, device=dev)
        scene_lo = torch.zeros(3, device=dev)
        scene_hi = torch.ones(3, device=dev)
    rows = pack_rows(tris, perm if perm is not None else torch.arange(T, device=dev))
    leaf_screen = None
    if screen_cam is not None and n_leaf:
        leaf_screen = leaf_screen_boxes(v0, v1, v2, tri_valid, screen_cam, leaf, n_leaf)
    sky = torch.cat([packet.sky_bottom, packet.sky_top, torch.zeros(2, device=dev)])
    sphs = mk.pack_sph16(packet.sph_center, packet.sph_radius, packet.sph_valid,
                         packet.sph_mat)
    if sphs.shape[0] == 0:
        sphs = sphs.new_zeros((1, 16))  # one invalid row: the winner gather has a row
    scale = torch.maximum(scene_lo.abs().amax(), scene_hi.abs().amax())
    cull_boxes, super_boxes = cull_tables(boxes, scale)
    mask_supers = mk.pack_super_boxes(boxes).contiguous()
    mats = mk.pack_mats(packet.mat_kind, packet.mat_albedo, packet.mat_param)
    return WaveScene(
        tris=tris.contiguous(), rows=rows, boxes=boxes.contiguous(), sphs=sphs.contiguous(),
        mats=mats, sky=sky.to(torch.float32).contiguous(), scene_lo=scene_lo,
        scene_hi=scene_hi, n_leaf=n_leaf, n_sph=sphs.shape[0],
        num_mats=int(packet.num_materials), tri_rows=T, cull_boxes=cull_boxes,
        super_boxes=super_boxes, mask_supers=mask_supers, perm_tri=perm,
        leaf_screen=leaf_screen)


# ---- the mask kernel (B7) ----------------------------------------------------

class MaskParams(ctypes.Structure):
    """Field for field `ptre::MaskParams` (wave.cuh)."""

    _fields_ = [("t_min", ctypes.c_float), ("r_pad", ctypes.c_int32),
                ("n_leaf", ctypes.c_int32)]


def wave_mask_reference(state, boxes, t_min: float, lanes: int = LANES):
    """Plain version of the mask kernel: (nb, n_leaf) bool, True where some
    live ray of the block passes leaf l's slab test ``tn <= tf and tf >=
    t_min`` (`wavefront.py:102-157`). Loops over leaves."""
    r_pad = state.shape[1]
    nb = r_pad // lanes
    o = state[0:3]
    iv = [mk.slab_inv(state[3 + k]) for k in range(3)]
    live = state[9] > 0.5
    t_min = mk.f32(t_min)
    mask = torch.zeros((nb, boxes.shape[0]), dtype=torch.bool, device=state.device)
    for l, box in enumerate(boxes[:, :6].tolist()):
        tn, tf = mk.slab_interval(box, o, iv)
        ok = (tn <= tf) & (tf >= t_min) & live
        mask[:, l] = ok.view(nb, lanes).any(dim=1)
    return mask


def _check_lanes(r_pad: int, lanes: int):
    if not (32 <= lanes <= 256 and lanes % 32 == 0 and r_pad % lanes == 0):
        raise RendererError(f"the wavefront kernels take 32 <= lanes <= 256, a multiple "
                            f"of 32 dividing the {r_pad} state columns; got {lanes}")


#: the mask kernel's counters (`wave_mask`'s ``stats``): slab tests of
#: supertile boxes and of leaf boxes, each counted once for every live ray of
#: the warp that made it, and the live rays
MASK_STATS = ("supertile_tests", "leaf_tests", "live_rays")


def wave_mask(state, boxes, t_min: float, lanes: int = LANES, stats=None, supers=None):
    """The (nb, n_leaf) bool cull mask of one bounce. CUDA tensors launch
    `csrc/mask_kernel.cu` (counted in ``mask_launches``); CPU tensors run
    `wave_mask_reference`; anything else raises. Up to 1,024 leaves the
    kernel stages the boxes in shared memory; past that it reads them and
    ``supers``, their (ceil(n_leaf / 8), 8) supertile unions
    (`WaveScene.mask_supers`; None: formed here), through L1/L2.
    ``stats``: None, or a zeroed (3,) int64 CUDA tensor that the counting
    instantiation adds `MASK_STATS` into (the verdicts are the same)."""
    global mask_launches
    if state.device.type == "cpu":
        return wave_mask_reference(state, boxes, t_min, lanes)
    if state.device.type != "cuda":
        raise RendererError(f"wave_mask runs on cuda or cpu, not {state.device}")
    r_pad, n_leaf = state.shape[1], boxes.shape[0]
    if supers is None:
        supers = mk.pack_super_boxes(boxes).contiguous()
    mk.check_tensors("state", state.device, [
        ("state", state, (STATE_ROWS, r_pad), torch.float32),
        ("boxes", boxes, (n_leaf, 8), torch.float32),
        ("supers", supers, (-(-n_leaf // mk.SUPER), 8), torch.float32)])
    _check_lanes(r_pad, lanes)
    if not 1 <= n_leaf <= MAX_MASK_LEAVES:
        raise RendererError(f"the mask kernel takes 1 to {MAX_MASK_LEAVES} leaves, "
                            f"got {n_leaf}")
    if stats is not None:
        mk.check_tensors("state", state.device, [
            ("stats", stats, (len(MASK_STATS),), torch.int64)])
    mask = torch.empty((r_pad // lanes, n_leaf), dtype=torch.bool, device=state.device)
    p = MaskParams(t_min=mk.f32(t_min), r_pad=r_pad, n_leaf=n_leaf)
    lib = build.load_library()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.ptre_wave_mask(ctypes.addressof(p), state.data_ptr(), boxes.data_ptr(),
                                supers.data_ptr(), mask.data_ptr(),
                                None if stats is None else stats.data_ptr(), lanes, stream)
    if rc != 0:
        raise RendererError(
            f"mask kernel launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    mask_launches += 1
    return mask


# ---- the bounce kernel (B6) ----------------------------------------------------

def _listed(short, cnt, n_leaf: int):
    """(nb, n_leaf) bool: which leaves each block's shortlist holds."""
    nb, width = short.shape
    on = torch.arange(width, device=short.device)[None, :] < cnt[:, None]
    listed = torch.zeros((nb, n_leaf + 1), dtype=torch.bool, device=short.device)
    listed.scatter_(1, torch.where(on, short, n_leaf).long(), on)
    return listed[:, :n_leaf]


def wave_bounce_reference(state, ids, short, cnt, scene: WaveScene, consts, bounce: int,
                          seed: int = 0, sample: int = 0, urand=None, lanes: int = LANES,
                          sel=None, stats: dict = None):
    """Plain version of the bounce kernel: the next (10, r_pad) state (a new
    tensor). Loops over leaves; each leaf's 64 rows are tested against every
    live ray of the blocks that list it, as the TPU kernel sweeps them
    (`wavefront.py:209-466`): no per-ray cull. With ``sel`` (B, R) int32 the
    live rays' winners are written into row ``bounce`` at their ids, in
    place (`record_sel`, `:345-349`). ``stats`` receives the work the
    kernel's per-ray cull leaves, without changing what is swept:
    ``listed_pairs`` ((live ray, listed leaf) pairs, each one slab test) and
    ``own_pairs`` (those whose cull box the ray itself passes before its
    closest hit so far, each 64 row tests); leaves are visited in ascending
    order, as the kernel walks a shortlist."""
    active = state[9] > 0.5
    listed = _listed(short, cnt, scene.n_leaf)
    best = mk.TriBest(state)
    if stats is not None:
        iv = [mk.slab_inv(state[3 + c]) for c in range(3)]
        boxes = scene.cull_boxes[:scene.n_leaf, :6].tolist()
        stats.update(listed_pairs=0, own_pairs=0)
    for leaf in range(scene.n_leaf):
        cand = listed[:, leaf].repeat_interleave(lanes) & active
        if stats is not None:
            tn, tf = mk.slab_interval(boxes[leaf], state[0:3], iv)
            stats["listed_pairs"] += int(cand.sum())
            stats["own_pairs"] += int((cand & (tn <= tf) & (tf >= consts.t_min)
                                       & (tn <= best.t)).sum())
        ray = cand.nonzero().squeeze(1)
        if ray.numel():
            mk.sweep_leaf_reference(scene.tris, leaf, ray, state, consts, best)
    out, winners = mk.finish_bounce_reference(state, ids, best, scene, consts, bounce, seed,
                                              sample, urand)
    if sel is not None:
        keep = active & (ids < sel.shape[1])
        sel[bounce, ids[keep].long()] = winners[keep]
    return out


def _check_bounce_inputs(state, ids, short, cnt, scene: WaveScene, urand, lanes, sel,
                         bounce):
    dev = state.device
    r_pad = state.shape[1]
    nb = r_pad // lanes
    expected = [("state", state, (STATE_ROWS, r_pad), torch.float32),
                ("ids", ids, (r_pad,), torch.int32),
                ("short", short, (nb, short.shape[1] if short.dim() == 2 else -1),
                 torch.int32),
                ("cnt", cnt, (nb,), torch.int32),
                ("tris", scene.tris, (scene.tris.shape[0], 32), torch.float32),
                ("rows", scene.rows, (scene.tris.shape[0], 12), torch.float32),
                ("cull_boxes", scene.cull_boxes, (scene.cull_boxes.shape[0], 8),
                 torch.float32),
                ("sphs", scene.sphs, (scene.n_sph, 16), torch.float32),
                mk.mats_entry(scene.num_mats, scene.mats),
                ("sky", scene.sky, (8,), torch.float32)]
    if urand is not None:
        expected.append(("urand", urand, (urand.shape[0], urand.shape[1]), torch.float32))
    if sel is not None:
        expected.append(("sel", sel, (sel.shape[0], sel.shape[1] if sel.dim() == 2 else -1),
                         torch.int32))
    mk.check_tensors("state", dev, expected)
    if sel is not None and not (0 <= bounce < sel.shape[0] and sel.shape[1] >= 1):
        raise RendererError(f"sel has {sel.shape[0]} bounce rows, bounce is {bounce}")
    _check_lanes(r_pad, lanes)
    if (scene.tris.shape[0] < max(scene.n_leaf, 1) * LEAF or scene.rows.data_ptr() % 16
            or scene.cull_boxes.shape[0] < scene.n_leaf):
        raise RendererError("tris and rows must hold n_leaf whole 64-row leaves, rows "
                            "16-byte aligned, and cull_boxes n_leaf boxes")


def wave_bounce(state, ids, short, cnt, scene: WaveScene, consts, bounce: int,
                seed: int = 0, sample: int = 0, urand=None, lanes: int = LANES, sel=None):
    """One bounce of the sorted state: the next (10, r_pad) state (a new
    tensor). ``ids`` (r_pad,) int32 are the original ray ids; ``short`` /
    ``cnt`` the blocks' shortlists (`shortlists_from_mask`); ``urand`` None
    (Philox keyed by (seed, id, sample)) or (2 + 2 * max_depth, R) external
    uniforms. With ``sel`` (B, R) int32 the recording instantiation runs: it
    writes each live ray's winner (a unified-table row, -1 for a miss) into
    ``sel[bounce, id]`` in place; ids >= R are dropped. CUDA tensors launch
    `csrc/wave_kernel.cu` (counted in ``bounce_launches``); CPU tensors run
    `wave_bounce_reference`; anything else raises."""
    global bounce_launches
    if state.device.type == "cpu":
        return wave_bounce_reference(state, ids, short, cnt, scene, consts, bounce,
                                     seed, sample, urand, lanes, sel)
    if state.device.type != "cuda":
        raise RendererError(f"wave_bounce runs on cuda or cpu, not {state.device}")
    _check_bounce_inputs(state, ids, short, cnt, scene, urand, lanes, sel, bounce)
    r_pad = state.shape[1]
    out = torch.empty_like(state)
    p = mk.wave_params(
        consts, seed, sample, scene, n_rays=0 if urand is None else urand.shape[1],
        r_pad=r_pad, list_stride=short.shape[1], bounce=bounce,
        external_rng=int(urand is not None), n_sel=0 if sel is None else sel.shape[1])
    lib = build.load_library()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.ptre_wave_bounce(
            ctypes.addressof(p), state.data_ptr(), ids.data_ptr(), short.data_ptr(),
            cnt.data_ptr(), scene.tris.data_ptr(), scene.rows.data_ptr(),
            scene.cull_boxes.data_ptr(), scene.sphs.data_ptr(),
            scene.mats.data_ptr(), scene.sky.data_ptr(),
            None if urand is None else urand.data_ptr(), out.data_ptr(),
            None if sel is None else sel.data_ptr(), lanes, stream)
    if rc != 0:
        raise RendererError(
            f"bounce kernel launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    bounce_launches += 1
    return out


# ---- the bounce loop ------------------------------------------------------------

#: bounces `trace` ran (each with live rays), and bounce-0 passes it culled
#: by screen binning instead of the mask kernel, in this process: with
#: ``cull`` a traced sample launches the bounce kernel ``live_bounces``
#: times and the mask kernel ``live_bounces - binned_bounces`` times
live_bounces = 0
binned_bounces = 0


#: the span of each of `trace`'s stages
STAGE_SPANS = {name: "ptre.wave." + name for name in ("gather", "sort", "mask", "compact",
                                                       "bounce")}


class StageTimer:
    """Device time of `trace`'s stages by CUDA events, summed by stage name:
    mask (kernel), compact (shortlists), sort (coherence key + argsort),
    gather (state permutations and the final scatter), bounce (kernel).
    Each stage opens its span (`STAGE_SPANS`) as it does without a timer."""

    def __init__(self):
        self._events = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with span(STAGE_SPANS[name]):
            start.record()
            yield
            end.record()
        self._events.append((name, start, end))

    def totals(self):
        """{stage: (ms, calls)}; synchronises."""
        torch.cuda.synchronize()
        out = {}
        for name, start, end in self._events:
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + start.elapsed_time(end), n + 1)
        return out


def _stage_span(name: str):
    return span(STAGE_SPANS[name])


def all_leaves(nb: int, n_leaf: int, *, device):
    """Shortlists that sweep every leaf (``cull=False``, the brute A/B)."""
    short = torch.arange(n_leaf, dtype=torch.int32, device=device).expand(nb, n_leaf)
    return short.contiguous(), torch.full((nb,), n_leaf, dtype=torch.int32, device=device)


def initial_state(o, d, lanes: int = LANES):
    """(10, r_pad) state of fresh rays (colour 1, live) padded with dead
    columns to whole blocks, and their ids 0..r_pad-1."""
    R = o.shape[0]
    r_pad = -(-R // lanes) * lanes
    state = torch.zeros((STATE_ROWS, r_pad), dtype=torch.float32, device=o.device)
    state[0:3, :R] = o.T
    state[3:6, :R] = d.T
    state[6:10, :R].fill_(1.0)  # on the device: no host copy
    return state, torch.arange(r_pad, dtype=torch.int32, device=o.device)


def primary_state(o, d, scene: WaveScene, tile_hint=None, cull: bool = True,
                  lanes: int = LANES):
    """The bounce-0 state and ids, in pixel-tile order when ``tile_hint``
    (H, W) tiles the R rays, and then — with ``cull`` and the scene's screen
    boxes, and no padding — the screen-binned bounce-0 shortlists (else
    None) (`wavefront.py:747-785`)."""
    R = o.shape[0]
    state, ids = initial_state(o, d, lanes)
    r_pad = state.shape[1]
    if tile_hint is None:
        return state, ids, None
    t_ord = tile_order(tile_hint[0], tile_hint[1], TILE_ROWS, lanes // TILE_ROWS,
                       device=o.device)
    if t_ord is None or t_ord.shape[0] != R:
        return state, ids, None
    perm0 = torch.cat([t_ord, torch.arange(R, r_pad, device=o.device)])
    state, ids = state[:, perm0], ids[perm0]
    short0 = None
    if cull and scene.leaf_screen is not None and r_pad == R:
        short0 = shortlists_from_mask(screen_block_mask(
            scene.leaf_screen, tile_hint[0], tile_hint[1], TILE_ROWS, lanes // TILE_ROWS))
    return state, ids, short0


def coherence_order(state, scene: WaveScene):
    """The stable permutation that sorts the rays by `coherence_key`."""
    return torch.argsort(coherence_key(state, scene.scene_lo, scene.scene_hi), stable=True)


def trace(o, d, scene: WaveScene, consts, max_depth: int, seed: int = 0,
          sample: int = 0, urand=None, cull: bool = True, tile_hint=None,
          sort_min_live=SORT_MIN_LIVE, lanes: int = LANES, plain: bool = False,
          timer: StageTimer = None, record: bool = False):
    """Wavefront trace, one sample per ray: (R, 3) rays → (R, 3) float32
    linear colour, unclamped (`wavefront.py:709-871`). With ``record`` it
    returns (colour, selections (max_depth, R) int32, ``scene.perm_tri``):
    per bounce each ray's winner as a row of the Morton-permuted unified
    table (``j`` for triangle row j of ``scene.tris``, ``scene.tri_rows + s``
    for sphere s), -1 where the ray missed, had ended, or the bounce was cut
    by the dead-wavefront stop (`:853-857`).

    ``urand`` None draws Philox keyed by (seed, ray, sample); else the (2 + 2
    * max_depth, R) external uniforms. ``tile_hint`` (H, W): the rays are a
    camera's per-pixel rays in row-major order; bounce 0 then runs them as
    pixel tiles, and with ``cull`` and the scene's ``leaf_screen`` (a
    `prepare_scene` with ``screen_cam``) bins them in screen space instead
    of running the mask. ``cull=False`` sweeps every leaf. Before bounce b >
    0 the rays are sorted unless fewer than ``sort_min_live`` of the columns
    live (None: never sort), and the trace stops at the first bounce with no
    live ray. None of these options changes a pixel. ``plain`` runs the
    plain versions on any device (comparisons). Each stage is a span
    (`STAGE_SPANS`), and each read of the live count, where the host waits
    for the card, is the span ``ptre.wave.live_count``; ``timer`` (a
    `StageTimer`, CUDA only) also times the stages."""
    global live_bounces, binned_bounces
    R = o.shape[0]
    dev = o.device
    stage = timer or _stage_span
    mask_fn = (wave_mask_reference if plain
               else functools.partial(wave_mask, supers=scene.mask_supers))
    bounce_fn = wave_bounce_reference if plain else wave_bounce
    with stage("gather"):
        state, ids, short0 = primary_state(o, d, scene, tile_hint, cull, lanes)
    nb = state.shape[1] // lanes
    sel = torch.full((max_depth, R), -1, dtype=torch.int32, device=dev) if record else None
    for b in range(max_depth):
        if b > 0:
            with span("ptre.wave.live_count"):
                n_live = int((state[9] > 0.5).sum())
            if n_live == 0:
                break  # every later bounce would pass every ray through
            if sort_min_live is not None and n_live >= max(
                    int(sort_min_live * state.shape[1]), 1):
                with stage("sort"):
                    perm = coherence_order(state, scene)
                with stage("gather"):
                    state, ids = state[:, perm], ids[perm]
        live_bounces += 1
        if b == 0 and short0 is not None:
            short, cnt = short0
            binned_bounces += 1
        elif cull and scene.n_leaf:
            with stage("mask"):
                mask = mask_fn(state, scene.boxes, consts.t_min, lanes)
            with stage("compact"):
                short, cnt = shortlists_from_mask(mask)
        else:
            short, cnt = all_leaves(nb, scene.n_leaf, device=dev)
        with stage("bounce"):
            state = bounce_fn(state, ids, short, cnt, scene, consts, b, seed, sample,
                              urand, lanes, sel)
    with stage("gather"):
        color = torch.empty((state.shape[1], 3), dtype=torch.float32, device=dev)
        color[ids.long()] = state[6:9].T
    if record:
        return color[:R], sel, scene.perm_tri
    return color[:R]
