"""The staged route's closest-hit sweep: wrapper of `csrc/sweep_kernel.cu`.

Port of `ptre_tpu/ops/pallas/intersect_kernel.py` (`_sweep_kernel` `:95`,
`sweep` `:250`). Per ray: the closest valid triangle by Möller–Trumbore, the
lowest packet row winning a tie, then every valid sphere bounded by the
closest triangle, the far-root quirk kept. Selections only (detached, no
adjoint): gradients flow through the O(R) recompute of
`ops/intersect.closest_hit`.

`prepare` packs a packet once per trace: the leaf table of
`wavefront.prepare_scene` (compact rows in Morton order with their packet
rows, dilated leaf and supertile boxes, 16-float sphere rows). `sweep_packed`
runs one bounce: one launch on CUDA tensors (counted in ``launches``), where
each ray walks the boxes and tests only the rows of the leaves it passes
itself (culled, conservatively: the brute force's selections); on CPU
tensors the plain version, the brute-force `ops/intersect.sweep_edges` over
the rows in the packet's order. Any other device raises, and nothing falls
back. The kernel is built without FMA contraction, so its selections equal
the plain version's exactly. A dead ray (``active`` False) is not swept and
selects (0, False, 0, False).

Not carried over (TPU layout): the (8, R) ray rows, adaptive tiles and lane
widths, padding of the tables to a tile.
"""

from __future__ import annotations

import ctypes

import torch

from ptre_tpu_torch.ops import intersect
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import wavefront as wf
from ptre_tpu_torch.utils.errors import RendererError

#: kernel launches made by `sweep_packed` in this process
launches = 0
#: the counters a launch adds to ``stats``: box tests made, (ray, supertile)
#: and (ray, leaf) pairs whose box the ray itself passes, (ray, leaf) pairs
#: swept by the warps (a warp visits a leaf any of its lanes passes), live
#: rays
STATS = ("box_tests", "supers_passed", "pairs_passed", "pairs_swept", "live_rays")


class SweepParams(ctypes.Structure):
    """Field for field `ptre::sweep::SweepParams` (sweep.cuh)."""

    _fields_ = [("t_min", ctypes.c_float), ("t_max", ctypes.c_float),
                ("det_eps", ctypes.c_float), ("n_rays", ctypes.c_int32),
                ("n_leaf", ctypes.c_int32), ("n_super", ctypes.c_int32),
                ("n_sph", ctypes.c_int32)]


def prepare(packet) -> wf.WaveScene:
    """The packet's leaf table for the sweep: `wavefront.prepare_scene`
    without a screen camera (e1, e2 rounded once there, as the plain version
    rounds them)."""
    return wf.prepare_scene(packet)


def sweep_params(scene: wf.WaveScene, n_rays: int, t_min: float, t_max: float,
                 det_eps: float) -> SweepParams:
    return SweepParams(t_min=mk.f32(t_min), t_max=mk.f32(t_max), det_eps=mk.f32(det_eps),
                       n_rays=n_rays, n_leaf=scene.n_leaf,
                       n_super=scene.super_boxes.shape[0], n_sph=scene.n_sph)


def packet_rows(scene: wf.WaveScene):
    """The compact rows of the packet's T triangle rows in the packet's own
    order."""
    T = scene.tri_rows
    rows = torch.empty_like(scene.rows[:T])
    if T:
        rows[scene.perm_tri if scene.perm_tri is not None else slice(None)] = scene.rows[:T]
    return rows


def sweep_packed_reference(o, d, scene: wf.WaveScene, t_min: float, t_max: float,
                           det_eps: float, active=None):
    """Plain version of the kernel: the brute-force `intersect.sweep_edges`
    over the packet's rows, for the rays where ``active`` (None: all) holds,
    (0, False, 0, False) elsewhere. Returns (i_tri int32, hit_tri bool, i_sph
    int32, hit_sph bool)."""
    tr, sp = packet_rows(scene), scene.sphs
    live = (torch.arange(o.shape[0], device=o.device) if active is None
            else active.nonzero().squeeze(1))
    got = intersect.sweep_edges(o[live], d[live], tr[:, 0:3], tr[:, 3:6], tr[:, 6:9],
                                tr[:, 9] > 0.5, sp[:, 0:3], sp[:, 3], sp[:, 4] > 0.5, t_min,
                                t_max, det_eps)
    out = []
    for x in got:
        full = torch.zeros(o.shape[0], dtype=x.dtype, device=o.device)
        full[live] = x
        out.append(full)
    return tuple(out)


def sweep_packed(o, d, scene: wf.WaveScene, t_min: float, t_max: float, det_eps: float,
                 active=None, stats=None):
    """The sweep of (R, 3) rays against the packed scene: (i_tri int32,
    hit_tri bool, i_sph int32, hit_sph bool), (R,) each, in the packet's
    rows. ``active`` (R,) bool or None (all live). CUDA tensors launch the
    kernel once; ``stats`` (5,) int64 on the card, or None, receives the
    counters named in STATS. CPU tensors run `sweep_packed_reference`."""
    global launches
    if o.device.type == "cpu":
        return sweep_packed_reference(o, d, scene, t_min, t_max, det_eps, active)
    if o.device.type != "cuda":
        raise RendererError(f"the sweep runs on cuda or cpu, not {o.device}")
    R = o.shape[0] if o.dim() == 2 else -1
    n_super = scene.super_boxes.shape[0]
    expected = [("o", o, (R, 3), torch.float32), ("d", d, (R, 3), torch.float32),
                ("rows", scene.rows, (scene.rows.shape[0], 12), torch.float32),
                ("cull_boxes", scene.cull_boxes, (n_super * mk.SUPER, 8), torch.float32),
                ("super_boxes", scene.super_boxes, (n_super, 8), torch.float32),
                ("sphs", scene.sphs, (scene.n_sph, 16), torch.float32)]
    if active is not None:
        expected.append(("active", active, (R,), torch.bool))
    if stats is not None:
        expected.append(("stats", stats, (len(STATS),), torch.int64))
    mk.check_tensors("o", o.device, expected)
    if scene.rows.shape[0] < scene.n_leaf * mk.LEAF or n_super * mk.SUPER < scene.n_leaf:
        raise RendererError("the sweep takes n_leaf whole 64-row leaves and their boxes in "
                            "whole supertiles")
    out = torch.empty((4, R), dtype=torch.int32, device=o.device)
    p = sweep_params(scene, R, t_min, t_max, det_eps)
    lib = build.load_library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.ptre_sweep(ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
                            None if active is None else active.data_ptr(),
                            scene.rows.data_ptr(), scene.cull_boxes.data_ptr(),
                            scene.super_boxes.data_ptr(), scene.sphs.data_ptr(),
                            out.data_ptr(), None if stats is None else stats.data_ptr(),
                            stream)
    if rc != 0:
        raise RendererError(f"sweep kernel launch failed: "
                            f"{lib.ptre_cuda_error_string(rc).decode()}")
    launches += 1
    return out[0], out[1].bool(), out[2], out[3].bool()
