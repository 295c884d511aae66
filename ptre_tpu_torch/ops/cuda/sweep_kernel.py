"""The staged route's closest-hit sweep: wrapper of `csrc/sweep_kernel.cu`.

Port of `ptre_tpu/ops/pallas/intersect_kernel.py` (`_sweep_kernel` `:95`,
`sweep` `:250`). Per ray: Möller–Trumbore against every valid triangle row
of the world-space table, keeping the lowest index on a tie, then every
valid sphere bounded by the closest triangle, the far-root quirk kept.
Selections only (detached, no adjoint): gradients flow through the O(R)
recompute of `ops/intersect.closest_hit`.

`prepare` packs the tables once per trace — triangle rows [v0, e1 = v1 -
v0, e2 = v2 - v0, valid, 0, 0], sphere rows [center, r, valid, 0, 0, 0] —
and `sweep_packed` runs one bounce: one launch on CUDA tensors (counted in
``launches``), the plain version `ops/intersect.sweep_edges` on CPU tensors;
any other device raises, and nothing falls back. The kernel is built
without FMA contraction, so its selections equal the plain version's
exactly.

Not carried over (TPU layout): the (8, R) ray rows, adaptive tiles and lane
widths, padding of the tables to a tile.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ptre_tpu_torch.ops import intersect
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.utils.errors import RendererError

#: kernel launches made by `sweep_packed` in this process
launches = 0
TRI_COLS = 12
SPH_COLS = 8


class SweepParams(ctypes.Structure):
    """Field for field `ptre::sweep::SweepParams` (sweep.cuh)."""

    _fields_ = [("t_min", ctypes.c_float), ("t_max", ctypes.c_float),
                ("det_eps", ctypes.c_float), ("n_rays", ctypes.c_int32),
                ("n_tri", ctypes.c_int32), ("n_sph", ctypes.c_int32)]


@dataclasses.dataclass
class SweepTables:
    """The kernel's view of a packet: (T, 12) triangle and (S, 8) sphere
    rows on the packet's device, without a graph."""

    tris: torch.Tensor
    sphs: torch.Tensor


def prepare(packet, world_tris) -> SweepTables:
    """Pack the world-space triangles (`ScenePacket.world_triangles`) and
    the spheres; e1, e2 are rounded once here, as the plain version rounds
    them."""
    with torch.no_grad():
        v0, v1, v2 = (w.detach() for w in world_tris[:3])
        T, S = v0.shape[0], packet.sph_center.shape[0]
        tris = torch.cat([v0, v1 - v0, v2 - v0, packet.tri_valid.float()[:, None],
                          v0.new_zeros((T, 2))], dim=1)
        sphs = torch.cat([packet.sph_center.detach(), packet.sph_radius.detach()[:, None],
                          packet.sph_valid.float()[:, None], v0.new_zeros((S, 3))], dim=1)
    return SweepTables(tris.contiguous(), sphs.contiguous())


def sweep_packed_reference(o, d, tables: SweepTables, t_min: float, t_max: float,
                           det_eps: float):
    """Plain version of the kernel: `intersect.sweep_edges` on the packed
    rows. Returns (i_tri int32, hit_tri bool, i_sph int32, hit_sph bool)."""
    tr, sp = tables.tris, tables.sphs
    return intersect.sweep_edges(o, d, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9], tr[:, 9] > 0.5,
                                 sp[:, 0:3], sp[:, 3], sp[:, 4] > 0.5, t_min, t_max,
                                 det_eps)


def sweep_packed(o, d, tables: SweepTables, t_min: float, t_max: float,
                 det_eps: float):
    """The sweep of (R, 3) rays against packed tables: (i_tri int32, hit_tri
    bool, i_sph int32, hit_sph bool), (R,) each. CUDA tensors launch the
    kernel once; CPU tensors run `sweep_packed_reference`."""
    global launches
    if o.device.type == "cpu":
        return sweep_packed_reference(o, d, tables, t_min, t_max, det_eps)
    if o.device.type != "cuda":
        raise RendererError(f"the sweep runs on cuda or cpu, not {o.device}")
    R = o.shape[0] if o.dim() == 2 else -1
    T, S = tables.tris.shape[0], tables.sphs.shape[0]
    mk.check_tensors("o", o.device, [
        ("o", o, (R, 3), torch.float32), ("d", d, (R, 3), torch.float32),
        ("tris", tables.tris, (T, TRI_COLS), torch.float32),
        ("sphs", tables.sphs, (S, SPH_COLS), torch.float32)])
    out = torch.empty((4, R), dtype=torch.int32, device=o.device)
    p = SweepParams(t_min=mk.f32(t_min), t_max=mk.f32(t_max), det_eps=mk.f32(det_eps),
                    n_rays=R, n_tri=T, n_sph=S)
    lib = build.load_library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.ptre_sweep(ctypes.addressof(p), o.data_ptr(), d.data_ptr(),
                            tables.tris.data_ptr(), tables.sphs.data_ptr(),
                            out.data_ptr(), stream)
    if rc != 0:
        raise RendererError(f"sweep kernel launch failed: "
                            f"{lib.ptre_cuda_error_string(rc).decode()}")
    launches += 1
    return out[0], out[1].bool(), out[2], out[3].bool()

