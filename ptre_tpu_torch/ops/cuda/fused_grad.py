"""Fused forward + backward of the differentiable trace: one kernel each way.

Port of `ptre_tpu/ops/pallas/fused_grad.py`:

  * forward: the recording trace (`megakernel.trace_fused_sel`, kernel
    `csrc/record_kernel.cu`) gives the color straight off the card and the
    per-bounce winner selections;
  * backward: `fused_bwd`, one kernel (`csrc/fused_grad_kernel.cu`) that per
    ray gathers each winner's row of the unified (P, 27) table, recomputes
    the replay chain and reverses it with the hand-written adjoint
    (`csrc/replay.cuh`), and accumulates d(table), d(rays) and d(sky).
  * `TraceGrad` ties the two together as `_make_core` does (`:347-378`): the
    forward returns the recording kernel's color as the primal, the backward
    runs `fused_bwd`.

Gradient semantics are those of `ops/path_replay.replay` (detached
visibility); `fused_bwd_reference`, autograd through it, is the plain
version. The replay chain re-derives each hit with other formulas than the
recording trace (a det == 0 guard against |det| < det_eps, a divide by the
radius against a multiply by its inverse), so its forward value differs at
rounding level: the primal is always the recording kernel's color.

Uniforms: ``urand`` (2 + 2B, R), or Philox draws keyed by (seed, ray,
sample, draw) that the backward kernel regenerates instead of storing.

Not ported (TPU-only): ``fits`` / ``_BWD_VMEM_BUDGET``, ``_pack_table3``,
``_BWD_LANES`` and the lane caps.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ptre_tpu.utils.errors import RendererError
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk

#: kernel launches made by `fused_bwd` in this process
launches = 0
#: unified-table rows the backward kernel stages (128 padded triangle rows
#: + 64 spheres, the dense class; `kMaxRows` in fused_grad_kernel.cu)
MAX_ROWS = 192


def fused_bwd_reference(table, sky6, o, d, sel, dcol, consts, max_depth: int,
                        sph_offset: int, seed: int = 0, sample: int = 0,
                        urand=None):
    """Plain PyTorch version of the backward kernel: autograd of the plain
    replay with the color cotangent ``dcol`` (R, 3). Returns (d table
    (P, 27), d sky6 (6,), d o (R, 3), d d (R, 3))."""
    ur = mk.trace_uniforms(o, max_depth, seed, sample, urand)
    leaves = [t.detach().requires_grad_(True) for t in (table, sky6, o, d)]
    with torch.enable_grad():
        color = path_replay.replay_table(leaves[2], leaves[3], sel, ur, leaves[0],
                                         leaves[1], sph_offset, consts, max_depth)
        grads = torch.autograd.grad(color, leaves, grad_outputs=dcol)
    return tuple(grads)


def fused_bwd(table, sky6, o, d, sel, dcol, consts, max_depth: int,
              sph_offset: int, seed: int = 0, sample: int = 0, urand=None):
    """The whole backward of a recorded trace: (d table, d sky6, d o, d d).

    CUDA tensors launch the fused backward kernel (counted in ``launches``)
    and sum its per-block partials; CPU tensors run `fused_bwd_reference`;
    anything else raises.
    """
    global launches
    if o.device.type == "cpu":
        return fused_bwd_reference(table, sky6, o, d, sel, dcol, consts, max_depth,
                                   sph_offset, seed, sample, urand)
    if o.device.type != "cuda":
        raise RendererError(f"fused_bwd runs on cuda or cpu, not {o.device}")
    R, P = o.shape[0], table.shape[0]
    mk.check_rays(o, d, max_depth, urand, [
        ("table", table, (P, 27), torch.float32), ("sky6", sky6, (6,), torch.float32),
        ("sel", sel, (max_depth, R), torch.int32), ("dcol", dcol, (R, 3), torch.float32)])
    if not (1 <= P <= MAX_ROWS and 0 <= sph_offset <= P):
        raise RendererError(f"the backward kernel stages 1..{MAX_ROWS} table rows "
                            f"with the spheres from row sph_offset; got {P} rows, "
                            f"sph_offset {sph_offset}")
    lib = build.load_library()
    params = mk.trace_params(R, consts, max_depth, seed, sample, urand is not None,
                             sph_offset=sph_offset, n_rows=P)
    d_o = torch.empty_like(o)
    d_d = torch.empty_like(d)
    with torch.cuda.device(o.device):
        n_blocks = lib.ptre_fused_bwd_blocks(R)
        if n_blocks < 1:
            raise RendererError("fused backward: could not size the persistent grid")
        dtab_part = torch.empty((n_blocks, P, 27), dtype=torch.float32, device=o.device)
        dsky_part = torch.empty((n_blocks, 8), dtype=torch.float32, device=o.device)
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.ptre_fused_bwd(
            ctypes.addressof(params), table.data_ptr(), sky6.data_ptr(),
            o.data_ptr(), d.data_ptr(), sel.data_ptr(),
            None if urand is None else urand.data_ptr(), dcol.data_ptr(),
            d_o.data_ptr(), d_d.data_ptr(), dtab_part.data_ptr(),
            dsky_part.data_ptr(), n_blocks, stream)
    if rc != 0:
        raise RendererError(
            f"fused backward launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    launches += 1
    return dtab_part.sum(dim=0), dsky_part[:, :6].sum(dim=0), d_o, d_d


def require_dense(packet) -> None:
    """Raise NotImplementedError unless the dense kernels take the packet."""
    if not mk.dense_supported(packet):
        raise NotImplementedError(
            "the differentiable trace takes dense-class packets only (<= "
            f"{mk.DENSE_MAX_TRI} triangles, <= {mk.DENSE_MAX_SPH} spheres, <= "
            f"{mk.MAX_MATS} materials); this packet has {packet.num_triangles} "
            f"triangles, {packet.num_spheres} spheres, {packet.num_materials} "
            "materials. Larger scenes need the staged trace or the triangle-scale "
            "gradient path (the wavefront's record mode, the culled megakernel, a "
            "backward with its table in global memory), still to be ported "
            "(ROADMAP A5, A14, B11).")


@dataclasses.dataclass
class _TraceSpec:
    """Non-tensor arguments of `TraceGrad` (and the uniforms, which get no
    gradient)."""

    scene: mk.PackedScene
    consts: mk.TraceConsts
    max_depth: int
    seed: int
    sample: int
    urand: Optional[torch.Tensor]


class TraceGrad(torch.autograd.Function):
    """Recording trace forward, fused kernel backward (`_make_core`)."""

    @staticmethod
    def forward(ctx, o, d, table, sky6, spec: _TraceSpec):
        color, sel = mk.trace_fused_sel(o, d, spec.scene, spec.consts,
                                        spec.max_depth, spec.seed, spec.sample,
                                        spec.urand)
        ctx.save_for_backward(o, d, table, sky6, sel)
        ctx.spec = spec
        return color

    @staticmethod
    def backward(ctx, dcolor):
        o, d, table, sky6, sel = ctx.saved_tensors
        s = ctx.spec
        dtable, dsky6, d_o, d_d = fused_bwd(
            table, sky6, o, d, sel, dcolor.contiguous(), s.consts, s.max_depth,
            s.scene.tri_rows, s.seed, s.sample, s.urand)
        return d_o, d_d, dtable, dsky6, None


def trace_grad(o, d, packet, config, seed: int = 0, sample: int = 0,
               urand=None):
    """Differentiable fused trace → linear color (R, 3), unclamped.

    Gradients reach the primary rays ``o``, ``d`` (→ camera) and the packet's
    float leaves through the unified table (→ transforms, geometry,
    materials, sky). ``urand``: (2 + 2*max_depth, R) uniforms, or None for
    Philox draws keyed by (seed, ray, sample, draw). Dense-class packets
    only (`megakernel.dense_supported`).
    """
    require_dense(packet)
    table, T, sky6 = path_replay.build_table(packet)
    with torch.no_grad():
        scene = mk.pack_scene(packet)
    spec = _TraceSpec(scene, mk.TraceConsts.from_config(config), config.max_depth,
                      seed, sample, urand)
    return TraceGrad.apply(o.contiguous(), d.contiguous(), table.contiguous(),
                           sky6.contiguous(), spec)
