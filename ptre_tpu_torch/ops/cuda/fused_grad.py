"""Fused forward + backward of the differentiable trace: one kernel each way.

Port of `ptre_tpu/ops/pallas/fused_grad.py`:

  * forward: a recording trace gives the color straight off the card and the
    per-bounce winner selections — for dense-class packets the recording
    kernel (`megakernel.trace_fused_sel`, `csrc/record_kernel.cu`), for
    triangle-scale packets the wavefront in record mode
    (`wavefront.trace(record=True)`, the production forward) or, forced, the
    culled megakernel (`megakernel.trace_culled_sel`, `csrc/mega_kernel.cu`),
    its A/B partner;
  * backward: `fused_bwd`, one kernel (`csrc/fused_grad_kernel.cu`) that per
    ray gathers each winner's row of the unified (P, 27) table, recomputes
    the replay chain and reverses it with the hand-written adjoint
    (`csrc/replay.cuh`), and accumulates d(table), d(rays) and d(sky). A
    table of at most ``MAX_ROWS`` rows is staged in shared memory beside its
    d(table) accumulator; a larger one is read from a copy padded to 28
    columns in global memory and d(table) is summed by global atomics into a
    28-column buffer (the sphere rows through shared memory);
  * `TraceGrad` ties the two together as `_make_core` does (`:347-378`): the
    forward returns the recording forward's color as the primal, the
    backward runs `fused_bwd`. The triangle-scale forwards record rows of
    the Morton-permuted table, so the differentiable table is permuted the
    same way before it enters and autograd carries d(table) back through
    that gather (`:443-448`).

Gradient semantics are those of `ops/path_replay.replay` (detached
visibility); `fused_bwd_reference`, autograd through it, is the plain
version. The replay chain re-derives each hit with other formulas than the
recording trace (a det == 0 guard against |det| < det_eps, a divide by the
radius against a multiply by its inverse), so its forward value differs at
rounding level: the primal is always the recording forward's color.

Uniforms: ``urand`` (2 + 2B, R), or Philox draws keyed by (seed, ray,
sample, draw) that the backward kernel regenerates instead of storing.

Not ported (TPU-only): ``fits`` / ``_BWD_VMEM_BUDGET``, ``_pack_table3``,
``_BWD_LANES`` and the lane caps: every packet the wavefront supports takes
this path.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Union

import torch

from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.ops import path_replay
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import wavefront as wf

#: kernel launches made by `fused_bwd` in this process
launches = 0
#: unified-table rows the backward kernel can stage in shared memory (128
#: padded triangle rows + 64 spheres, the dense class; `kMaxRows` in
#: fused_grad_kernel.cu): a larger table takes the global-table instantiation
MAX_ROWS = 192
#: sphere rows the global-table instantiation accumulates in shared memory
#: (`kMaxSphAcc`); past it they too go by global atomics
MAX_SPH_ACC = 64
#: `trace_grad`'s forward kinds: the values of ``force`` besides None
FORWARDS = ("dense", "wavefront", "culled", "uncull")


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

    CUDA tensors launch the fused backward kernel once (counted in
    ``launches``) — the shared-memory instantiation for a table of at most
    ``MAX_ROWS`` rows, else the global-table one — and sum its per-block
    partials; CPU tensors run `fused_bwd_reference`; anything else raises.
    d(table) and d(sky) are summed by atomics in no fixed order, so they
    vary from run to run at float rounding; d(o), d(d) do not.
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
    if not (P >= 1 and 0 <= sph_offset <= P):
        raise RendererError(f"the backward kernel takes a table of >= 1 rows with the "
                            f"spheres from row sph_offset; got {P} rows, sph_offset "
                            f"{sph_offset}")
    staged = P <= MAX_ROWS
    lib = build.load_library()
    params = mk.trace_params(R, consts, max_depth, seed, sample, urand is not None,
                             sph_offset=sph_offset, n_rows=P)
    d_o = torch.empty_like(o)
    d_d = torch.empty_like(d)
    with torch.cuda.device(o.device):
        n_blocks = lib.ptre_fused_bwd_blocks(R, int(not staged), max_depth, P)
        if n_blocks < 1:
            raise RendererError("fused backward: could not size the persistent grid")
        dsky_part = torch.empty((n_blocks, 8), dtype=torch.float32, device=o.device)
        stream = torch.cuda.current_stream(o.device).cuda_stream
        common = (ctypes.addressof(params), table.data_ptr(), sky6.data_ptr(),
                  o.data_ptr(), d.data_ptr(), sel.data_ptr(),
                  None if urand is None else urand.data_ptr(), dcol.data_ptr(),
                  d_o.data_ptr(), d_d.data_ptr())
        if staged:
            dtab_part = torch.empty((n_blocks, P, 27), dtype=torch.float32, device=o.device)
            rc = lib.ptre_fused_bwd(*common, dtab_part.data_ptr(), dsky_part.data_ptr(),
                                    n_blocks, stream)
        else:
            n_sph = P - sph_offset
            n_acc = n_sph if n_sph <= MAX_SPH_ACC else 0
            # rows of 28 floats: seven 16-byte loads and float4 atomics a row
            padded = torch.nn.functional.pad(table, (0, 1)).contiguous()
            dtable = torch.zeros((P, 28), dtype=torch.float32, device=o.device)
            dsph_part = torch.empty((n_blocks, n_acc, 27), dtype=torch.float32,
                                    device=o.device)
            rc = lib.ptre_fused_bwd_global(ctypes.addressof(params), padded.data_ptr(),
                                           *common[2:], dtable.data_ptr(),
                                           dsph_part.data_ptr(), dsky_part.data_ptr(),
                                           n_blocks, n_acc, stream)
    if rc != 0:
        raise RendererError(
            f"fused backward launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    launches += 1
    if staged:
        dtable = dtab_part.sum(dim=0)
    else:
        dtable = dtable[:, :27].contiguous()
        if n_acc:
            dtable[sph_offset:sph_offset + n_acc] += dsph_part.sum(dim=0)
    return dtable, dsky_part[:, :6].sum(dim=0), d_o, d_d


def supported(packet) -> bool:
    """Whether `trace_grad` has a forward for the packet by default: the
    dense recording kernel, or the wavefront for everything it supports.
    From the packet's counts alone."""
    return mk.dense_supported(packet) or wf.supports(packet)


def check_supported(packet, force: Optional[str] = None) -> None:
    """Raise unless `trace_grad` has a forward for the packet: the dense
    recording kernel, or the wavefront / culled megakernel for everything
    `wavefront.supports`. No tensor is touched."""
    if force is not None and force not in FORWARDS:
        raise RendererError(f"force must be None or one of {FORWARDS}, got {force!r}")
    if force == "dense":
        if not mk.dense_supported(packet):
            raise RendererError(
                f"force='dense' needs a dense-class packet (<= {mk.DENSE_MAX_TRI} "
                f"triangles, <= {mk.DENSE_MAX_SPH} spheres, <= {mk.MAX_MATS} materials)")
        return
    if wf.supports(packet) or (force is None and mk.dense_supported(packet)):
        return
    raise NotImplementedError(
        "the fused gradient kernels take dense-class packets and packets the wavefront "
        f"supports (<= {wf.MAX_WAVE_TRIS} triangle rows, <= {wf.MAX_WAVE_SPHS} sphere "
        f"rows, <= {mk.MAX_MATS} materials); this packet has "
        f"{packet.tri_valid.shape[0]} triangle rows, {packet.sph_center.shape[0]} sphere "
        f"rows, {packet.num_materials} materials. It takes the staged trace: "
        "integrator.trace routes it there (grad_sweep 'auto' or 'staged').")


@dataclasses.dataclass
class Forward:
    """A packet packed for one of `trace_grad`'s forwards: built once
    (`prepare_forward`), reused by every sample of a step."""

    kind: str  # one of FORWARDS
    scene: Union[mk.PackedScene, wf.WaveScene]


def prepare_forward(packet, force: Optional[str] = None, screen_cam=None) -> Forward:
    """Choose and pack the forward of ``packet`` (`fused_grad.py:411-435`):
    ``force`` None takes the dense recording kernel when the packet is
    dense-class, else the wavefront; "culled" / "uncull" the culled
    megakernel with culling on / off (the latter in the packet's own row
    order). ``screen_cam`` gives the wavefront its bounce-0 screen boxes.
    Packing is discrete (a sort, boxes): it runs without a graph."""
    check_supported(packet, force)
    kind = force or ("dense" if mk.dense_supported(packet) else "wavefront")
    with torch.no_grad():
        if kind == "dense":
            return Forward(kind, mk.pack_scene(packet))
        return Forward(kind, wf.prepare_scene(
            packet, screen_cam=screen_cam if kind == "wavefront" else None,
            morton=kind != "uncull"))


@dataclasses.dataclass
class _TraceSpec:
    """Non-tensor arguments of `TraceGrad` (and the uniforms, which get no
    gradient)."""

    forward: Forward
    consts: mk.TraceConsts
    max_depth: int
    seed: int
    sample: int
    urand: Optional[torch.Tensor]
    tile_hint: Optional[tuple]  # (H, W) when the rays are a camera's pixels


class TraceGrad(torch.autograd.Function):
    """Recording trace forward, fused kernel backward (`_make_core`).
    ``table`` is in the row order the forward records: Morton-permuted for
    the wavefront and the culled megakernel."""

    @staticmethod
    def forward(ctx, o, d, table, sky6, spec: _TraceSpec):
        s, scene = spec, spec.forward.scene
        args = (o, d, scene, s.consts, s.max_depth, s.seed, s.sample, s.urand)
        if s.forward.kind == "dense":
            color, sel = mk.trace_fused_sel(*args)
        elif s.forward.kind == "wavefront":
            color, sel, _ = wf.trace(*args, tile_hint=s.tile_hint, record=True)
        else:
            color, sel, _ = mk.trace_culled_sel(*args, cull=s.forward.kind == "culled")
        ctx.save_for_backward(o, d, table, sky6, sel)
        ctx.spec = spec
        return color

    @staticmethod
    def backward(ctx, dcolor):
        o, d, table, sky6, sel = ctx.saved_tensors
        s = ctx.spec
        dtable, dsky6, d_o, d_d = fused_bwd(
            table, sky6, o, d, sel, dcolor.contiguous(), s.consts, s.max_depth,
            s.forward.scene.tri_rows, s.seed, s.sample, s.urand)
        return d_o, d_d, dtable, dsky6, None


def trace_grad(o, d, packet, config, seed: int = 0, sample: int = 0,
               urand=None, force: Optional[str] = None, screen_cam=None,
               forward: Optional[Forward] = None):
    """Differentiable fused trace → linear color (R, 3), unclamped.

    Gradients reach the primary rays ``o``, ``d`` (→ camera) and the packet's
    float leaves through the unified table (→ transforms, geometry,
    materials, sky). ``urand``: (2 + 2*max_depth, R) uniforms, or None for
    Philox draws keyed by (seed, ray, sample, draw).

    ``force``: None (the dense recording kernel when the packet is
    dense-class, else the sorted wavefront), "dense", "wavefront", "culled"
    (the culled megakernel, kept for A/B) or "uncull" (the same with culling
    off, the brute reference). ``screen_cam``: the camera whose jittered
    pixel rays ``o``, ``d`` are, in row-major order; used, detached, only
    when ``R == config.width * config.height``: the wavefront then runs
    bounce 0 as pixel tiles binned in screen space. ``forward``: the packet
    already packed by `prepare_forward` with the same ``force`` and
    ``screen_cam`` (a step packs once for all its samples); packing is
    discrete, so only the unified table carries gradients to the packet.
    """
    if forward is None:
        forward = prepare_forward(packet, force, screen_cam)
    table, T, sky6 = path_replay.build_table(packet)
    perm = getattr(forward.scene, "perm_tri", None)
    if perm is not None:
        # the recorded triangle rows index the Morton-permuted table; autograd
        # carries d(table) back through the gather
        table = torch.cat([table[:T][perm], table[T:]])
    hint = None
    if screen_cam is not None and o.shape[0] == config.width * config.height:
        hint = (config.height, config.width)
    spec = _TraceSpec(forward, mk.TraceConsts.from_config(config), config.max_depth,
                      seed, sample, urand, hint)
    return TraceGrad.apply(o.contiguous(), d.contiguous(), table.contiguous(),
                           sky6.contiguous(), spec)
