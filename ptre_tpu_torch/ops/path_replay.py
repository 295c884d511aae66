"""Differentiable path replay over recorded selections, plain PyTorch.

Port of `ptre_tpu/ops/path_replay.py`. The recording trace
(`ops/cuda/megakernel.trace_fused_sel`) records per bounce the winning
primitive of every ray; `replay` rebuilds the same paths from those
selections and the same uniforms, re-deriving hit point, normal, scatter and
weights differentiably through `replay_kernel.chain_bounce`. Autograd
through it gives the detached-visibility gradient (the selections are
constants) w.r.t. geometry, transforms, materials, sky and the primary rays;
it is the plain version of the fused backward kernel
(`ops/cuda/fused_grad.fused_bwd_reference`).

Both primitive classes live in one unified (P, 27) table (`build_table`),
so each bounce gathers one row per ray. The plain replay (`replay_table`)
gathers by an indexed load; the replay route gathers every bounce's rows
once through `take_rows` (`gather_rows`), whose backward, d(table), is
summed in float64. The reference's one-hot matmul
(`path_replay.py:125-135`) is a TPU workaround for slow dynamic gathers.

The replay route (`trace_fused_grad`, `path_replay.py:364-394`): the
recording kernel's selections, the winners' rows gathered outside, and the
replay pair inside (`replay_kernel.replay_core`: the chain over the gathered
rows, forward and backward, one kernel each on the card). The reference
keeps it to check the fused route against (`integrator.py:72-73`): the
same estimator and adjoint, with d(table) summed in another order and the
replay chain's colour as the primal (the fused route returns the recording
kernel's). The two agree to float rounding except on rays grazing a large
sphere's horizon, whose float32 conditioning sets how far the routes' geometry
and camera gradients part (`PERF.md`).

Selections, in the port's layout: (B, R) int32 unified row indices — ``j``
for triangle j, ``T + s`` for sphere s (``T`` = the packet's padded triangle
rows), and -1 where the bounce did not hit or the path had already ended.
Uniforms: (2 + 2B, R) float32, rows 2 + 2b and 3 + 2b bounce b's scatter
pair (rows 0-1, the pixel jitter, are not read here).
"""

from __future__ import annotations

import torch

from ptre_tpu_torch.ops import gradsafe
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.ops.cuda import replay_kernel as rpk
from ptre_tpu_torch.ops.cuda.take_rows import take_rows


def build_table(packet):
    """Unified (T + S, 27) table [v0 v1 v2 n0 n1 n2 | center r | kind albedo
    param], zeros in the other class's columns (`path_replay.py:189-212`).
    Returns (table, T, sky6); every float leaf stays differentiable."""
    v0, v1, v2, n0, n1, n2 = packet.world_triangles()
    T = v0.shape[0]
    S = packet.sph_center.shape[0]
    dev = v0.device
    mat_cols = torch.cat(
        [packet.mat_kind.to(torch.float32)[:, None], packet.mat_albedo,
         packet.mat_param[:, None]], dim=1)  # (M, 5): kind, albedo.rgb, param
    tri_rows = torch.cat(
        [v0, v1, v2, n0, n1, n2, torch.zeros((T, 4), dtype=torch.float32, device=dev),
         take_rows(mat_cols, packet.tri_mat)], dim=1)
    sph_rows = torch.cat(
        [torch.zeros((S, 18), dtype=torch.float32, device=dev), packet.sph_center,
         packet.sph_radius[:, None], take_rows(mat_cols, packet.sph_mat)], dim=1)
    table = torch.cat([tri_rows, sph_rows], dim=0)
    sky6 = torch.cat([packet.sky_bottom, packet.sky_top]).to(torch.float32)
    return table, T, sky6


def replay_table(o, d, sel, urand, table, sky6, sph_offset: int, consts,
                 max_depth: int, remat: bool = False):
    """`replay` on a prepared table: (R, 3) linear color.

    ``o``, ``d``: (R, 3) primary rays; ``sel``: (B, R) int32 selections;
    ``urand``: (2 + 2B, R) uniforms; ``table``: (P, 27); ``sky6``: (6,);
    ``sph_offset``: the sphere rows' offset T; ``consts``: `TraceConsts`.
    Gradients flow to ``o``, ``d``, ``table`` and ``sky6``. ``remat``: each
    bounce of the chain is a `gradsafe.remat` region (recomputed in the
    backward, not kept).
    """
    P = table.shape[0]
    # a miss or an ended path gathers the zero row P: it is never read by the
    # chain's taken branches, and its cotangent is dropped with the row
    padded = torch.cat([table, torch.zeros_like(table[:1])], dim=0)
    sky = tuple(sky6[i] for i in range(6))
    o_, d_ = o.unbind(dim=1), d.unbind(dim=1)
    one = torch.ones_like(o_[0])
    c_ = (one, one, one)
    active = torch.ones_like(one, dtype=torch.bool)
    for b in range(max_depth):
        idx = sel[b].long()
        hit = idx >= 0
        use_sph = idx >= sph_offset
        g = padded[torch.where(hit, idx, P)].unbind(dim=1)
        args = (o_, d_, c_, active, g, use_sph, hit, urand[2 + 2 * b], urand[3 + 2 * b],
                sky, consts)
        o_, d_, c_, active = (gradsafe.remat(rpk.chain_bounce, *args) if remat
                              else rpk.chain_bounce(*args))
    return torch.stack(c_, dim=1)


def gather_rows(table, sel):
    """Every bounce's winner rows, (B, R, 27): row ``sel[b, r]`` of the
    (P, 27) table, zeros where it is -1 (`path_replay.py:231-249`), through
    `take_rows` on the table padded with one zero row, its pad row (whose
    cotangents are never read). Differentiable w.r.t. the table: its
    backward, d(table), is summed in float64."""
    P = table.shape[0]
    padded = torch.cat([table, table.new_zeros((1, table.shape[1]))], dim=0)
    idx = torch.where(sel >= 0, sel, P).long()
    return take_rows(padded, idx, pad_row=P)


def replay(o, d, sel, urand, packet, config):
    """Differentiable replay of recorded paths → linear color (R, 3)
    (`path_replay.py:271-361`). Gradients flow to ``o``, ``d`` and the
    packet's float leaves. Under autograd each bounce keeps its residuals,
    or with ``config.remat_replay`` is recomputed in the backward
    (`path_replay.py:353`)."""
    table, T, sky6 = build_table(packet)
    return replay_table(o, d, sel, urand, table, sky6, T,
                        mk.TraceConsts.from_config(config), config.max_depth,
                        config.remat_replay and torch.is_grad_enabled())


def trace_fused_grad(o, d, packet, config, seed: int = 0, sample: int = 0, urand=None,
                     forward=None):
    """The replay route's differentiable trace → linear color (R, 3)
    (`path_replay.py:364-394`), for dense-class packets: the recording
    kernel (`megakernel.trace_fused_sel`) traces the rays without a graph
    and records the selections; the unified table's winner rows are
    gathered (`gather_rows`) and replayed by `replay_kernel.replay_core`,
    whose colour is the primal. Gradients reach ``o``, ``d`` and the
    packet's float leaves through the table. ``seed``, ``sample``,
    ``urand``: the draws, as for `fused_grad.trace_grad`; ``forward``: the
    packet packed by `fused_grad.prepare_forward` (kind "dense"), once for
    every sample of a step."""
    from ptre_tpu_torch.ops.cuda import fused_grad

    if forward is None:
        forward = fused_grad.prepare_forward(packet, "dense")
    consts = mk.TraceConsts.from_config(config)
    B = config.max_depth
    with torch.no_grad():
        _, sel = mk.trace_fused_sel(o.detach().contiguous(), d.detach().contiguous(),
                                    forward.scene, consts, B, seed, sample, urand)
    table, T, sky6 = build_table(packet)
    return rpk.replay_core(o, d, gather_rows(table, sel), sel, sky6, T, consts, B,
                           seed, sample, urand)
