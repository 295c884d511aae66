"""The port's one differentiable row gather, ``table[idx]``, and the rule of
its backward.

Every differentiable row gather of the port goes through `take_rows`: the
kernels' tables (drawcall transforms and materials expanded to a row each,
the Morton and raster permutations), the staged route's closest-hit and
material gathers, the replay route's winner rows. Its forward is
``index_select``, ``table[idx]``'s values bit for bit. ``pad_row`` is
``embedding``'s ``padding_idx``: gathered like any row, its row of
d(table) zero. The replay route names its padded zero row so: the
cotangents of its rays without a winner are then never read by the sorted
segments (a 1080p replay step's gather backward 15.1-15.7 ms of device
time on an H100, against 20.3-20.4 without the pad row).

The backward (`rows_backward`), on every device: each cell of d(table) is
the float64 sum of its cotangents, rounded once to the table's dtype, so
CPU gradients do not depend on the thread count. Why: ``table[idx]``'s
backward adds an index's duplicates one after another (2.7 ms a 16,256-row
gather of 2 rows on an H100), and float32 sums of a hot row's million
one-sign cotangents drift (d(albedo) 1.8e-4 from float64; these sums below
3e-8, chip_smoke.py phase 21). Where it runs follows from the device, the
table's cells N * F and the gathered rows M alone (`instantiation`):

  * CPU, float32 or float64: ``embedding``'s backward on a float64
    cotangent, each row's cotangents added in index order.
  * card, N * F up to the cap of ``csrc/take_rows_kernel.cu``
    (``"shared"``, counted in ``launches_shared``): per-warp float64 slices
    in shared memory summed in a fixed order, the same bits on every run;
    the kernels' small tables, the staged sphere and material gathers.
  * card, past the cap, M <= N (``"global"``, ``launches_global``): float64
    atomics, exact on a permutation (the Morton and raster ones). M <= N
    stands in for "a permutation"; it does not check for one.
  * card, past the cap, M > N (``"segments"``): as on the CPU, by sorted
    segments, one leading slice of the index at a time (which bounds the
    float64 copies); the staged triangle gather, the replay winner rows.

The kernels sum the pad row like any other and its row is zeroed after.
The card takes float32 tables only and raises on any other dtype. The
backward is the span ``ptre.rows.backward`` under a profiler.
"""

from __future__ import annotations

import math

import torch

from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.utils.metrics import span

#: backward calls that ran the shared instantiation in this process
launches_shared = 0
#: backward calls that ran the global instantiation in this process
launches_global = 0


def instantiation(n_rows: int, n_cols: int, n_idx: int, max_cells: int) -> str:
    """The card's implementation of the backward of a (n_rows, n_cols)
    table gathered by ``n_idx`` rows: ``"shared"`` up to ``max_cells``
    cells, the cap the kernel unit was built with
    (``ptre_take_rows_max_cells``); past it ``"global"`` where no more rows
    are gathered than the table has (a stand-in for a permutation, not a
    check for one), else ``"segments"``."""
    if n_rows * n_cols <= max_cells:
        return "shared"
    return "global" if n_idx <= n_rows else "segments"


def _segments(g, idx, n_rows: int, pad_row: int):
    """d(table) by ``embedding``'s backward on a float64 cotangent, one
    leading slice of a multi-dimensional index at a time, rounded once."""

    def part(g, i):
        return torch.ops.aten.embedding_dense_backward(g.to(torch.float64), i, n_rows,
                                                       pad_row, False)

    dtable = (sum(part(g[b], idx[b]) for b in range(idx.shape[0])) if idx.dim() > 1
              else part(g, idx))
    return dtable.to(g.dtype)


def rows_backward(g, idx, n_rows: int, pad_row: int = -1):
    """d(table) (n_rows, F) of the cotangent ``g`` (*idx.shape, F) of
    ``table[idx]``, ``idx`` int64 of any shape in [0, n_rows), row
    ``pad_row`` zero (-1: none). The rule and where it runs are the module
    docstring's; any other device, or a card table that is not float32,
    raises."""
    global launches_shared, launches_global
    if g.device.type == "cpu":
        return _segments(g, idx, n_rows, pad_row)
    if g.device.type != "cuda":
        raise RendererError(f"take_rows runs on cuda or cpu, not {g.device}")
    if g.dtype != torch.float32:
        raise RendererError(f"take_rows' backward kernel takes float32 tables, got {g.dtype}")
    F, M = g.shape[-1], idx.numel()
    if M == 0 or n_rows == 0 or F == 0:
        return g.new_zeros((n_rows, F))
    lib = build.load_library()
    kind = instantiation(n_rows, F, M, lib.ptre_take_rows_max_cells())
    if kind == "segments":
        return _segments(g, idx, n_rows, pad_row)
    out = torch.empty((n_rows, F), dtype=torch.float32, device=g.device)
    g, flat = g.reshape(M, F).contiguous(), idx.reshape(M)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if kind == "shared":
            part = torch.empty((lib.ptre_take_rows_blocks(M), n_rows * F), dtype=torch.float64,
                               device=g.device)
            rc = lib.ptre_take_rows_shared(g.data_ptr(), flat.data_ptr(), M, n_rows, F,
                                           part.data_ptr(), out.data_ptr(), stream)
        else:
            acc = torch.empty((n_rows, F), dtype=torch.float64, device=g.device)
            rc = lib.ptre_take_rows_global(g.data_ptr(), flat.data_ptr(), M, n_rows, F,
                                           acc.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RendererError(
            f"row-gather backward launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    if kind == "shared":
        launches_shared += 1
    else:
        launches_global += 1
    if pad_row >= 0:
        out[pad_row] = 0.0
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, pad_row):
        ctx.save_for_backward(idx)
        ctx.table_shape, ctx.pad_row = table.shape, pad_row
        return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        with span("ptre.rows.backward"):
            g = grad.reshape(*idx.shape, math.prod(shape[1:]))
            dtable = rows_backward(g, idx, shape[0], ctx.pad_row).reshape(shape)
        return dtable, None, None


def take_rows(table, idx, pad_row: int = -1):
    """``table[idx]`` of a table of N rows (of any shape, F values each) by
    an integer index of any shape in [0, N): (*idx.shape, *row shape),
    differentiable w.r.t. the table, its backward `rows_backward` on the
    (N, F) view. ``pad_row`` >= 0 names a row whose d(table) is zero
    (``embedding``'s ``padding_idx``)."""
    return _TakeRows.apply(table, idx.long().contiguous(), pad_row)
