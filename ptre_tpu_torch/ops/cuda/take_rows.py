"""``table[idx]`` whose backward sums each row's duplicates in parallel.

The kernels' tables are built by differentiable row gathers: the drawcall
transforms and materials expanded to a row each of 16,256 triangle rows
(2 drawcalls, 16,244 rows copies of one), the Morton permutation of the
unified table, the raster table's. PyTorch's backward of ``tensor[idx]``,
``index_put_(accumulate=True)``, sorts the indices, then one thread adds
each distinct index's duplicates one after another: about 3 ms a gather on
an H100 at those shapes, where reading the cotangent once takes 0.3 us.

`take_rows` is the same gather. Its forward is ``index_select``, the same
values bit for bit. Its backward (`rows_backward`) on CUDA tensors runs
`csrc/take_rows_kernel.cu`, which sums every cell in float64 and rounds once
to float32, the rule of the repo's duplicate-heavy gathers
(`intersect.gather_rows`), in one of two instantiations chosen from
N * F alone (`instantiation`, against the cap the unit exports):

  * ``"shared"`` (N * F up to the cap): per-warp float64 slices in
    shared memory, partials summed in a fixed order; d(table) is the same
    bits on every run. Two launches (counted in ``launches_shared``).
  * ``"global"``: float64 atomics into a zeroed buffer, then a cast; exact,
    and the same on every run, where no row is named twice (a permutation).
    Three launches, the zeroing included (counted in ``launches_global``).

On CPU tensors the backward is the one autograd runs for ``table[idx]``
(``index_put_`` with accumulate into zeros): CPU gradients are the plain
gather's. The backward runs inside the span
``ptre.rows.backward`` under a profiler.

The port's other differentiable row gather, `intersect.gather_rows` (the
staged and replay routes' ray gathers: ``embedding``, a float64 backward
on the CPU too, a pad row dropped), is to move onto this op (ROADMAP A17
lists what that takes).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.utils.metrics import span

#: backward calls that ran the shared instantiation in this process
launches_shared = 0
#: backward calls that ran the global instantiation in this process
launches_global = 0


def instantiation(n_rows: int, n_cols: int, max_cells: int) -> str:
    """The backward kernel's instantiation for a (n_rows, n_cols) table:
    ``"shared"`` up to ``max_cells`` cells, the cap the kernel unit was
    built with (``ptre_take_rows_max_cells``), else ``"global"``."""
    return "shared" if n_rows * n_cols <= max_cells else "global"


def rows_backward(g, idx, n_rows: int):
    """d(table) (n_rows, F) of the cotangent ``g`` (M, F) of
    ``table[idx]``, ``idx`` (M,) int64 in [0, n_rows). CUDA tensors launch
    the kernel of `instantiation` (float64 sums, one rounding); CPU tensors
    run ``index_put_`` with accumulate, as autograd does for ``table[idx]``;
    anything else raises."""
    global launches_shared, launches_global
    F = g.shape[1]
    if g.device.type == "cpu":
        return g.new_zeros((n_rows, F)).index_put_((idx,), g, accumulate=True)
    if g.device.type != "cuda":
        raise RendererError(f"take_rows runs on cuda or cpu, not {g.device}")
    if g.dtype != torch.float32:
        raise RendererError(f"take_rows' backward kernel takes float32 tables, got {g.dtype}")
    M = g.shape[0]
    if M == 0 or n_rows == 0 or F == 0:
        return g.new_zeros((n_rows, F))
    out = torch.empty((n_rows, F), dtype=torch.float32, device=g.device)
    g = g.contiguous()
    lib = build.load_library()
    kind = instantiation(n_rows, F, lib.ptre_take_rows_max_cells())
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if kind == "shared":
            part = torch.empty((lib.ptre_take_rows_blocks(M), n_rows * F), dtype=torch.float64,
                               device=g.device)
            rc = lib.ptre_take_rows_shared(g.data_ptr(), idx.data_ptr(), M, n_rows, F,
                                           part.data_ptr(), out.data_ptr(), stream)
        else:
            acc = torch.empty((n_rows, F), dtype=torch.float64, device=g.device)
            rc = lib.ptre_take_rows_global(g.data_ptr(), idx.data_ptr(), M, n_rows, F,
                                           acc.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RendererError(
            f"row-gather backward launch failed: {lib.ptre_cuda_error_string(rc).decode()}")
    if kind == "shared":
        launches_shared += 1
    else:
        launches_global += 1
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        flat = idx.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.table_shape = table.shape
        return table.index_select(0, flat).reshape(*idx.shape, *table.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        shape = ctx.table_shape
        with span("ptre.rows.backward"):
            g = grad.reshape(flat.shape[0], math.prod(shape[1:]))
            dtable = rows_backward(g, flat, shape[0]).reshape(shape)
        return dtable, None


def take_rows(table, idx):
    """``table[idx]`` of a table of N rows (of any shape, F values each) by
    an integer index of any shape in [0, N): (*idx.shape, *row shape),
    differentiable w.r.t. the table, its backward `rows_backward` on the
    (N, F) view."""
    return _TakeRows.apply(table, idx.long().contiguous())
