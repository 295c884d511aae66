"""Faults planted in the program under the dual cell's timed path, with
`faults.py`'s contract: `plant(loop, fault)` returns (name in
`benchmark.program_dual`, replacement). Each wraps the step that
``make_dual_train_step`` makes:

* ``unchanged``: every call returns the first call's result again;
* ``half``: the raster image's lower half is the clear colour (the path
  tracer's half-samples fault does nothing at spp 1);
* ``altered``: one entry of the ``transforms`` gradient moved by the leaf's
  norm.

`calibrate_dual.py` reads them on the card at the cell's own size, where
the cell's limits are held against them."""

from __future__ import annotations

import contextlib

import torch

from benchmark.faults import _stale

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _lower_half_cleared(rasterizer):
    """The rasterizer's window rows from the middle of the image down drawn
    as the clear colour, while the context lasts."""
    good = rasterizer.raster_rows

    def half(packet, cam, config, y0, rows, *a, stride=1, **kw):
        img = good(packet, cam, config, y0, rows, *a, stride=stride, **kw)
        ys = float(y0) + float(stride) * torch.arange(rows, device=img.device)
        clear = torch.tensor(config.clear_color, dtype=img.dtype).to(img.device)
        return torch.where((ys >= config.height // 2)[:, None, None], clear, img)

    rasterizer.raster_rows = half
    try:
        yield
    finally:
        rasterizer.raster_rows = good


def _half(make):
    from benchmark import program_dual

    def factory(*a, **kw):
        step = make(*a, **kw)

        def wrapped(*args, **kws):
            with _lower_half_cleared(program_dual.rasterizer):
                return step(*args, **kws)
        return wrapped
    return factory


def _altered(make):
    def factory(*a, **kw):
        step = make(*a, **kw)

        def wrapped(*args, **kws):
            loss, grads = step(*args, **kws)
            g = grads["transforms"].clone()
            g.view(-1)[0] += g.norm() + 1e-3
            return loss, {**grads, "transforms": g}
        return wrapped
    return factory


def _unchanged(make):
    return lambda *a, **kw: _stale(make(*a, **kw))


_PLANTS = {"dual": {"unchanged": _unchanged, "half": _half, "altered": _altered}}


def plant(loop: str, fault: str):
    """(attribute of `benchmark.program_dual`, faulty replacement of it)."""
    from benchmark import program_dual

    return "make_dual_train_step", _PLANTS[loop][fault](program_dual.make_dual_train_step)
