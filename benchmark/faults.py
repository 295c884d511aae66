"""Faults planted in the program under a cell's timed path, which the
comparison that decides ``correct`` has to refuse: a step that returns its
state unchanged, half of the batch left out (the mean taken over the rest),
and an answer altered where it is produced. The tests plant them at a tiny
size on the CPU; `calibrate.py --fault` reads them on the card at the cell's
own size, where a training cell's limits are held against them.

`plant(loop, fault)` returns (name in `benchmark.program`, replacement)."""

from __future__ import annotations

import numpy as np

FAULTS = ("unchanged", "half", "altered")


def _stale(fn):
    """Every call returns the first call's result again."""
    first = {}

    def wrapped(*a, **kw):
        if "out" not in first:
            first["out"] = fn(*a, **kw)
        return first["out"]
    return wrapped


def _half_spp(fn):
    """Half the samples, the mean taken over them."""
    def wrapped(*a, spp, **kw):
        return fn(*a, spp=max(1, spp // 2), **kw)
    return wrapped


def _train_altered(fn):
    """One entry of one gradient leaf moved by the leaf's norm."""
    def wrapped(*a, **kw):
        loss, grads = fn(*a, **kw)
        g = grads["mat_albedo"].clone()
        g.view(-1)[0] += g.norm() + 1e-3
        return loss, {**grads, "mat_albedo": g}
    return wrapped


def _render_unchanged(fn):
    """The accumulator comes back as it went in."""
    def wrapped(packet, cam, accum, *a, **kw):
        return accum
    return wrapped


def _render_altered(fn):
    """The first pixel's red moved by 0.5 after every step."""
    def wrapped(*a, **kw):
        accum = fn(*a, **kw)
        accum.linear[0, 0, 0] += 0.5
        return accum
    return wrapped


def _renderer(base, fault: str):
    """A renderer whose frames are faulty: the first non-black frame again
    and again, the lower half black, or the first pixel's red moved by 50."""

    class Faulty(base):
        def draw_frame(self):
            img = super().draw_frame()
            if fault == "unchanged":
                first = self.__dict__.setdefault("_first", [None])
                if first[0] is None and img.any():
                    first[0] = img.copy()
                return img if first[0] is None else first[0].copy()
            img = img.copy()
            if fault == "half":
                img[img.shape[0] // 2:] = 0
            else:
                img[0, 0, 0] = np.uint8((int(img[0, 0, 0]) + 50) % 256)
            return img
    return Faulty


_PLANTS = {
    "train": {"unchanged": ("mse_step", _stale), "half": ("mse_step", _half_spp),
              "altered": ("mse_step", _train_altered)},
    "render": {"unchanged": ("render_step", _render_unchanged),
               "half": ("render_step", _half_spp), "altered": ("render_step", _render_altered)},
    "frames": {f: ("Renderer", lambda base, f=f: _renderer(base, f)) for f in FAULTS},
}


def plant(loop: str, fault: str):
    """(attribute of `benchmark.program`, faulty replacement of it)."""
    from benchmark import program

    name, make = _PLANTS[loop][fault]
    return name, make(getattr(program, name))
