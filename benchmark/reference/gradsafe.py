"""Gradient conventions of the reference: the values of the plain formulas,
with the gradients the program is documented to take for them.

* ``clip``, ``maximum``, ``minimum``: at a tie half the gradient goes to each
  side (the default roughness 1.0 sits on clip's upper bound);
* ``1 / det``, ``sqrt(delta)`` and ``1 / max(cos_b, 1e-6)``: the value of the
  formula, the gradient of a floored form (``stable + (value -
  stable).detach()``), floors tau_det |e1||e2|, tau_delta r^2 and tau_cos;
* ``cos_weight / pdf`` is the constant pi in every branch: no gradient.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


TAU_COS = _f32(0.05)
TAU_DET = _f32(1e-3)
TAU_DELTA = _f32(1e-4)
_TINY_SQ = _f32(1e-24)


def _straight_through(value, stable):
    return stable + (value - stable).detach()


def maximum(x, y):
    return torch.maximum(x, y if torch.is_tensor(y) else torch.full_like(x, y))


def minimum(x, y):
    return torch.minimum(x, y if torch.is_tensor(y) else torch.full_like(x, y))


def clip(x, lo: float, hi: float):
    return minimum(maximum(x, lo), hi)


def cosine_ratio(cosw, pdf):
    return (cosw / pdf).detach()


def stable_recip_cos(cos_b):
    return _straight_through(1.0 / maximum(cos_b, _f32(1e-6)), 1.0 / maximum(cos_b, TAU_COS))


def stable_inv_det(det, e1_sq, e2_sq):
    floor = (TAU_DET * torch.sqrt(maximum(e1_sq * e2_sq, _TINY_SQ))).detach()
    one = torch.ones_like(det)
    sign = torch.where(det < 0.0, -one, one)
    value = 1.0 / torch.where(det == 0.0, one, det)
    return _straight_through(value, sign / torch.maximum(det.abs(), floor))


def stable_sqrt_delta(delta, radius):
    floor = (TAU_DELTA * (radius * radius) + _TINY_SQ).detach()
    pos = delta > 0.0
    posf = pos.to(delta.dtype)
    value = torch.sqrt(torch.where(pos, delta, torch.ones_like(delta))) * posf
    return _straight_through(value, torch.sqrt(torch.maximum(delta, floor)) * posf)


def guarded_sqrt(x):
    """sqrt(x) where x > 0, else 0, with a finite gradient everywhere."""
    pos = x > 0.0
    return torch.sqrt(torch.where(pos, x, torch.ones_like(x))) * pos


def unit_xy(wx, wy, length):
    """(cos, sin) of the azimuth of (wx, wy); (1, 0) at the pole."""
    safe = torch.where(length > 0, length, torch.ones_like(length))
    far = length > 1e-12
    return (torch.where(far, wx / safe, torch.ones_like(wx)),
            torch.where(far, wy / safe, torch.zeros_like(wy)))
