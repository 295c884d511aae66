"""Differentiable BSDF evaluation of the staged route.

PyTorch port of `ptre_tpu/ops/materials.py` (`material.{h,cu}`, `onb.h`),
semantics unchanged:

  * Oren–Nayar (`material.cu:5-43`): a cosine-weighted direction in the ONB
    of the normal; pdf = n·wi / pi with the degenerate-pdf fallback (pdf <
    pdf_eps casts along the normal with pdf 1/pi); cos weight max(0, n·wi);
    the A/B term with WORLD-frame azimuths in planar-projection form
    (gradient-safe at the poles); sigma clipped to [0, 1]; attenuation =
    albedo * coeff / pi;
  * emissive (`material.cu:50-62`): terminal, attenuation = strength *
    colour, pdf = cos weight = 1.

`scatter` takes its two uniforms per ray as tensors, so every draw source
(the threefry twin, the port's Philox, given ``urand``) feeds it the same
way. ``clip``, ``maximum`` and ``minimum`` are `gradsafe`'s: JAX gives half
the gradient at a tie, and the default roughness 1.0 sits on clip's bound.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ptre_tpu_torch.ops import gradsafe, rng
from ptre_tpu_torch.ops import vecmat as vm

KIND_OREN_NAYAR = 0
KIND_EMISSIVE = 1


@dataclasses.dataclass
class ScatterRecord:
    """Vectorised scatter record (reference `material.h:7-12`) + next ray."""

    attenuation: torch.Tensor  # (R, 3)
    pdf: torch.Tensor  # (R,)
    cos_weight: torch.Tensor  # (R,)
    next_origin: torch.Tensor  # (R, 3)
    next_dir: torch.Tensor  # (R, 3)
    terminated: torch.Tensor  # (R,) bool: emissive ends the path


def _guarded_sqrt(x):
    """sqrt(x) where x > 0, else 0, with a finite gradient everywhere."""
    pos = x > 0.0
    return torch.sqrt(torch.where(pos, x, torch.ones_like(x))) * pos


def _unit_xy(wx, wy, length):
    """(cos, sin) of the xy projection's azimuth; (1, 0) at the pole."""
    safe = torch.where(length > 0, length, torch.ones_like(length))
    far = length > 1e-12
    return (torch.where(far, wx / safe, torch.ones_like(wx)),
            torch.where(far, wy / safe, torch.zeros_like(wy)))


def scatter(u1, u2, d_in, hit_p, hit_n, mat_kind, mat_albedo, mat_param,
            shadow_eps: float = 1e-4, pdf_eps: float = 1e-5) -> ScatterRecord:
    """Scatter every ray at its hit (`materials.py:49-146`).

    Args:
      u1, u2: (R,) uniforms in [0, 1), the cosine-weighted sample's draws.
      d_in: (R, 3) incoming unit directions.
      hit_p, hit_n: (R, 3) hit position and unit front-facing normal.
      mat_kind: (R,) material kinds; mat_albedo (R, 3); mat_param (R,)
        roughness or strength.
    """
    wo = -d_in
    basis = rng.onb_from_normal(hit_n)  # rows u, v, w
    local = rng.cosine_from_uniforms(u1, u2)
    wi = (local[:, 0:1] * basis[:, 0] + local[:, 1:2] * basis[:, 1]
          + local[:, 2:3] * basis[:, 2])
    pdf = vm.dot(hit_n, wi) / math.pi
    degen = pdf < pdf_eps
    wi = torch.where(degen[:, None], hit_n, wi)
    pdf = torch.where(degen, torch.full_like(pdf, 1.0 / math.pi), pdf)
    cos_weight = gradsafe.maximum(vm.dot(hit_n, wi), 0.0)

    sigma = gradsafe.clip(mat_param, 0.0, 1.0)
    sigma2 = sigma * sigma
    A = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    li = _guarded_sqrt(wi[:, 0] ** 2 + wi[:, 1] ** 2)
    lo = _guarded_sqrt(wo[:, 0] ** 2 + wo[:, 1] ** 2)
    ci, si = _unit_xy(wi[:, 0], wi[:, 1], li)
    co, so = _unit_xy(wo[:, 0], wo[:, 1], lo)
    cos_dphi = ci * co + si * so
    cos_to = gradsafe.clip(vm.dot(wo, hit_n), 0.0, 1.0)
    cos_ti = gradsafe.clip(cos_weight, 0.0, 1.0)
    cos_a = gradsafe.minimum(cos_ti, cos_to)
    cos_b = gradsafe.maximum(cos_ti, cos_to)
    sin_a = _guarded_sqrt(gradsafe.maximum(1.0 - cos_a * cos_a, 0.0))
    tan_b = (_guarded_sqrt(gradsafe.maximum(1.0 - cos_b * cos_b, 0.0))
             * gradsafe.stable_recip_cos(cos_b))
    coeff = A + B * cos_dphi * sin_a * tan_b
    on_attenuation = mat_albedo * (coeff / math.pi)[:, None]

    em_attenuation = mat_param[:, None] * mat_albedo
    is_emissive = mat_kind == KIND_EMISSIVE
    one = torch.ones_like(pdf)
    return ScatterRecord(
        attenuation=torch.where(is_emissive[:, None], em_attenuation, on_attenuation),
        pdf=torch.where(is_emissive, one, pdf),
        cos_weight=torch.where(is_emissive, one, cos_weight),
        next_origin=hit_p + shadow_eps * hit_n,
        next_dir=wi,
        terminated=is_emissive,
    )


def emitted(mat_kind, mat_albedo, mat_param):
    """Emitted radiance per material row (`material.cu:59-62`): strength *
    colour for EMISSIVE, zero otherwise."""
    e = mat_param[..., None] * mat_albedo
    return torch.where((mat_kind == KIND_EMISSIVE)[..., None], e, torch.zeros_like(e))


def sky_attenuation(d, sky_bottom, sky_top):
    """Miss shading: the vertical gradient (`path_tracer.cu:307-316`),
    a = (dir.y + 1) / 2, (1 - a) * bottom + a * top."""
    a = (d[:, 1] + 1.0) * 0.5
    return (1.0 - a)[:, None] * sky_bottom + a[:, None] * sky_top
