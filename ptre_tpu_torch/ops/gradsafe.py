"""Forward-exact, gradient-stabilised forms for the replay chain's
near-singular terms.

PyTorch port of `ptre_tpu/ops/gradsafe.py`. Each form keeps the VALUE of the
reference formula and routes the GRADIENT through a tau-floored stable
formula, with the straight-through pattern ``stable + (forward -
stable).detach()``. The three amplifiers it tames:

  * ``1 / det``               (Moller-Trumbore, edge-on triangles)
  * ``1 / (2 sqrt(delta))``   (sphere root, silhouette rays)
  * ``tan_b = sin_b / max(cos_b, 1e-6)``  (Oren-Nayar, grazing incidence)

`clip`, `maximum` and `minimum` give the gradient JAX gives at a tie: half to
each side. ``torch.clamp`` gives the whole gradient to the input at a bound,
so a port written with it would get twice the reference's d(mat_param) for
every default Oren-Nayar material, whose roughness sits at clip's upper
bound 1.0.

`remat` is the port's counterpart of ``jax.checkpoint(..., policy=
remat_policy)``: a region whose residuals are recomputed in the backward
instead of kept. The reference pins its branch decisions (``remat_pin``) so
that a recompute compiled in another fusion context cannot flip them; here
the recompute runs the same operations on the same inputs, and the one
decision that is not a deterministic elementwise function of them, a
bounce's sweep winners, is computed outside the region and passed in
(`ops/integrator.trace_staged`).

Every scalar constant is a float32 value held in a Python float: float32
tensors see JAX's weakly typed float32 constants, and float64 tensors (the
adjoint checks) see the same numbers as the hand-written CUDA adjoint.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


#: gradient-path floor for the Oren-Nayar 1/cos_b (cos of ~87 deg)
TAU_COS = f32(0.05)
#: relative gradient-path floor for |det| (vs |e1||e2|, |d| = 1)
TAU_DET = f32(1e-3)
#: relative gradient-path floor for the sphere discriminant (vs r^2)
TAU_DELTA = f32(1e-4)
_TINY_SQ = f32(1e-24)


def value_with_stable_grad(forward, stable):
    """VALUE of ``forward``, GRADIENT of ``stable`` (straight-through)."""
    return stable + (forward - stable).detach()


def maximum(x, y):
    """Elementwise max; a tie sends half the gradient to each side (JAX's
    rule, and torch.maximum's). ``y`` may be a Python float."""
    if not torch.is_tensor(y):
        y = torch.full_like(x, y)
    return torch.maximum(x, y)


def minimum(x, y):
    """Elementwise min with the same tie rule as `maximum`."""
    if not torch.is_tensor(y):
        y = torch.full_like(x, y)
    return torch.minimum(x, y)


def clip(x, lo: float, hi: float):
    """``jnp.clip``: min(max(x, lo), hi), gradient 0.5 at either bound."""
    return minimum(maximum(x, lo), hi)


def cosine_ratio(cosw, pdf):
    """``cos_weight / pdf`` with its exact analytic gradient, zero: the
    ratio is the constant pi in every branch (see the reference)."""
    return (cosw / pdf).detach()


def stable_recip_cos(cos_b):
    """1 / max(cos_b, 1e-6) in value; gradient floored at TAU_COS."""
    fwd = 1.0 / maximum(cos_b, f32(1e-6))
    stable = 1.0 / maximum(cos_b, TAU_COS)
    return value_with_stable_grad(fwd, stable)


def stable_inv_det(det, e1_sq, e2_sq):
    """1 / det (det == 0 -> 1/1) in value; gradient floored at
    TAU_DET * |e1| * |e2| (the largest |det| for a unit direction)."""
    floor = (TAU_DET * torch.sqrt(maximum(e1_sq * e2_sq, _TINY_SQ))).detach()
    one = torch.ones_like(det)
    sign = torch.where(det < 0.0, -one, one)
    fwd = 1.0 / torch.where(det == 0.0, one, det)
    stable = sign / torch.maximum(torch.abs(det), floor)
    return value_with_stable_grad(fwd, stable)


def stable_sqrt_delta(delta, radius):
    """Double-where-guarded sqrt(delta) in value; gradient floored at
    TAU_DELTA * r^2 (zero gradient inside the silhouette band)."""
    floor = (TAU_DELTA * (radius * radius) + _TINY_SQ).detach()
    pos = delta > 0.0
    posf = pos.to(delta.dtype)
    fwd = torch.sqrt(torch.where(pos, delta, torch.ones_like(delta))) * posf
    stable = torch.sqrt(torch.maximum(delta, floor)) * posf
    return value_with_stable_grad(fwd, stable)


def remat(fn, *args):
    """``fn(*args)`` with its residuals recomputed in the backward, not kept:
    a non-reentrant checkpoint, so only the saved tensors' metadata is
    checked against the recompute (the callers' tests compare values). The
    device RNG state is not stashed: no region the port checkpoints draws
    from torch's generators (its draws are Philox keyed by (seed, ray,
    sample, draw), threefry keyed by Python ints, or uniforms passed in), and
    stashing it would read every device's generator state at each call."""
    return _checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
