"""The reference of the dual pipeline (BASELINE configuration 5): one
differentiable step through the path tracer and the SoftRas rasterizer, both
drawing the same scene from the same camera, against one target.

The loss is mean((I_pt - target)^2) + raster_weight * mean((I_raster -
target)^2) over the (H, W, 3) image, and the step returns it with the
gradients of the ten float leaves of `scene.Scene.params`.

* The path-traced half is the sharded route's sample, in a world of one:
  the step's key folded by the rank id (0) and by the sample; the pixel
  jitter is ``uniform(fold(key_s, 0x9E37), (H*W, 2), -0.5, 0.5)`` of
  threefry2x32 (JAX's partitionable bits, vectorised here: element i of the
  flat (H*W, 2) array hashes counter (i >> 32, i & 0xffffffff) and xors the
  two words); bounce b of ray r draws Philox pair 1 + b under the seed
  ``randint(fold(key_s, 0x5EED), (), 0, 2**31 - 1)`` with sample index 0.
  The trace is `trace.Tracer`'s; each sample is clamped to [0, 1], its
  non-finite values set to 0 (the sharded route's samples, under the
  program's default ``clamp_samples``), and the image is their mean.
* The raster half is SoftRas (Liu et al., ICCV 2019) as the program's
  rasterizer documents it (`rasterizer.py`, `_raster_tile(soft=True)`):
  every model is drawn as triangles with its own transform (an analytic
  sphere scaled by its radius and moved to its centre); per supersample,
  coverage sigmoid(signed edge distance / sigma) where the perspective depth
  lies in [0, 1]; a softmax of -depth / 0.01 over the pairs whose coverage
  exceeds 1e-6; the background max(1 - sum of weights, 0) times the clear
  colour; ambient (strength x clear colour) plus directional diffuse times
  the albedo, from the perspective-correct interpolated world normal;
  back faces (clockwise in y-down screen space is the front) and triangles
  with a corner at w <= 0 dropped; a box resolve of ss x ss samples.

Computed in blocks of ``block_rows`` pixel rows, each block's part of the
loss back-propagated on its own. A raster block takes only the pairs whose
sample lies inside the triangle's own screen box grown by 14 sigma: past it
the sample is more than 14 sigma outside the triangle, its coverage below
sigmoid(-14) < 1e-6, and by the formula's own threshold the pair adds
nothing, so the cut is exact.

Departures: the softmax's maximum is taken detached (the softmax does not
depend on it, so neither value nor gradient moves); the edge distance and
its projection parameter carry the program's 1e-12 guards, the normalised
normal a 1e-20 guard, and a zero area or a zero perspective denominator is
divided as 1, as the program divides them; a sample with no pair above the threshold
shows the clear colour, as the program's online softmax does (the one-shot
form spreads a uniform softmax over every triangle there, ~1e-6 at most).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import gradsafe as gs
from benchmark.reference import meshes, rng
from benchmark.reference.api import consts_of
from benchmark.reference.scene import Scene, camera_inverses, primary_rays, walk, world_triangles
from benchmark.reference.trace import Tracer, clamp_sample, gather

#: coverage at or below which a pair adds nothing
COV_MIN = float(np.float32(1e-6))
#: a triangle's box grows by this many sigmas: sigmoid(-14) < COV_MIN
GROW_SIGMAS = 14.0
#: depth softmax 1 / temperature
INV_TAU = 100.0
_EPS_D = float(np.float32(1e-12))
_EPS_N = float(np.float32(1e-20))
#: pairs a raster pass takes at once (its temporaries scale with it)
PAIRS_PER_PASS = 1 << 22


# ---- the raster view of the scene ------------------------------------------------------------


@dataclasses.dataclass
class RasterScene:
    """Every model as triangles, in the walk's order: object-space corners
    and normals, and the row of `table` that places each: a triangle
    model's row of ``transforms``, past them one row a sphere model."""

    tri_obj: torch.Tensor  # (T, 6, 3)
    tri_dc: torch.Tensor  # (T,) row of table()
    n_transforms: int

    @classmethod
    def from_config(cls, config: dict, device) -> "RasterScene":
        arrays = {name: meshes.build(spec) for name, spec in config["meshes"].items()}
        n_transforms = max(sum(config["meshes"][m["mesh"]]["type"] != "spheres"
                               for m in config["models"]), 1)
        tris, dcs = [], []
        n_tri = n_sph = 0
        for mdl in walk(config):
            pos, nrm, idx = arrays[mdl["mesh"]]
            if config["meshes"][mdl["mesh"]]["type"] == "spheres":
                row, n_sph = n_transforms + n_sph, n_sph + 1
            else:
                row, n_tri = n_tri, n_tri + 1
            idx = idx.reshape(-1, 3).astype(np.int64)
            tris.append(np.stack([pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]],
                                  nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]], axis=1))
            dcs.append(np.full(idx.shape[0], row))
        return cls(tri_obj=torch.as_tensor(np.concatenate(tris), dtype=torch.float32,
                                           device=device),
                   tri_dc=torch.as_tensor(np.concatenate(dcs), device=device),
                   n_transforms=n_transforms)

    def table(self, params):
        """(n_transforms + spheres, 4, 4): ``transforms`` (the path tracer's
        table, `n_transforms` rows, whose padding row is unused where there
        is no triangle model), then scale(radius) @ translate(centre) of
        each sphere."""
        c, r = params["sph_center"], params["sph_radius"]
        zero, one = torch.zeros_like(r), torch.ones_like(r)
        sph = torch.stack([torch.stack([r, zero, zero, zero], -1),
                           torch.stack([zero, r, zero, zero], -1),
                           torch.stack([zero, zero, r, zero], -1),
                           torch.cat([c, one[:, None]], -1)], dim=1)
        return torch.cat([params["transforms"], sph])


def camera_matrices(position, forward, fov_degrees, width: int, height: int, znear: float,
                    zfar: float):
    """(view, proj) of the camera (row vectors), differentiable in its
    leaves: the matrices `scene.camera_inverses` inverts."""
    def normalize(v):
        return v / torch.sqrt(torch.sum(v * v))

    def cross(a, b):
        return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])

    fwd = normalize((position + forward) - position)
    zero, one = torch.zeros_like(fwd[0]), torch.ones_like(fwd[0])
    right = cross(torch.stack([zero, one, zero]), fwd)
    up = cross(fwd, right)
    view = torch.stack([
        torch.stack([right[0], up[0], fwd[0], zero]),
        torch.stack([right[1], up[1], fwd[1], zero]),
        torch.stack([right[2], up[2], fwd[2], zero]),
        torch.stack([-torch.sum(right * position), -torch.sum(up * position),
                     -torch.sum(fwd * position), one])])
    y_scale = 1.0 / torch.tan(fov_degrees * (math.pi / 180.0) * 0.5)
    x_scale = y_scale / (width / height)
    zz = zfar / (zfar - znear)
    proj = torch.stack([
        torch.stack([x_scale, zero, zero, zero]),
        torch.stack([zero, y_scale, zero, zero]),
        torch.stack([zero, zero, zero + zz, one]),
        torch.stack([zero, zero, zero - znear * zfar / (zfar - znear), zero])])
    return view, proj


def screen_triangles(config: dict, rscene: RasterScene, params):
    """The vertex stage: (T, 21) in ``params``' dtype (float32; float64 for
    finite differences), differentiable in ``params`` — supersampled screen
    x (3), y (3), NDC depth (3), clip w (3), unit world normal of each
    corner (9) — and the (T,) kept mask (front-facing, every corner in
    front of the camera)."""
    ss = int(config["raster"]["supersample"])
    W, H = int(config["width"]), int(config["height"])
    cam = config["camera"]
    table = rscene.table(params)
    world = world_triangles(dataclasses.replace(rscene, tri_obj=rscene.tri_obj.to(table.dtype)),
                            table)  # (T, 6, 3)
    pts, nrm = world[:, :3], world[:, 3:]
    view, proj = camera_matrices(params["cam_position"], params["cam_forward"],
                                 params["cam_fov"], W, H, float(cam["znear"]), float(cam["zfar"]))
    vp = view @ proj
    clip = pts @ vp[:3, :3] + vp[3, :3]
    w = pts @ vp[:3, 3] + vp[3, 3]
    ndc = clip / w[..., None]
    sx = (ndc[..., 0] + 1.0) * 0.5 * (W * ss)
    sy = (1.0 - ndc[..., 1]) * 0.5 * (H * ss)
    n2 = torch.sum(nrm * nrm, dim=-1, keepdim=True)
    nrm = nrm * torch.where(n2 > 0, 1.0 / torch.sqrt(torch.where(n2 > 0, n2, torch.ones_like(n2))),
                            torch.zeros_like(n2))
    with torch.no_grad():
        area = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
                - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0]))
        front = area > 0.0 if config["raster"]["cull_backfaces"] else area.abs() > 0.0
        keep = (torch.amin(w, dim=1) > 0.0) & front
    return torch.cat([sx, sy, ndc[..., 2], w, nrm.reshape(-1, 9)], dim=1), keep


def _pairs(tab, keep, r0: int, r1: int, width_ss: int, grow: float):
    """(sample row, sample column, triangle) of every pair of the sample rows
    [r0, r1) whose sample centre lies in the kept triangle's screen box
    grown by ``grow``; int64, ascending by triangle."""
    t = tab.detach().double()
    dev = tab.device
    lo_x, hi_x = t[:, 0:3].amin(1) - grow, t[:, 0:3].amax(1) + grow
    lo_y, hi_y = t[:, 3:6].amin(1) - grow, t[:, 3:6].amax(1) + grow
    # column c samples x = c + 0.5; the same for rows
    c_lo = torch.ceil(lo_x - 0.5).clamp(min=0)
    c_hi = torch.floor(hi_x - 0.5).clamp(max=width_ss - 1)
    r_lo = torch.ceil(lo_y - 0.5).clamp(min=r0)
    r_hi = torch.floor(hi_y - 0.5).clamp(max=r1 - 1)
    nc = (c_hi - c_lo + 1).clamp(min=0)
    nr = (r_hi - r_lo + 1).clamp(min=0)
    n = torch.where(keep, nc * nr, torch.zeros_like(nc)).long()
    tri = torch.repeat_interleave(torch.arange(tab.shape[0], device=dev), n)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(tri.numel(), device=dev) - first[tri]
    ncl = nc.long()[tri]
    return r_lo.long()[tri] + k // ncl, c_lo.long()[tri] + k % ncl, tri


def _pair_terms(rows, px, py, inv_sigma: float, shading):
    """(coverage, logit, colour (P, 3)) of pairs: ``rows`` (P, 21) of
    `screen_triangles`, samples (px, py)."""
    x0, x1, x2, y0, y1, y2 = rows[:, 0:6].unbind(1)
    z, w, n = rows[:, 6:9], rows[:, 9:12], rows[:, 12:21].reshape(-1, 3, 3)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    inv_area = 1.0 / torch.where(area == 0.0, torch.ones_like(area), area)
    w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
    w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
    w2 = 1.0 - w0 - w1
    depth = w0 * z[:, 0] + w1 * z[:, 1] + w2 * z[:, 2]
    z_ok = ((depth >= 0.0) & (depth <= 1.0)).to(rows.dtype)

    def edge(ax, ay, bx, by):
        ex, ey = bx - ax, by - ay
        t = gs.clip(((px - ax) * ex + (py - ay) * ey) / (ex * ex + ey * ey + _EPS_D), 0.0, 1.0)
        dx, dy = px - (ax + t * ex), py - (ay + t * ey)
        return torch.sqrt(dx * dx + dy * dy + _EPS_D)

    dist = gs.minimum(edge(x0, y0, x1, y1), gs.minimum(edge(x1, y1, x2, y2),
                                                       edge(x2, y2, x0, y0)))
    inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    cov = torch.sigmoid(torch.where(inside, dist, -dist) * inv_sigma) * z_ok
    logit = -gs.clip(depth, 0.0, 1.0) * INV_TAU
    iw = 1.0 / w
    bary = torch.stack([w0, w1, w2], dim=1)
    den = torch.sum(bary * iw, dim=1, keepdim=True)
    ni = torch.einsum("pk,pkc->pc", bary * iw, n) / torch.where(den == 0.0, torch.ones_like(den),
                                                                  den)
    ni = ni / torch.sqrt(torch.sum(ni * ni, dim=1, keepdim=True) + _EPS_N)
    ambient, light, albedo = shading
    diffuse = gs.maximum(-(ni @ light), 0.0)
    return cov, logit, (ambient + diffuse[:, None]) * albedo


def _shading(config: dict, device, dtype):
    r = config["raster"]
    light = torch.tensor(r["light_dir"], dtype=torch.float32)
    light = light / torch.sqrt(torch.sum(light * light))
    clear = torch.tensor(r["clear_color"], dtype=torch.float32)
    return (tuple(x.to(device=device, dtype=dtype) for x in (
        float(np.float32(r["ambient_strength"])) * clear, light,
        torch.tensor(r["albedo"], dtype=torch.float32))), clear.to(device=device, dtype=dtype))


def soft_rows(config: dict, tab, keep, y0: int, rows: int, dtype=torch.float32):
    """SoftRas of pixel rows [y0, y0 + rows): (rows, W, 3) in ``tab``'s
    dtype, resolved, differentiable in ``tab`` (`screen_triangles`);
    ``dtype`` is the precision of the pairs' arithmetic."""
    r = config["raster"]
    ss, W = int(r["supersample"]), int(config["width"])
    sigma = float(r["sigma"])
    dev = tab.device
    shading, clear = _shading(config, dev, dtype)
    r0, r1 = y0 * ss, (y0 + rows) * ss
    ws = W * ss
    n_s = (r1 - r0) * ws
    sr, sc, tri = _pairs(tab, keep, r0, r1, ws, GROW_SIGMAS * sigma)
    # the pairs above the coverage threshold, found without a graph
    inc = []
    with torch.no_grad():
        for a in range(0, tri.numel(), PAIRS_PER_PASS):
            cov, _, _ = _pair_terms(tab[tri[a:a + PAIRS_PER_PASS]].to(dtype),
                                    (sc[a:a + PAIRS_PER_PASS] + 0.5).to(dtype),
                                    (sr[a:a + PAIRS_PER_PASS] + 0.5).to(dtype), 1.0 / sigma,
                                    shading)
            inc.append(cov > COV_MIN)
    if inc:
        keep_pairs = torch.cat(inc).nonzero()[:, 0]
        sr, sc, tri = sr[keep_pairs], sc[keep_pairs], tri[keep_pairs]
    cov, logit, colour = _pair_terms(gather(tab, tri).to(dtype), (sc + 0.5).to(dtype),
                                     (sr + 0.5).to(dtype), 1.0 / sigma, shading)
    s = (sr - r0) * ws + sc
    with torch.no_grad():
        m = torch.full((n_s,), -math.inf, dtype=dtype, device=dev)
        m.scatter_reduce_(0, s, logit, reduce="amax")
    e = torch.exp(logit - m[s])
    ce = cov * e
    den = torch.zeros(n_s, dtype=dtype, device=dev).index_add(0, s, e)
    wsum = torch.zeros(n_s, dtype=dtype, device=dev).index_add(0, s, ce)
    num = torch.zeros((n_s, 3), dtype=dtype, device=dev).index_add(0, s, ce[:, None] * colour)
    lit = den > 0
    inv = torch.where(lit, 1.0 / torch.where(lit, den, torch.ones_like(den)),
                      torch.zeros_like(den))
    bg = gs.maximum(1.0 - wsum * inv, 0.0)
    img = num * inv[:, None] + bg[:, None] * clear
    return img.to(tab.dtype).reshape(rows, ss, W, ss, 3).mean(dim=(1, 3))


def soft_image(config: dict, params, device, dtype=torch.float32, block_rows: int = 128):
    """The (H, W, 3) SoftRas image of the configuration's scene under
    ``params`` (`scene.Scene.params`), without a graph."""
    rscene = RasterScene.from_config(config, device)
    H = int(config["height"])
    with torch.no_grad():
        tab, keep = screen_triangles(config, rscene, params)
        return torch.cat([soft_rows(config, tab, keep, y, min(block_rows, H - y), dtype)
                          for y in range(0, H, block_rows)])


# ---- the path-traced half's draws ------------------------------------------------------------


def sample_key(key, sample: int):
    """The key of a sample of the sharded route, rank 0 of a world of one."""
    return rng.fold(key, 0, sample)


def fused_seed(key) -> int:
    """``randint(fold(key, 0x5EED), (), 0, 2**31 - 1)``."""
    return rng.uint_scalar(rng.fold(key, 0x5EED), 2**31 - 2)


def pixel_jitter(key, pixels):
    """(jx, jy) of ``pixels`` (int64): ``uniform(fold(key, 0x9E37), (N, 2),
    -0.5, 0.5)`` over the whole image, its elements 2p and 2p + 1."""
    k = rng.fold(key, 0x9E37)
    out = []
    for c in range(2):
        idx = 2 * pixels + c
        b0, b1 = rng.threefry2x32(k[0], k[1], idx >> 32, idx & rng.MASK)
        mant = ((b0 ^ b1) >> 9) | 0x3F800000
        u = mant.to(torch.int32).view(torch.float32) - 1.0
        out.append(torch.clamp((u.double() * 1.0 + -0.5).float(), min=-0.5))
    return out


# ---- the step ----------------------------------------------------------------------------------


def dual_step(config: dict, scene: Scene, target, key, spp: int, dtype=torch.float32,
              block_rows: int = 128):
    """(loss, gradients by the keys of `Scene.params`) of the dual loss
    against ``target`` (H*W, 3), the path-traced half under ``key`` (a
    threefry key, a pair of words) and ``spp`` samples; ``dtype`` is the
    precision of both halves' arithmetic (the camera's rays and the vertex
    stage are float32 either way)."""
    H, W = scene.height, scene.width
    dev = scene.device
    weight = float(config["raster"]["raster_weight"])
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params.items()}
    world = world_triangles(scene, leaves["transforms"])
    inverses = camera_inverses(leaves["cam_position"], leaves["cam_forward"],
                               leaves["cam_fov"], W, H, scene.znear, scene.zfar)
    tab, keep = screen_triangles(config, RasterScene.from_config(config, dev), leaves)
    world_leaf = world.detach().to(dtype).requires_grad_(True)
    inv_leaves = [m.detach().requires_grad_(True) for m in inverses]
    tab_leaf = tab.detach().requires_grad_(True)
    keys = [sample_key(key, s) for s in range(spp)]
    seeds = [fused_seed(k) for k in keys]
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    n_values = H * W * 3
    for y0 in range(0, H, block_rows):
        rows = min(block_rows, H - y0)
        pixels = torch.arange(y0 * W, (y0 + rows) * W, device=dev)
        P = pixels.numel()
        px, py = (pixels % W).float().repeat(spp), (pixels // W).float().repeat(spp)
        tracer = Tracer(scene, world_leaf, leaves, consts_of(config), int(config["max_depth"]),
                        dtype)
        jit = [pixel_jitter(k, pixels) for k in keys]
        o, d = primary_rays(inv_leaves, W, H, px, py, torch.cat([j[0] for j in jit]),
                            torch.cat([j[1] for j in jit]))

        def uniforms(b):
            u = [rng.pair(s, 0, pixels, 1 + b) for s in seeds]
            return torch.cat([a for a, _ in u]), torch.cat([c for _, c in u])

        cols = clamp_sample(tracer.colour(o, d, uniforms)).reshape(spp, P, 3)
        acc = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        for s in range(spp):  # the program's order of adds
            acc = acc + cols[s]
        t = target[pixels]
        rz = soft_rows(config, tab_leaf, keep, y0, rows, dtype).reshape(P, 3)
        part = (torch.sum((acc / spp - t) ** 2) + weight * torch.sum((rz - t) ** 2)) / n_values
        part.backward()
        loss += part.detach().double()
    outs = [world, *inverses, tab]
    ins = [world_leaf, *inv_leaves, tab_leaf]
    torch.autograd.backward(outs, [torch.zeros_like(m) if leaf.grad is None
                                   else leaf.grad.to(m.dtype) for m, leaf in zip(outs, ins)])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach()
             for k, v in leaves.items()}
    return float(loss), grads

