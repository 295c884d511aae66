"""Z-buffered triangle rasterizer (supersampled) and its differentiable
SoftRas form.

PyTorch port of `ptre_tpu/render/rasterizer.py`, the equivalent of the
reference D3D11 pipeline (`IoniqRE/rasterizer.{h,cu}` + both HLSL shaders):
z-buffer LESS test (`rasterizer.cu:77-83`), clockwise-front back-face
culling (`rasterizer.cu:117-124`), perspective-correct normals, ambient 0.2
x sky + directional diffuse with light (0, -1, 0) and red albedo, sky-blue
clear (`renderer_base.cu:30`), and a supersample → box resolve standing in
for 4x MSAA + ResolveSubresource (`rasterizer.cu:31,136-147`). Samples from
a triangle with a corner at w <= 0 are rejected (the reference relies on D3D
clipping).

Two routes compute the same image:

  * the kernels (``backend="auto"``): `ops/cuda/raster_kernel` (hard,
    forward-only) and `ops/cuda/soft_raster` (SoftRas, with its backward as
    a `torch.autograd.Function`). CUDA tensors launch the CUDA kernels for
    every size, window and stride; CPU tensors run their plain versions.
  * the one-shot reference (``backend="oneshot"``, JAX's ``backend="xla"``):
    `_raster_tile` over all (samples x triangles) pairs at once, any device,
    differentiable by autograd. It holds a (samples x T) tensor per
    intermediate: only for small images.

``soft=True`` swaps coverage for a sigmoid of the signed edge distance and
the z test for a softmax in depth, so that silhouettes have gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from ptre_tpu_torch.ops import gradsafe as gs
from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.utils.errors import ConfigError

BACKENDS = ("auto", "oneshot")
_EPS = gs.f32(1e-12)


def transform_vertices(tri_v, tri_n, tri_dc, transforms, view, proj):
    """Vertex stage for (T, 3, 3) triangle corners (vertex_shader.hlsl):
    NDC xyz after the w-divide, clip w, unit world normals."""
    tf = transforms[tri_dc.long()]  # (T, 4, 4)
    nm = vm.normal_matrix(tf)
    world = torch.einsum("tvi,tij->tvj", tri_v, tf[:, :3, :3]) + tf[:, None, 3, :3]
    n_world = vm.normalize(torch.einsum("tvi,tij->tvj", tri_n, nm))
    vp = view @ proj
    clip = torch.einsum("tvi,ij->tvj", world, vp[:3, :3]) + vp[3, :3]
    w = torch.einsum("tvi,i->tv", world, vp[:3, 3]) + vp[3, 3]
    return clip / w[..., None], w, n_world


def shade(normals, config):
    """Pixel stage (pixel_shader.hlsl): ambient + directional diffuse."""
    f32 = torch.float32
    dev = normals.device
    light = vm.normalize(torch.tensor(config.light_dir, dtype=f32)).to(dev)
    ambient = (config.ambient_strength * torch.tensor(config.clear_color, dtype=f32)).to(dev)
    diffuse = gs.maximum(-torch.einsum("...k,k->...", normals, light), 0.0)
    return (ambient + diffuse[..., None]) * torch.tensor(config.albedo, dtype=f32, device=dev)


def _raster_tile(sx, sy, screen, depth01, w, normals, valid, config, soft, sigma):
    """Rasterize all triangles onto one flat batch of samples at once → (P, 3).

    sx, sy: (P,) supersampled sample coordinates; screen (T, 3, 2) screen xy
    per corner; depth01 (T, 3) NDC z; w (T, 3) clip w; normals (T, 3, 3)
    world normals; valid (T,) triangle mask."""
    x0, y0 = screen[:, 0, 0], screen[:, 0, 1]
    x1, y1 = screen[:, 1, 0], screen[:, 1, 1]
    x2, y2 = screen[:, 2, 0], screen[:, 2, 1]

    # signed area: positive = clockwise in y-down screen space = front face
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    keep = valid.bool() & (torch.amin(w, dim=1) > 0.0)
    keep = keep & ((area > 0.0) if config.cull_backfaces else (torch.abs(area) > 0.0))

    # dropped rows can carry NaN/inf from the w-divide: sanitise them
    def san(v, fill=0.0):
        return torch.where(keep, v, fill)

    x0, y0, x1, y1, x2, y2 = map(san, (x0, y0, x1, y1, x2, y2))
    depth01 = torch.where(keep[:, None], depth01, 0.5)
    w = torch.where(keep[:, None], w, 1.0)
    normals = torch.where(keep[:, None, None], normals, 0.0)
    area = san(area, 1.0)
    inv_area = 1.0 / torch.where(area == 0.0, 1.0, area)

    px = sx[:, None]
    py = sy[:, None]
    w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area[None, :]
    w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area[None, :]
    w2 = 1.0 - w0 - w1
    z = w0 * depth01[None, :, 0] + w1 * depth01[None, :, 1] + w2 * depth01[None, :, 2]
    z_ok = (z >= 0.0) & (z <= 1.0)

    # perspective-correct normal interpolation (hardware attribute interp)
    iw = 1.0 / w
    denom = w0 * iw[None, :, 0] + w1 * iw[None, :, 1] + w2 * iw[None, :, 2]
    n_interp = (w0[..., None] * (normals[:, 0] * iw[:, 0, None])[None]
                + w1[..., None] * (normals[:, 1] * iw[:, 1, None])[None]
                + w2[..., None] * (normals[:, 2] * iw[:, 2, None])[None]) / denom[..., None]
    color = shade(vm.normalize(n_interp), config)  # (P, T, 3)
    clear = torch.tensor(config.clear_color, dtype=torch.float32, device=sx.device)

    if not soft:
        inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        covered = inside & z_ok & keep[None, :]
        best = torch.argmin(torch.where(covered, z, float("inf")), dim=1)  # LESS, first min
        out = torch.take_along_dim(color, best[:, None, None], dim=1)[:, 0, :]
        return torch.where(covered.any(dim=1)[:, None], out, clear)

    # SoftRas: sigmoid coverage on the signed edge distance, softmax in depth
    def edge_dist(ax, ay, bx, by):
        ex, ey = bx - ax, by - ay
        t = ((px - ax[None]) * ex[None] + (py - ay[None]) * ey[None]) / (
            ex * ex + ey * ey + _EPS)[None]
        t = gs.clip(t, 0.0, 1.0)
        dx = px - (ax[None] + t * ex[None])
        dy = py - (ay[None] + t * ey[None])
        return torch.sqrt(dx * dx + dy * dy + _EPS)

    dist = gs.minimum(edge_dist(x0, y0, x1, y1),
                      gs.minimum(edge_dist(x1, y1, x2, y2), edge_dist(x2, y2, x0, y0)))
    inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    signed = torch.where(inside, dist, -dist)
    cov = torch.sigmoid(signed / sigma) * keep[None, :] * z_ok

    logits = -gs.clip(z, 0.0, 1.0) / 0.01  # nearer → larger weight
    weights = cov * torch.softmax(torch.where(cov > 1e-6, logits, -1e9), dim=1)
    bg = gs.maximum(1.0 - torch.sum(weights, dim=1, keepdim=True), 0.0)
    return torch.einsum("pt,ptc->pc", weights, color) + bg * clear


def rasterize(packet, cam, config, soft: bool = False, sigma: float = 0.5,
              row_chunk: int = 0, backend: str = "auto"):
    """Rasterize a ScenePacket built with ``spheres_as_triangles=True`` →
    (H, W, 3) on the packet's device: supersampled render target,
    per-drawcall transforms (`rasterizer.cu:155-169`), box resolve
    (`rasterizer.cu:142`). ``row_chunk`` > 0 bounds the one-shot path's
    (samples x triangles) intermediates to that many supersampled rows."""
    return raster_rows(packet, cam, config, 0.0, config.height, soft=soft, sigma=sigma,
                       row_chunk=row_chunk, backend=backend)


def raster_rows(packet, cam, config, y0, rows: int, soft: bool = False,
                sigma: float = 0.5, row_chunk: int = 0, stride: int = 1,
                backend: str = "auto"):
    """Rasterize ``rows`` output rows y0, y0 + stride, … → (rows, W, 3),
    supersampled and resolved. Pixel rows are independent given the
    transformed triangles (the z test is per sample): the unit of a
    row-sharded rasterizer.

    ``backend``: "auto" runs the kernels (`raster_kernel.rasterize_fused`,
    `soft_raster.rasterize_soft_fused`: CUDA kernels for CUDA tensors, their
    plain versions for CPU tensors), for any size, window and stride;
    "oneshot" runs `_raster_tile` over all pairs at once."""
    if backend not in BACKENDS:
        raise ConfigError(f"raster backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        if soft:
            from ptre_tpu_torch.ops.cuda import soft_raster

            return soft_raster.rasterize_soft_fused(packet, cam, config, sigma=sigma,
                                                    y0=y0, stride=stride, rows=rows)
        from ptre_tpu_torch.ops.cuda import raster_kernel

        return raster_kernel.rasterize_fused(packet, cam, config, y0=y0, stride=stride,
                                             rows=rows)

    ss = config.supersample
    W, H = config.width * ss, config.height * ss
    dev = packet.device
    view = cam.view_matrix().to(dev)
    proj = cam.projection_matrix().to(dev)
    tri_v = torch.stack([packet.tri_v0, packet.tri_v1, packet.tri_v2], dim=1)
    tri_n = torch.stack([packet.tri_n0, packet.tri_n1, packet.tri_n2], dim=1)
    ndc, w, n_world = transform_vertices(tri_v, tri_n, packet.tri_dc, packet.transforms,
                                         view, proj)
    # viewport transform: NDC → supersampled pixel coords (y flip)
    screen = torch.stack([(ndc[..., 0] + 1.0) * 0.5 * W, (1.0 - ndc[..., 1]) * 0.5 * H],
                         dim=-1)
    depth01 = ndc[..., 2]

    Hw = rows * ss  # supersampled rows in this window
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    out_rows = float(y0) + float(stride) * torch.arange(rows, dtype=torch.float32, device=dev)
    ys = (out_rows[:, None] * ss + torch.arange(ss, dtype=torch.float32, device=dev)[None, :]
          + 0.5).reshape(-1)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    step = row_chunk if row_chunk and Hw > row_chunk else Hw
    if Hw % step:
        raise ConfigError(f"row_chunk {row_chunk} does not divide {Hw} supersampled rows")
    img = torch.cat([
        _raster_tile(gx[a:a + step].reshape(-1), gy[a:a + step].reshape(-1), screen,
                     depth01, w, n_world, packet.tri_valid, config, soft, sigma)
        for a in range(0, Hw, step)]).reshape(Hw, W, 3)
    # MSAA-style box resolve (`rasterizer.cu:142` ResolveSubresource)
    return img.reshape(rows, ss, config.width, ss, 3).mean(dim=(1, 3))


def rasterize_frames(packet, cam, frame_transforms, config, backend: str = "auto"):
    """K frames → (K, H, W, 3): frame k renders the packet with the
    per-drawcall transforms ``frame_transforms[k]`` ((K, D, 4, 4), the
    reference's per-frame animation state, `rasterizer.cu:155-169`). A loop
    of `rasterize` calls: PyTorch enqueues each frame's launches without a
    per-frame synchronisation."""
    return torch.stack([
        rasterize(dataclasses.replace(packet, transforms=tr), cam, config, backend=backend)
        for tr in frame_transforms])
