"""Multi-GPU rendering and training over a ("dp", "sp") device mesh.

PyTorch port of `ptre_tpu/parallel/sharding.py`. The JAX package runs one
controller over a `Mesh` with ``shard_map``; here every rank is a process
of a `torch.distributed` world (SPMD) and calls the same step function on
its own slab. The per-rank code is the single-device path
(`integrator.trace`, `rasterizer.raster_rows` and their kernels):

  * ``dp`` axis: pixel rows. Rank ``dp_i`` owns ``padded_height(H, dp) //
    dp`` image rows (strided by default, `shard_row_ids`); the scene packet
    is replicated, so the bounce loop needs no communication.
  * ``sp`` axis: samples. Each sp rank traces ``spp // sp`` samples of its
    rows; their running averages (render) or means (train) are combined by
    one all-reduce over the ``sp`` group.
  * Gradients: each rank back-propagates its samples; the parameter
    gradients are all-reduced over every rank.

Collectives are ``all_reduce`` and ``broadcast`` only, so one code path runs
under NCCL across cards and under gloo on a card several ranks share (or on
the CPU). Gradient scaling follows the reference exactly: its in-loss
``pmean(., "sp")`` transposes to a psum of the cotangent, so a rank's
gradient comes out sp-fold too large and the mean over all ranks restores
the gradient of the global image MSE. Here the sp mean is `_GroupSum`, an
all-reduce whose backward all-reduces the cotangent, then the same mean.

Layouts. A rank holds its slab of the SHARD layout: rows [dp_i * rows,
(dp_i + 1) * rows) of a (padded_height(H, dp), W, 3) array whose row order
`to_shard_order` / `to_image_order` convert. `AccumState.linear` and a
training target are such slabs; `gather_rows` assembles the whole
shard-layout array on every rank.

Keys. A rank's key is ``fold(key, dp_i * 131071 + sp_i)``; render sample s
is keyed ``fold(fold(lkey, s), n)`` with n its running-average index, a
training sample ``fold(lkey, s)``. `_sample_rows` draws the pixel jitter
from the key; on the staged route the trace draws from the key too, exactly
as the reference; the fused and replay routes, whose kernels draw Philox,
seed from ``pathtracer.fused_seed(key)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator, rng
from ptre_tpu_torch.ops.cuda import fused_grad
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import rasterizer

#: the mesh axes, in the reference's order
MESH_AXES = ("dp", "sp")

#: default dp row assignment (`sharding.py:49-57`): "strided" interleaves
#: rows round-robin (rank i takes image rows i, i + dp, ...), so every rank
#: sees the same mix of sky and geometry rows; "block" gives contiguous
#: slabs. Both pad the row space to dp * ceil(H / dp) and mask pad rows.
ROW_ORDER_DEFAULT = "strided"
ROW_ORDERS = ("strided", "block")

#: the parameter keys, in the reference's order
PARAM_KEYS = ("transforms", "sph_center", "sph_radius", "mat_albedo", "mat_param",
              "sky_bottom", "sky_top", "cam_position", "cam_forward", "cam_fov")


# ---- row maps ------------------------------------------------------------------------


def padded_height(height: int, dp_size: int) -> int:
    """Sharded row-space height: dp * ceil(H / dp) (== H when dp | H)."""
    return dp_size * (-(-height // dp_size))


def _local_rows(cam, dp_size: int) -> int:
    return padded_height(cam.height, dp_size) // dp_size


def shard_row_ids(dp_i: int, rows: int, dp_size: int, row_order: str):
    """Image-row indices owned by dp rank ``dp_i`` (float32 (rows,)):
    strided → dp_i, dp_i + dp, ...; block → dp_i * rows .. dp_i * rows +
    rows - 1. Indices >= H are padding (rendered, then masked or dropped)."""
    ar = torch.arange(rows, dtype=torch.float32)
    dp_f = torch.tensor(float(dp_i), dtype=torch.float32)
    if row_order == "strided":
        return dp_f + float(dp_size) * ar
    return dp_f * float(rows) + ar


def to_image_order(arr, dp_size: int, height: int, row_order: str = ROW_ORDER_DEFAULT):
    """Shard-layout rows (Hpad, ...) → image order (height, ...): for
    "strided", slab row k of shard i is image row k * dp + i; for "block"
    a slice."""
    hp = arr.shape[0]
    rows = hp // dp_size
    if row_order == "strided":
        arr = arr.reshape((dp_size, rows) + tuple(arr.shape[1:]))
        arr = arr.transpose(0, 1).reshape((hp,) + tuple(arr.shape[2:]))
    return arr[:height]


def to_shard_order(img, dp_size: int, row_order: str = ROW_ORDER_DEFAULT):
    """Image-order rows (H, ...) → shard layout (Hpad, ...), zero-padded."""
    h = img.shape[0]
    hp = padded_height(h, dp_size)
    if hp != h:
        img = torch.cat([img, img.new_zeros((hp - h,) + tuple(img.shape[1:]))])
    if row_order == "strided":
        rows = hp // dp_size
        img = img.reshape((rows, dp_size) + tuple(img.shape[1:]))
        img = img.transpose(0, 1).reshape((hp,) + tuple(img.shape[2:]))
    return img


def _row_start_stride(dp_i: int, rows: int, dp_size: int, row_order: str):
    """(y0, stride) of `_sample_rows` / `raster_rows` under a row order."""
    if row_order not in ROW_ORDERS:
        raise ValueError(f"row_order must be one of {ROW_ORDERS}, got {row_order!r}")
    if row_order == "strided":
        return float(dp_i), dp_size
    return float(dp_i * rows), 1


# ---- the mesh and placement -------------------------------------------------------------


def make_mesh(shape=None, device_type: str = "cuda"):
    """A `DeviceMesh` over every rank of the world, dims ("dp", "sp").

    ``shape`` defaults to (world size, 1), pure row parallelism. With no
    process group yet, this process starts a world of one
    (`distributed.initialize`: NCCL for "cuda", gloo for "cpu"), so a
    single-process caller can ask for (1, 1). ``device_type`` "cuda" puts
    the rank on its card (`distributed.rank_device`; raises where there is
    none), "cpu" on the host (gloo only)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ptre_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        distributed.initialize(backend=None if device_type == "cuda" else "gloo")
    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} does not cover the world of {world} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(distributed.rank_device("cuda"))
    elif dist.get_backend() != "gloo":
        raise ValueError(f"a {device_type} mesh needs the gloo backend, not "
                         f"{dist.get_backend()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def _sizes(mesh):
    return int(mesh.shape[0]), int(mesh.shape[1])


def _coords(mesh):
    return mesh.get_local_rank("dp"), mesh.get_local_rank("sp")


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _map_tree(fn, tree):
    """``fn`` over the tensor leaves of dicts, lists, tuples and dataclass
    instances (packets, cameras, accumulators), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, np.ndarray):
        return fn(torch.from_numpy(tree))
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tree(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def replicate(mesh, tree):
    """``tree`` on every rank's device as rank 0 holds it: each tensor leaf
    copied to the rank's device and broadcast from the mesh's first rank."""
    dev = mesh_device(mesh)
    src = int(mesh.mesh.reshape(-1)[0])

    def put(x):
        t = x.detach().to(dev, copy=True)
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        dist.broadcast(wire, src=src)
        return wire.bool() if t.dtype == torch.bool else wire

    return _map_tree(put, tree)


def shard_rows(mesh, arr):
    """This rank's block of a shard-layout (Hpad, ...) array: rows [dp_i *
    Hpad / dp, (dp_i + 1) * Hpad / dp), copied to the rank's device."""
    dp, _ = _sizes(mesh)
    if arr.shape[0] % dp:
        raise ValueError(f"{arr.shape[0]} rows do not split over dp = {dp}")
    rows = arr.shape[0] // dp
    dp_i, _ = _coords(mesh)
    block = arr[dp_i * rows:(dp_i + 1) * rows]
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(mesh_device(mesh), copy=True)


def gather_rows(mesh, slab):
    """The whole shard-layout array (dp * rows, ...) on every rank, from
    each dp rank's ``slab``: every rank writes its slab into zeros and the
    dp group all-reduces them (disjoint slabs: the sum is exact). Ranks
    that differ only in sp hold the same slab."""
    dp, _ = _sizes(mesh)
    dp_i, _ = _coords(mesh)
    rows = slab.shape[0]
    full = slab.new_zeros((dp * rows,) + tuple(slab.shape[1:]))
    full[dp_i * rows:(dp_i + 1) * rows] = slab.detach()
    if dp > 1:
        dist.all_reduce(full, group=mesh.get_group("dp"))
    return full


class _GroupSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the cotangents over the
    same group (the transpose of the reference's psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _sp_mean(mesh, x):
    """The mean of ``x`` over the sp group (``pmean(x, "sp")``),
    differentiable as the reference's."""
    _, sp = _sizes(mesh)
    if sp == 1:
        return x
    return _GroupSum.apply(x, mesh.get_group("sp")) / sp


def _mean_over_ranks(mesh, tensors):
    """``pmean(t, ("dp", "sp"))`` of each tensor: one all-reduce of their
    concatenation over every rank, divided by the rank count."""
    dp, sp = _sizes(mesh)
    if dp * sp == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat = flat / (dp * sp)
    return [p.reshape(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]),
                                                 tensors)]


# ---- the per-rank sample ----------------------------------------------------------------


def _forward(packet, config):
    """The packet packed once for every sample of a step on the fused and
    replay routes (`fused_grad.prepare_forward`, no screen camera), else
    None."""
    if integrator.grad_route(config, packet) in ("fused", "replay"):
        return fused_grad.prepare_forward(packet)
    return None


def _sample_rows(key, packet, cam, config, y0, rows: int, stride: int = 1, forward=None):
    """One jittered sample of ``rows`` image rows y0, y0 + stride, ... →
    (rows * W, 3), clamped and scrubbed as ``config`` says
    (`sharding.py:111-124`). The jitter is ``pixel_jitter(fold(key,
    0x9E37))``; the trace takes the key itself on the staged route and
    ``pathtracer.fused_seed(key)`` on the fused and replay routes.
    ``forward``: `_forward` of the packet, shared by a step's samples."""
    dev = packet.device
    ys = torch.tensor(float(y0), dtype=torch.float32) + float(stride) * torch.arange(
        rows, dtype=torch.float32)
    py, px = torch.meshgrid(ys.to(dev), torch.arange(cam.width, dtype=torch.float32,
                                                     device=dev), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    jitter = rng.pixel_jitter(rng.fold(key, 0x9E37), (px.shape[0],), dev)
    o, d = cam_ops.get_rays(cam, px, py, jitter)
    if integrator.grad_route(config, packet) == "staged":
        color = integrator.trace(o, d, packet, config, key=key)
    else:
        color = integrator.trace(o, d, packet, config, seed=pt.fused_seed(key),
                                 forward=forward)
    return integrator.postprocess_sample(color, config.clamp_samples)


def _rank_window(mesh, cam, row_order):
    """(rows, y0, stride, lkey_id) of this rank."""
    dp, _ = _sizes(mesh)
    dp_i, sp_i = _coords(mesh)
    rows = _local_rows(cam, dp)
    y0, stride = _row_start_stride(dp_i, rows, dp, row_order)
    return rows, y0, stride, dp_i * 131071 + sp_i


def _local_spp(mesh, spp: int) -> int:
    _, sp = _sizes(mesh)
    if spp % sp:
        raise ValueError(f"spp {spp} does not split over sp = {sp}")
    return spp // sp


def _row_mask(y0, stride, rows: int, height: int, device):
    ys = y0 + float(stride) * torch.arange(rows, dtype=torch.float32)
    return (ys < float(height)).to(torch.float32).to(device)[:, None, None]


def _check_slab(what, t, rows: int, width: int):
    if tuple(t.shape) != (rows, width, 3):
        raise ValueError(f"{what} has shape {tuple(t.shape)}: a rank's slab is "
                         f"({rows}, {width}, 3)")


# ---- the steps -----------------------------------------------------------------------------


def shard_render_step(mesh, packet, cam, accum: pt.AccumState, key, config, spp: int = 1,
                      row_order: str = ROW_ORDER_DEFAULT) -> pt.AccumState:
    """Progressive render step, rows over dp, samples over sp
    (`sharding.py:134-195`).

    ``accum.linear`` is this rank's slab, (padded_height(H, dp) // dp, W,
    3); ``accum.frame`` the samples every rank has accumulated. Each sp rank
    runs a running average of spp / sp samples from the shared ``frame``
    (``img / n + lin * ((n - 1) / n)``, the reference's expression), and the
    sp ranks' averages are averaged. ``key``: an `rng.Key`. Returns
    AccumState(slab, frame + spp)."""
    local_spp = _local_spp(mesh, spp)
    rows, y0, stride, kid = _rank_window(mesh, cam, row_order)
    _check_slab("accum.linear", accum.linear, rows, cam.width)
    lkey = rng.fold(key, kid)
    dev = accum.linear.device
    with torch.no_grad():
        forward = _forward(packet, config)
        lin, n = accum.linear, accum.frame
        for s in range(local_spp):
            n += 1
            img = _sample_rows(rng.fold(rng.fold(lkey, s), n), packet, cam, config, y0, rows,
                               stride, forward).reshape(rows, cam.width, 3)
            nf = torch.tensor(float(n), dtype=torch.float32, device=dev)
            lin = img / nf + lin * ((nf - 1.0) / nf)
        lin = _sp_mean(mesh, lin)
    return pt.AccumState(linear=lin, frame=accum.frame + spp)


def differentiable_params(packet, cam):
    """The sweepable / differentiable parameters: a dict of the packet's and
    the camera's float leaves. The camera's leaves are moved to the packet's
    device, where the rays are made."""
    dev = packet.device
    return {
        "transforms": packet.transforms,
        "sph_center": packet.sph_center,
        "sph_radius": packet.sph_radius,
        "mat_albedo": packet.mat_albedo,
        "mat_param": packet.mat_param,
        "sky_bottom": packet.sky_bottom,
        "sky_top": packet.sky_top,
        "cam_position": cam.position.to(dev),
        "cam_forward": cam.forward.to(dev),
        "cam_fov": cam.fov_degrees.to(dev),
    }


def apply_params(params, packet, cam):
    """(packet, camera) with the parameter leaves put in place; the camera's
    other leaves follow the parameters' device."""
    packet = dataclasses.replace(
        packet,
        transforms=params["transforms"],
        sph_center=params["sph_center"],
        sph_radius=params["sph_radius"],
        mat_albedo=params["mat_albedo"],
        mat_param=params["mat_param"],
        sky_bottom=params["sky_bottom"],
        sky_top=params["sky_top"],
    )
    dev = params["cam_position"].device
    cam = dataclasses.replace(
        cam,
        position=params["cam_position"],
        forward=params["cam_forward"],
        fov_degrees=params["cam_fov"],
        znear=cam.znear.to(dev),
        zfar=cam.zfar.to(dev),
    )
    return packet, cam


def _pt_image(mesh, leaves, packet, cam, key, config, local_spp, rows, y0, stride, kid):
    """(camera with ``leaves`` applied, the sp mean of this rank's
    ``local_spp`` samples (rows, W, 3)), differentiable."""
    pkt, lcam = apply_params(leaves, packet, cam)
    lkey = rng.fold(key, kid)
    forward = _forward(pkt, config)
    acc = torch.zeros((rows, cam.width, 3), dtype=torch.float32, device=pkt.device)
    for s in range(local_spp):
        acc = acc + _sample_rows(rng.fold(lkey, s), pkt, lcam, config, y0, rows, stride,
                                 forward).reshape(rows, cam.width, 3)
    return lcam, _sp_mean(mesh, acc / local_spp)


def _value_and_mean_grad(mesh, local_loss, leaves):
    """(mean of the loss over dp, gradients averaged over every rank) of
    this rank's ``local_loss``."""
    grads = torch.autograd.grad(local_loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves.values(), grads)]
    grads = dict(zip(leaves, _mean_over_ranks(mesh, grads)))
    dp, _ = _sizes(mesh)
    loss = local_loss.detach().clone()
    if dp > 1:
        dist.all_reduce(loss, group=mesh.get_group("dp"))
        loss = loss / dp
    return loss, grads


def shard_train_step(mesh, params, packet, cam, target, key, config, spp: int = 1,
                     lr: float = 0.0, row_order: str = ROW_ORDER_DEFAULT):
    """One forward + backward step of the image MSE against ``target``
    (`sharding.py:232-322`), rows over dp, samples over sp.

    ``target`` is this rank's slab of the shard-layout target
    (`to_shard_order`, then `shard_rows`). Pad rows are masked, and each
    rank's squared error is scaled by dp / (H * W * 3), so the dp mean of
    the ranks' losses is the image MSE over the true H rows. The scene is
    packed once a step. Returns (loss, grads, new_params), the loss a 0-d
    tensor equal on every rank; ``lr`` > 0 applies SGD."""
    local_spp = _local_spp(mesh, spp)
    rows, y0, stride, kid = _rank_window(mesh, cam, row_order)
    _check_slab("target", target, rows, cam.width)
    dp, _ = _sizes(mesh)
    n_valid = float(cam.height * cam.width * 3)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    _, img = _pt_image(mesh, leaves, packet, cam, key, config, local_spp, rows, y0, stride,
                       kid)
    mask = _row_mask(y0, stride, rows, cam.height, img.device)
    local = torch.sum(mask * (img - target) ** 2) * (float(dp) / n_valid)
    loss, grads = _value_and_mean_grad(mesh, local, leaves)
    new_params = ({k: params[k] - lr * grads[k] for k in params} if lr else params)
    return loss, grads, new_params


def shard_raster_step(mesh, packet, cam, config, soft: bool = False, sigma: float = 0.5,
                      row_order: str = ROW_ORDER_DEFAULT):
    """Rasterize this rank's rows → its slab (padded_height(H, dp) // dp,
    W, 3) of the shard layout (`sharding.py:325-354`). Every rank runs the
    vertex stage on the replicated packet and rasterizes only its rows, with
    no collective; pad rows past H are rasterized and dropped by
    `to_image_order`. ``soft=True`` is the differentiable SoftRas form; the
    hard form runs without a graph."""
    dp, _ = _sizes(mesh)
    dp_i, _ = _coords(mesh)
    rows = padded_height(config.height, dp) // dp
    y0, stride = _row_start_stride(dp_i, rows, dp, row_order)
    if soft:
        return rasterizer.raster_rows(packet, cam, config, y0, rows, soft=True, sigma=sigma,
                                      stride=stride)
    with torch.no_grad():
        return rasterizer.raster_rows(packet, cam, config, y0, rows, stride=stride)


def dual_pipeline_step(mesh, packet, raster_packet, cam, accum: pt.AccumState, key, config,
                       raster_config, spp: int = 1, row_order: str = ROW_ORDER_DEFAULT):
    """BASELINE config 5 (`sharding.py:357-374`): the hard rasterizer's
    frame and a progressive path-traced step over the same scene and
    camera, both row-sharded. Returns (accum', raster slab)."""
    accum = shard_render_step(mesh, packet, cam, accum, key, config, spp=spp,
                              row_order=row_order)
    raster = shard_raster_step(mesh, raster_packet, cam, raster_config, row_order=row_order)
    return accum, raster


def _shared_transforms(transforms, n_raster: int):
    """The path-traced packet's drawcall table as the raster packet reads it
    in the reference (`sharding.py:404`). Where the raster packet has more
    drawcalls (analytic spheres drawn as triangles: the demo's 3 against 1),
    the reference's gather ``transforms[tri_dc]`` clamps the indices past
    the table to its last row, and its transpose drops their cotangents.
    Rows past the table are detached copies of the last row: the same
    image, the same gradient."""
    extra = n_raster - transforms.shape[0]
    if extra <= 0:
        return transforms
    return torch.cat([transforms, transforms[-1:].detach().expand(extra, -1, -1)])


def dual_train_step(mesh, params, packet, raster_packet, cam, target, key, config,
                    raster_config, spp: int = 1, raster_weight: float = 0.5,
                    sigma: float = 0.5, row_order: str = ROW_ORDER_DEFAULT):
    """The differentiable dual pipeline (`sharding.py:377-444`): the MSE of
    the path-traced image plus ``raster_weight`` times the MSE of the SoftRas
    image, both against this rank's ``target`` slab, with pad rows masked.
    The raster packet shares ``params["transforms"]`` and the camera, so
    both pipelines' gradients reach them. Returns (loss, grads)."""
    if (config.width, config.height) != (raster_config.width, raster_config.height):
        raise ValueError("the render and raster configs differ in size")
    local_spp = _local_spp(mesh, spp)
    rows, y0, stride, kid = _rank_window(mesh, cam, row_order)
    _check_slab("target", target, rows, cam.width)
    dp, _ = _sizes(mesh)
    n_valid = float(cam.height * cam.width * 3)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    lcam, pt_img = _pt_image(mesh, leaves, packet, cam, key, config, local_spp, rows, y0,
                                stride, kid)
    rpkt = dataclasses.replace(raster_packet, transforms=_shared_transforms(
        leaves["transforms"], raster_packet.transforms.shape[0]))
    rz_img = rasterizer.raster_rows(rpkt, lcam, raster_config, y0, rows, soft=True,
                                    sigma=sigma, stride=stride)
    mask = _row_mask(y0, stride, rows, cam.height, pt_img.device)
    scale = float(dp) / n_valid
    pt_loss = torch.sum(mask * (pt_img - target) ** 2) * scale
    rz_loss = torch.sum(mask * (rz_img - target) ** 2) * scale
    return _value_and_mean_grad(mesh, pt_loss + raster_weight * rz_loss, leaves)


# ---- factories (`sharding.py:447-498`) --------------------------------------------------


def make_render_step(mesh, cam, config, spp: int = 1, row_order: str = ROW_ORDER_DEFAULT):
    """``step(packet, accum, key) -> AccumState``: `shard_render_step`
    closed over its static arguments. The reference jit-compiles it; here
    nothing is traced, so the closure only fixes the arguments."""
    def step(packet, accum, key):
        return shard_render_step(mesh, packet, cam, accum, key, config, spp=spp,
                                 row_order=row_order)

    return step


def make_train_step(mesh, cam, config, spp: int = 1, lr: float = 0.0,
                    row_order: str = ROW_ORDER_DEFAULT):
    """``step(params, packet, target, key) -> (loss, grads, new_params)``:
    `shard_train_step` closed over its static arguments."""
    def step(params, packet, target, key):
        return shard_train_step(mesh, params, packet, cam, target, key, config, spp=spp,
                                lr=lr, row_order=row_order)

    return step


def make_dual_train_step(mesh, cam, config, raster_config, spp: int = 1,
                         raster_weight: float = 0.5, sigma: float = 0.5,
                         row_order: str = ROW_ORDER_DEFAULT):
    """``step(params, packet, raster_packet, target, key) -> (loss,
    grads)``: `dual_train_step` closed over its static arguments."""
    def step(params, packet, raster_packet, target, key):
        return dual_train_step(mesh, params, packet, raster_packet, cam, target, key, config,
                               raster_config, spp=spp, raster_weight=raster_weight,
                               sigma=sigma, row_order=row_order)

    return step
