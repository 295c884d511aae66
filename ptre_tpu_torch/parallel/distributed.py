"""Process bootstrap and global-mesh helpers over `torch.distributed`.

PyTorch port of `ptre_tpu/parallel/distributed.py`. JAX runs one process a
host over all its chips; here every rank is a process with one device, so:

  * `initialize()` starts the default process group, once, on every rank:
    from its arguments or from the variables ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), as the reference reads ``JAX_*``. With neither, a
    world of one.
  * The backend is NCCL (the card) unless the caller names another. Under
    NCCL rank r of a host takes card ``LOCAL_RANK`` and a host with fewer
    cards than ranks raises. Ranks share a card only under gloo, which the
    caller asks for by name (``backend="gloo"``): rank r then takes card
    ``LOCAL_RANK`` modulo the card count, and gloo moves CUDA tensors for
    the two collectives the steps use (all-reduce and broadcast). A CPU
    mesh runs on gloo.
  * `global_mesh()` is `sharding.make_mesh` over every rank;
    `make_global_array()` / `replicate_global()` / `shard_rows_global()`
    give each rank its own block of host data; `process_local_rows()` the
    rows it owns.

Nothing falls back: no card means a "cuda" mesh or NCCL raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ptre_tpu_torch.parallel import sharding as _sh
from ptre_tpu_torch.utils.device import require_cuda
from ptre_tpu_torch.utils.errors import RendererError


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else default


def _card_index(local: int, backend: str) -> int:
    """The card of a rank with host rank ``local``: ``local`` itself under
    NCCL (raises if the host has fewer cards), ``local`` modulo the card
    count otherwise (ranks may share a card)."""
    require_cuda()
    n = torch.cuda.device_count()
    if backend != "nccl":
        return local % n
    if local >= n:
        raise RendererError(f"NCCL needs a card a rank: local rank {local} on a host with "
                            f"{n} card(s); ranks share a card only under backend='gloo'")
    return local


def rank_device(device_type: str = "cuda") -> torch.device:
    """The device of this rank: the CPU for "cpu"; for "cuda" the card of
    its host rank (``LOCAL_RANK``, else the global rank): that card under
    NCCL, under gloo that rank modulo the card count."""
    if device_type != "cuda":
        return torch.device(device_type)
    started = dist.is_initialized()
    local = _env_int("LOCAL_RANK", dist.get_rank() if started else 0)
    return torch.device("cuda", _card_index(local, dist.get_backend() if started else "nccl"))


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """Start the default process group on this rank; a no-op once started.

    Arguments default to torchrun's variables (``WORLD_SIZE``, ``RANK``;
    ``MASTER_ADDR`` / ``MASTER_PORT`` give ``init_method="env://"``). With
    no init method and a world of one, an in-process store. ``backend``:
    None means "nccl" (the card: raises where there is none); "gloo" for the
    CPU or for ranks sharing a card. ``timeout``: seconds a collective may
    wait for a missing peer before it fails."""
    if dist.is_initialized():
        return
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else int(world_size)
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    backend = backend or "nccl"
    if init_method is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init_method = "env://"
    if init_method is None and world_size != 1:
        raise ValueError(f"a world of {world_size} ranks needs an init_method, or "
                         "MASTER_ADDR and MASTER_PORT")
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        torch.cuda.set_device(_card_index(_env_int("LOCAL_RANK", rank), "nccl"))
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, **kw)


def is_multihost() -> bool:
    """True when the world has more than one process (the reference's
    ``jax.process_count() > 1``)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(shape: Optional[Tuple[int, int]] = None, device_type: str = "cuda"):
    """("dp", "sp") mesh over every rank of the world (`sharding.make_mesh`);
    defaults to (world size, 1), pure row parallelism."""
    return _sh.make_mesh(shape, device_type)


def _block_index(mesh, spec, full_shape):
    """This rank's block of ``full_shape`` under ``spec``: per dimension a
    mesh axis name ("dp" or "sp") that splits it, or None (whole)."""
    coords = dict(zip(_sh.MESH_AXES, _sh._coords(mesh)))
    sizes = dict(zip(_sh.MESH_AXES, _sh._sizes(mesh)))
    spec = tuple(spec)
    if len(spec) > len(full_shape):
        raise ValueError(f"spec {spec} has more dimensions than shape {tuple(full_shape)}")
    idx = []
    for dim, n in enumerate(full_shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            idx.append(slice(0, n))
            continue
        if axis not in sizes:
            raise ValueError(f"spec names {axis!r}; the mesh axes are {_sh.MESH_AXES}")
        if n % sizes[axis]:
            raise ValueError(f"dimension {dim} ({n}) does not split over {axis} = "
                             f"{sizes[axis]}")
        b = n // sizes[axis]
        idx.append(slice(coords[axis] * b, (coords[axis] + 1) * b))
    return tuple(idx)


def make_global_array(mesh, spec, full_shape, local_lookup) -> torch.Tensor:
    """This rank's block of a global array on its device.

    ``spec``: per dimension the mesh axis that splits it, or None (the
    reference's ``PartitionSpec``; ``()`` replicates). ``local_lookup(index)``
    maps a tuple of slices of ``full_shape`` to the block's data (numpy or a
    tensor); it is called once, for this rank's block. For data every rank
    holds whole, pass ``lambda idx: full[idx]``."""
    block = local_lookup(_block_index(mesh, spec, full_shape))
    dev = _sh.mesh_device(mesh)
    if isinstance(block, torch.Tensor):
        return block.detach().to(dev, copy=True)
    return torch.tensor(np.asarray(block), device=dev)


def replicate_global(mesh, tree):
    """Every tensor or array leaf of ``tree`` (host data each rank holds)
    on this rank's device, whole: the scene packet and camera placement.
    No collective: each rank supplies its own copy, as in the reference."""
    def put(x):
        return make_global_array(mesh, (), tuple(x.shape), lambda idx: x[idx])

    return _sh._map_tree(put, tree)


def shard_rows_global(mesh, arr) -> torch.Tensor:
    """This rank's block of rows of a host (H, ...) array split over dp."""
    shape = tuple(np.shape(arr))
    return make_global_array(mesh, ("dp",), shape, lambda idx: arr[idx])


def process_local_rows(mesh, global_rows: int) -> Tuple[int, int]:
    """The [start, stop) rows this rank owns of ``global_rows`` split over
    dp."""
    dp, _ = _sh._sizes(mesh)
    rows = global_rows // dp
    dp_i, _ = _sh._coords(mesh)
    return dp_i * rows, (dp_i + 1) * rows
