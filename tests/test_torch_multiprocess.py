"""The port's process bootstrap and global-mesh helpers
(`ptre_tpu_torch/parallel/distributed.py`) in real multi-process worlds,
and the fault-drill resume of `tests/test_multihost.py:112-162`.

Worlds are gloo ranks on the CPU (`_torch_world.py`), each rank this file's
``worker`` entry. A 4-rank world started from torchrun's variables checks
`initialize`, `global_mesh`, `process_local_rows`, `make_global_array`,
`replicate_global`, `shard_rows_global`, `replicate` and `gather_rows`
against numpy slicing, exactly. The drill: a 2-rank progressive render
(mesh (2, 1), each step followed by `gather_rows` of the frame) saves each
rank's slab and step cursor with `utils/checkpoint.save_render_state` after
every step; rank 1 dies after step 1 (``os._exit(17)``), the survivor's
next collective fails within the group's 10 s timeout, and a relaunch that
resumes from the checkpoints ends bit-equal to an uninterrupted run, slab
for slab.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import _torch_world

H = W = 16
CHECK_WORLD, CHECK_MESH = 4, (2, 2)
DRILL_WORLD, DRILL_STEPS, DRILL_SPP, DRILL_SEED = 2, 4, 2, 7
DRILL_TIMEOUT_S = 10


def _rank_values(rank):
    """Data that differs per rank: `replicate` must hand out rank 0's."""
    return {"x": torch.full((3, 2), float(rank)), "flag": torch.tensor([rank % 2 == 0, True]),
            "n": torch.tensor(rank, dtype=torch.int32)}


# ---- in this process: nothing starts without its device --------------------------------


def test_initialize_and_mesh_raise_without_a_card_or_a_store():
    import torch.distributed as dist

    from ptre_tpu_torch.parallel import distributed, sharding as sh
    from ptre_tpu_torch.utils.errors import RendererError

    assert not dist.is_initialized()
    with pytest.raises(RendererError):  # the default backend is NCCL: no card, no world
        distributed.initialize()
    with pytest.raises(RendererError):
        sh.make_mesh((1, 1))  # a "cuda" mesh starts an NCCL world of one
    with pytest.raises(ValueError, match="init_method"):
        distributed.initialize(world_size=2, rank=0, backend="gloo")
    assert not dist.is_initialized() and not distributed.is_multihost()


# ---- the 4-rank world ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_checks")
    _torch_world.run(__file__, CHECK_WORLD, out / "store", "checks", out, timeout=300)
    return [dict(np.load(out / f"checks_r{r}.npz")) for r in range(CHECK_WORLD)]


def test_initialize_reads_torchrun_variables_once(checks):
    for rank, c in enumerate(checks):
        assert int(c["rank"]) == rank and int(c["world"]) == CHECK_WORLD
        assert str(c["backend"]) == "gloo" and bool(c["multihost"])
        assert bool(c["second_call_kept_world"])


def test_global_mesh_coordinates_and_local_rows(checks):
    dp, sp = CHECK_MESH
    for rank, c in enumerate(checks):
        dp_i, sp_i = rank // sp, rank % sp  # row-major over (dp, sp)
        assert tuple(c["coords"]) == (dp_i, sp_i) and tuple(c["shape"]) == CHECK_MESH
        rows = H // dp
        assert tuple(c["local_rows"]) == (dp_i * rows, (dp_i + 1) * rows)


def test_make_global_array_gives_each_rank_its_block(checks):
    dp, sp = CHECK_MESH
    full = np.arange(H * 4, dtype=np.float32).reshape(H, 4)
    for rank, c in enumerate(checks):
        dp_i, sp_i = rank // sp, rank % sp
        r0, r1 = dp_i * H // dp, (dp_i + 1) * H // dp
        np.testing.assert_array_equal(c["dp_block"], full[r0:r1])
        np.testing.assert_array_equal(c["dp_sp_block"], full[r0:r1, sp_i * 2:(sp_i + 1) * 2])
        np.testing.assert_array_equal(c["replicated"], full)
        np.testing.assert_array_equal(c["rows_global"], full[r0:r1])
        assert int(c["lookups"]) == 1  # the lookup is called once, for this rank's block


def test_replicate_and_gather_rows(checks):
    want = _rank_values(0)
    full = np.arange(H * 4, dtype=np.float32).reshape(H, 4)
    for c in checks:
        for k, v in want.items():
            np.testing.assert_array_equal(c[f"rep_{k}"], v.numpy())
            assert c[f"rep_{k}"].dtype == v.numpy().dtype
        np.testing.assert_array_equal(c["gathered"], full)
        np.testing.assert_array_equal(c["packet_sph_radius"], checks[0]["packet_sph_radius"])


# ---- the fault drill ------------------------------------------------------------------------


def _drill(tmp, tag, die_rank=-1, die_after=-1, resume=0):
    return _torch_world.launch(__file__, DRILL_WORLD, tmp / f"{tag}.store", "drill", tmp, tag,
                               die_rank, die_after, resume)


def test_fault_drill_resume_equals_uninterrupted_run(tmp_path):
    from ptre_tpu_torch.utils import checkpoint as ckpt

    ref, drill = tmp_path / "ref", tmp_path / "drill"
    ref.mkdir()
    drill.mkdir()
    rcs, outs = _torch_world.wait(_drill(ref, "ref"), timeout=300)
    assert rcs == [0] * DRILL_WORLD, outs

    # rank 1 dies after its step-1 checkpoint
    procs = _drill(drill, "p1", die_rank=1, die_after=1)
    rcs, outs = _torch_world.wait(procs[1:], timeout=300)
    assert rcs == [17], outs
    # the survivor's step-2 collective fails within the timeout; reap it
    rcs, outs = _torch_world.wait(procs[:1], timeout=DRILL_TIMEOUT_S + 60)
    assert rcs[0] != 0, outs  # it could not finish without its peer
    for rank in range(DRILL_WORLD):
        _, seed, cursor, _ = ckpt.load_render_state(str(drill / f"rank{rank}.npz"), "cpu")
        assert seed == DRILL_SEED and cursor == 1, (rank, cursor)

    rcs, outs = _torch_world.wait(_drill(drill, "p2", resume=1), timeout=300)
    assert rcs == [0] * DRILL_WORLD, outs
    for rank in range(DRILL_WORLD):
        want = np.load(ref / f"ref_final{rank}.npz")
        got = np.load(drill / f"p2_final{rank}.npz")
        assert int(got["frame"]) == int(want["frame"]) == DRILL_STEPS * DRILL_SPP
        np.testing.assert_array_equal(got["slab"], want["slab"])
        np.testing.assert_array_equal(got["image"], want["image"])
        assert "resumed at step 2" in outs[rank]


# ---- the workers ------------------------------------------------------------------------------


def _checks(rank, world_size, init, out_dir):
    """One rank of the 4-rank world, started as torchrun starts a rank."""
    import torch.distributed as dist

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.parallel import distributed, sharding as sh

    os.environ.update(WORLD_SIZE=str(world_size), RANK=str(rank), LOCAL_RANK=str(rank))
    distributed.initialize(init, backend="gloo", timeout=120)
    distributed.initialize("file:///nonexistent", world_size=99, rank=98)  # a no-op
    second_ok = dist.get_world_size() == world_size and dist.get_rank() == rank
    mesh = distributed.global_mesh(CHECK_MESH, device_type="cpu")
    full = np.arange(H * 4, dtype=np.float32).reshape(H, 4)
    lookups = []

    def lookup(idx):
        lookups.append(idx)
        return full[idx]

    dp_block = distributed.make_global_array(mesh, ("dp",), full.shape, lookup)
    dp_sp_block = distributed.make_global_array(mesh, ("dp", "sp"), full.shape,
                                                lambda idx: full[idx])
    replicated = distributed.replicate_global(mesh, {"a": full})["a"]
    rows_global = distributed.shard_rows_global(mesh, full)
    rep = sh.replicate(mesh, _rank_values(rank))
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    pkt = sh.replicate(mesh, pkt)
    dp_i, _ = sh._coords(mesh)
    rows = H // mesh.shape[0]
    gathered = sh.gather_rows(mesh, torch.from_numpy(full[dp_i * rows:(dp_i + 1) * rows]))
    np.savez(os.path.join(out_dir, f"checks_r{rank}.npz"),
             rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.get_backend(),
             multihost=distributed.is_multihost(), second_call_kept_world=second_ok,
             coords=sh._coords(mesh), shape=tuple(mesh.shape),
             local_rows=distributed.process_local_rows(mesh, H), dp_block=dp_block.numpy(),
             dp_sp_block=dp_sp_block.numpy(), replicated=replicated.numpy(),
             rows_global=rows_global.numpy(), lookups=len(lookups),
             gathered=gathered.numpy(), packet_sph_radius=pkt.sph_radius.numpy(),
             **{f"rep_{k}": v.numpy() for k, v in rep.items()})
    dist.destroy_process_group()


def _drill_rank(rank, world_size, init, out_dir, tag, die_rank, die_after, resume):
    """One rank of the drill's progressive render job."""
    import torch.distributed as dist

    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.ops import rng
    from ptre_tpu_torch.parallel import distributed, sharding as sh
    from ptre_tpu_torch.render import pathtracer as pt
    from ptre_tpu_torch.utils import checkpoint as ckpt
    from ptre_tpu_torch.utils.config import RenderConfig

    distributed.initialize(init, world_size, rank, backend="gloo", timeout=DRILL_TIMEOUT_S)
    mesh = sh.make_mesh((world_size, 1), device_type="cpu")
    pkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H)
    step = sh.make_render_step(mesh, cam, RenderConfig(width=W, height=H), spp=DRILL_SPP)
    key = rng.key_for(DRILL_SEED)
    path = os.path.join(out_dir, f"rank{rank}.npz")
    if int(resume):
        accum, _, done, _ = ckpt.load_render_state(path, "cpu")
        start = done + 1
        print(f"rank {rank} resumed at step {start}", flush=True)
    else:
        accum, start = pt.AccumState(sh.shard_rows(mesh, torch.zeros((H, W, 3))), 0), 0
    for s in range(start, DRILL_STEPS):
        accum = step(pkt, accum, rng.fold(key, s))
        image = sh.gather_rows(mesh, accum.linear)  # the frame a viewer shows
        ckpt.save_render_state(path, accum, DRILL_SEED, s)
        if rank == int(die_rank) and s == int(die_after):
            os._exit(17)  # a hard death after the step-s checkpoint
    np.savez(os.path.join(out_dir, f"{tag}_final{rank}.npz"), slab=accum.linear.numpy(),
             frame=accum.frame, image=image.numpy())
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    torch.set_num_threads(1)
    _rank, _world, _init, (_mode, *_rest) = _torch_world.worker_args(sys.argv)
    {"checks": _checks, "drill": _drill_rank}[_mode](_rank, _world, _init, *_rest)
