"""Launch a `torch.distributed` world of worker processes for the port's
tests (`test_torch_parallel.py`, `test_torch_dual_pipeline.py`,
`test_torch_multiprocess.py`).

Each rank is ``python <test file> worker <rank> <world> <init_method>
<args...>``: the test file's own ``__main__`` entry, which imports torch
and the port but never JAX. The ranks meet in a `FileStore` under the
test's temporary directory (no TCP port, so parallel test workers cannot
race for one), run gloo on the CPU with one thread each, and write their
results as npz files the test reads.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(script, nproc: int, store, *args):
    """Start ``nproc`` ranks of ``script``'s worker entry; returns the
    Popen objects. ``store``: a path for the world's FileStore (it must not
    exist yet)."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen([sys.executable, os.path.abspath(script), "worker", str(rank),
                              str(nproc), f"file://{store}", *map(str, args)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=ROOT)
            for rank in range(nproc)]


def wait(procs, timeout: float = 300):
    """(return codes, outputs) of every rank; on a timeout every rank is
    killed and the timeout re-raised."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return [p.returncode for p in procs], outs


def run(script, nproc: int, store, *args, timeout: float = 300):
    """Run a world to its end and fail unless every rank exited 0."""
    rcs, outs = wait(launch(script, nproc, store, *args), timeout)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out}"
    return outs


def worker_args(argv):
    """(rank, world size, init method, the rest) of a worker's argv."""
    return int(argv[2]), int(argv[3]), argv[4], argv[5:]
