"""Run one cell of the benchmark on the card this process is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the correctness comparison
read, beside its limit; the same numbers are the last lines of standard
error. Exits non-zero, printing no result, where there is no card, where the
cell asks for more cards than there are, or where a module of JAX or of the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the run inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "benchmark", ".cache", _sub)
# the bytecode of every module a run imports (torch's most of all: some
# thousand files, some seconds to compile) is kept inside the checkout, so that
# only a checkout's first run compiles it
sys.pycache_prefix = os.path.join(ROOT, "benchmark", ".cache", "pycache")
sys.dont_write_bytecode = False
# run as a script, this folder comes first on the path, where its modules
# would shadow the standard library's (profile, ...): import from the root
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
sys.path.insert(0, ROOT)


def process_start() -> float:
    """The epoch second this process started, from /proc; the time this
    module was loaded where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return min(_T0, btime + ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, StopIteration):
        return _T0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, cell, _, _ = harness.find(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = harness.card_name_and_power_limit()
    if card is not None:
        print(f"benchmark: card {card[0]}, power limit {card[1]}", file=sys.stderr)
    result, run = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0), process_start())
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: modules that no run may load were loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"benchmark: {run.calls} calls in {run.window_s!r} s, set-up {run.setup_s!r} s, "
          f"check {run.check_s!r} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
