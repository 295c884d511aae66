"""Readings that a cell's limits are set from, on the card: the comparison's
numbers for the program on many seeds, and for the control, the reference
computed in bfloat16 put in the program's place, on the first few.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... \\
        --seconds 3 --control 3 [--dtype bfloat16] [--fault half ...] [--out FILE]

One process: each seed is a whole set-up, a short window at the cell's own
load and the check; one JSON line a seed (program readings, control and fault readings
where asked, calls, seconds the reference took). `checks/<cell>.json` keeps
the limits set from them, and `PERF.md` the readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3,
                   help="seeds that also read the control and the faults")
    p.add_argument("--dtype", default="bfloat16", help="the control's precision, or none")
    p.add_argument("--fault", action="append", default=[],
                   help="also read this fault (faults.FAULTS) on the control's seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import faults, harness, program

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run, loop, kept = harness.measure(ROOT, args.workload, seed, args.seconds, False, dev,
                                          time.time())
        t0 = time.time()
        line = {"workload": args.workload, "seed": seed, "calls": run.calls,
                "program": loop.check(run, kept, torch.float32)}
        line["check_s"] = time.time() - t0
        if k < args.control:
            if args.dtype != "none":
                line["control"] = loop.check(run, kept, getattr(torch, args.dtype))
            for fault in args.fault:
                name, bad = faults.plant(run.traffic["loop"], fault)
                good = getattr(program, name)
                setattr(program, name, bad)
                try:
                    frun, floop, fkept = harness.measure(ROOT, args.workload, seed, args.seconds,
                                                         False, dev, time.time())
                finally:
                    setattr(program, name, good)
                line["fault_" + fault] = floop.check(frun, fkept, torch.float32)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
