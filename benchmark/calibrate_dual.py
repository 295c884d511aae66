"""`calibrate.py` for the dual cell: the same readings, with the dual
cell's faults (`dual_faults`) planted in its adapter (`program_dual`).

    python3 benchmark/calibrate_dual.py --workload dual_mesh.train \\
        --seeds 11,12,... --seconds 3 --control 3 --fault unchanged \\
        --fault half --fault altered [--out FILE]
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

import benchmark  # noqa: E402
from benchmark import calibrate, dual_faults, program_dual  # noqa: E402

if __name__ == "__main__":
    # calibrate.main takes `faults` and `program` from the package: these two
    # stand in for them
    benchmark.faults, benchmark.program = dual_faults, program_dual
    sys.exit(calibrate.main())
