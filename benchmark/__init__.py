"""The benchmark of ptre_tpu_torch (the PyTorch and CUDA port of the path
tracer): `python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`. `BENCHMARK.json` at the repository's root lists its cells and
metrics; every piece a cell, traffic mix or metric needs is a file of its
own under this folder, found by name (`harness.py`)."""
