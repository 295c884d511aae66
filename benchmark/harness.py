"""The benchmark's harness: runs one cell of `BENCHMARK.json` and reduces it
to the contract's result.

Everything a cell needs is found by name, so that a new cell, traffic mix or
metric is new files and entries only:

* the cell's configuration file is named in ``configs[].file``;
* its traffic mix is ``traffic/<traffic>.json``, whose ``loop`` names the
  closed loop ``loops/<loop>.py`` that drives the program under that mix;
* a metric ``<name>`` is read by ``metrics/<name>.py``, a kernel's share of
  its roofline ``<kernel>_roofline`` by ``rooflines/<kernel>.py``;
* the limits of the comparison that decides ``correct`` are in
  ``checks/<cell>.json``.

A loop module has ``setup(run) -> state`` (build, warm up: counted as set-up),
``call(state, i)`` (the i-th timed call), ``rays(state)`` (the nominal rays
of one call), ``outputs(state) -> kept`` (the outputs the window left, taken
as it closes, before any traced call) and ``check(run, kept, dtype) ->
{number: reading}`` (the reference against the kept outputs; a ``dtype``
other than float32 puts the reference computed in that precision in the
program's place: the control). A metric
reader has ``read(run) -> float | None``; None leaves the metric out. A
roofline reader has ``matches(kernel_name) -> bool`` and ``least_bytes(run,
launches) -> bytes`` of those launches.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Optional

import torch

#: HBM bandwidth of one H100 SXM (NVIDIA's data sheet), bytes/s
PEAK_BYTES_PER_S = 3.35e12
#: seconds the traced stretch of a --trace 1 run aims at, and its call bounds
TRACE_SECONDS = 1.5
TRACE_CALLS = (3, 400)
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "ptre_tpu")


def derive(seed: int, *parts: int) -> int:
    """A 63-bit seed from a run's seed and integers (splitmix64 chained)."""
    x = int(seed) & 0xFFFFFFFFFFFFFFFF
    for p in (0x5EED,) + parts:
        x = (x ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x >> 1


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no such file")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    """One run of one cell: what the loop, the readers and the checks see."""

    root: str
    spec: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    setup_s: float = 0.0
    spans: list = dataclasses.field(default_factory=list)  # (start, end) a call
    window_begin: float = 0.0
    window_s: float = 0.0
    rays_per_call: int = 0
    window_peak_bytes: int = 0
    memory_peak_bytes: int = 0
    profile: Optional[object] = None
    check_s: float = 0.0

    @property
    def calls(self) -> int:
        return len(self.spans)

    def derive(self, *parts: int) -> int:
        return derive(self.seed, *parts)

    def mean_call_ms(self) -> float:
        return 1e3 * statistics.fmean(b - a for a, b in self.spans)

    def pixels(self, count: int):
        """``count`` pixel numbers (row-major) drawn from the seed, sorted."""
        n = int(self.config["width"]) * int(self.config["height"])
        g = torch.Generator().manual_seed(self.derive(5))
        return torch.sort(torch.randperm(n, generator=g)[:min(count, n)]).values

    def return_intervals_s(self):
        """Seconds from the window's start to the first return, then between
        successive returns."""
        ends = [self.window_begin] + [b for _, b in self.spans]
        return [b - a for a, b in zip(ends, ends[1:])]


def find(root: str, workload: str):
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json"))
    return spec, cell, config, traffic


def metrics_of(spec: dict, cell: dict, kind: str):
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell reports:
    those that list it, and those that list no cell (a per-layer metric
    then goes with every cell that reports the end-to-end metric it moves)."""
    def cells(m):
        if "workloads" in m:
            return m["workloads"]
        if kind == "per_layer":
            moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
            return moved.get("workloads", [cell["name"]])
        return [cell["name"]]
    return [m for m in spec[kind] if cell["name"] in cells(m)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
            process_start: float, overrides: Optional[dict] = None):
    """Set up one cell, run its measured window (and with ``trace`` a traced
    stretch after it) and free the program's state: (run, loop, kept
    outputs). ``overrides`` replace keys of the configuration (tests run
    cells at a tiny size on the CPU)."""
    spec, cell, config, traffic = find(root, workload)
    config = {**config, **(overrides or {})}
    run = Run(root=root, spec=spec, cell=cell, config=config, traffic=traffic, seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=torch.device(device))
    name = traffic["loop"]
    loop = load_module(os.path.join(root, "benchmark", "loops", name + ".py"),
                       f"benchmark_loop_{name}")
    state = loop.setup(run)
    run.rays_per_call = loop.rays(state)
    _sync(run.device)
    cuda = run.device.type == "cuda"
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)

    # ---- the measured window: closed loop, ends in a synchronize ----------
    run.window_begin = time.perf_counter()
    run.setup_s = time.time() - process_start
    end = run.window_begin + run.seconds
    i, now = 0, run.window_begin
    while now < end:
        t0 = time.perf_counter()
        loop.call(state, i)
        now = time.perf_counter()
        run.spans.append((t0, now))
        i += 1
    _sync(run.device)
    run.window_s = time.perf_counter() - run.window_begin
    if cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated(run.device)
        run.memory_peak_bytes = max(setup_peak, run.window_peak_bytes)
    kept = loop.outputs(state)

    if run.trace:
        per_call = run.window_s / run.calls
        count = int(min(max(TRACE_SECONDS / per_call, TRACE_CALLS[0]), TRACE_CALLS[1]))
        from benchmark import devtrace
        run.profile = devtrace.trace_calls(lambda k: loop.call(state, run.calls + k), count)

    del state
    if cuda:
        torch.cuda.empty_cache()
    return run, loop, kept


def result_of(run: Run, loop, kept) -> dict:
    """The contract's result of a measured run: the reference's comparison
    (after the program's state is freed), the cell's metrics, the device."""
    t0 = time.time()
    comparisons = compare(run.root, run.cell["name"], loop.check(run, kept, torch.float32))
    run.check_s = time.time() - t0
    result = {
        "correct": all(c["value"] <= c["limit"] for c in comparisons.values()),
        "attempted": run.calls,
        "failed": 0,
        "metrics": read_metrics(run, "per_layer" if run.trace else "end_to_end"),
        "device": device_entry(run),
    }
    if run.trace and run.profile is not None and run.profile.device:
        result["breakdown"] = run.profile.breakdown()
    result["checks"] = comparisons
    return result


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             process_start: float, overrides: Optional[dict] = None):
    """`measure` and `result_of` one cell: (result, run)."""
    run, loop, kept = measure(root, workload, seed, seconds, trace, device, process_start,
                              overrides)
    return result_of(run, loop, kept), run


def compare(root: str, workload: str, readings: dict) -> dict:
    """Each reading beside its limit from ``checks/<workload>.json``; a
    reading without a limit there is an error: every number compared has
    one."""
    limits = _json(os.path.join(root, "benchmark", "checks", workload + ".json"))["limits"]
    missing = sorted(set(readings) ^ set(limits))
    if missing:
        raise KeyError(f"checks/{workload}.json and the loop's readings differ in {missing}")
    return {k: {"value": float(v), "limit": float(limits[k]["limit"])}
            for k, v in readings.items()}


def read_metrics(run: Run, kind: str) -> dict:
    out = {}
    for m in metrics_of(run.spec, run.cell, kind):
        value = read_metric(run, m["name"])
        if value is None:
            continue
        if isinstance(value, float) and not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def read_metric(run: Run, name: str):
    base = os.path.join(run.root, "benchmark")
    if name.endswith("_roofline"):
        kernel = name[: -len("_roofline")]
        mod = load_module(os.path.join(base, "rooflines", kernel + ".py"),
                          f"benchmark_roofline_{kernel}")
        return roofline_share(run, mod)
    mod = load_module(os.path.join(base, "metrics", name + ".py"),
                      "benchmark_metric_" + name.replace(".", "_"))
    return mod.read(run)


def roofline_share(run: Run, mod) -> Optional[float]:
    """Percent of the kernel's traced device time that its least time, by
    the bytes ``mod.least_bytes`` counts at `PEAK_BYTES_PER_S`, would take;
    None where the trace holds no launch of it."""
    if run.profile is None:
        return None
    launches, seconds = run.profile.kernel(mod.matches)
    if launches == 0 or seconds <= 0.0:
        return None
    return 100.0 * mod.least_bytes(run, launches) / PEAK_BYTES_PER_S / seconds


def device_entry(run: Run) -> dict:
    if run.device.type == "cuda":
        entry = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device), "count": 1,
                 "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        entry = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace and run.profile is not None:
        entry["busy_s"] = run.profile.busy_s
        entry["window_s"] = run.profile.wall_s
    return entry


def forbidden_modules():
    """Loaded modules whose top-level name is one that no run may load."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def card_name_and_power_limit():
    """(name, power limit) of the first card from ``nvidia-smi``, or None."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        return None
    name, _, limit = out.stdout.strip().splitlines()[0].rpartition(",")
    return name.strip(), limit.strip()
