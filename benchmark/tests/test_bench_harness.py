"""The harness on the CPU at a tiny size: cells found by name (a new
configuration, traffic mix, cell and metric are new files and entries only),
and the comparison that decides ``correct`` refusing the control and each
fault a cell can have, planted in the program under the timed path."""

import copy
import json
import os
import shutil
import time

import pytest
import torch

from benchmark import faults, harness, program

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 4321

#: cells whose files are under benchmark/ but which BENCHMARK.json holds back:
#: their host-paced runs spread past what a bound may hold (PERF.md, section 7)
HELD_BACK = {
    "configs": [{"name": "ioniq_demo", "file": "benchmark/configs/ioniq_demo.json",
                 "source": "upstream demo scene", "reduced": [], "why": "held back"}],
    "workloads": [{"name": "ioniq_demo.frames", "config": "ioniq_demo",
                   "traffic": "frames_1spp", "chips": 1, "why": "held back"},
                  {"name": "ioniq_demo.train", "config": "ioniq_demo",
                   "traffic": "train_4spp", "chips": 1, "why": "held back"}],
    "end_to_end": [{"name": "frame_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["ioniq_demo.frames"]}],
    "metric_cells": {"render_mrays_s": ["ioniq_demo.frames"],
                     "train_mrays_s": ["ioniq_demo.train"],
                     "train_peak_gib": ["ioniq_demo.train"]},
}


def copy_tree(root: str) -> dict:
    """BENCHMARK.json and benchmark/ copied under ``root``; the spec."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def write_spec(root: str, spec: dict):
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark whose BENCHMARK.json also holds the held-back
    cells, added as entries only."""
    path = str(tmp_path_factory.mktemp("bench"))
    spec = copy_tree(path)
    for key in ("configs", "workloads", "end_to_end"):
        spec[key] += copy.deepcopy(HELD_BACK[key])
    for m in spec["end_to_end"]:
        m.get("workloads", []).extend(HELD_BACK["metric_cells"].get(m["name"], []))
    write_spec(path, spec)
    return path


def small(root: str, workload: str) -> dict:
    """Configuration keys that shrink a cell to 24x16 (and the mixed scene's
    triangle sphere to 264 rows: still the wavefront route)."""
    _, cell, config, _ = harness.find(root, workload)
    out = {"width": 24, "height": 16}
    if cell["config"] == "mixed_mesh":
        out["meshes"] = {**config["meshes"],
                         "ball": {**config["meshes"]["ball"], "segments": 12, "rings": 6}}
    return out


def run(root, workload):
    return harness.run_cell(root, workload, SEED, 0.3, False, "cpu", time.time(),
                            overrides=small(root, workload))[0]


CELLS = ([c["name"] for c in harness.find(ROOT, "mixed_mesh.train")[0]["workloads"]]
         + [c["name"] for c in HELD_BACK["workloads"]])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(root, workload):
    result = run(root, workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in harness.metrics_of(*harness.find(root, workload)[:2],
                                                   "end_to_end")}
    if "train_peak_gib" in names:  # an allocator reading: the card's alone
        names.discard("train_peak_gib")
    assert set(result["metrics"]) == names


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(root, workload):
    r, loop, kept = harness.measure(root, workload, SEED, 0.3, False, "cpu", time.time(),
                                    overrides=small(root, workload))
    checks = harness.compare(root, workload, loop.check(r, kept, torch.bfloat16))
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


# ---- faults planted in the program under the timed path ----------------------------

@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(root, workload, fault, monkeypatch):
    monkeypatch.setattr(program, *faults.plant(harness.find(root, workload)[3]["loop"], fault))
    result = run(root, workload)
    assert not result["correct"], result["checks"]


# ---- a cell, a mix, a configuration and a metric added as files only ---------------

def only_added(old, new) -> bool:
    """Whether ``new`` holds all of ``old``: lists may grow at their end,
    objects may gain keys, nothing else changes."""
    if isinstance(old, dict):
        return isinstance(new, dict) and all(k in new and only_added(v, new[k])
                                             for k, v in old.items())
    if isinstance(old, list):
        return (isinstance(new, list) and len(new) >= len(old)
                and all(only_added(o, n) for o, n in zip(old, new)))
    return old == new


def test_new_cell_is_files_and_entries_only(tmp_path):
    root = str(tmp_path)
    spec = copy_tree(root)
    bench = os.path.join(root, "benchmark")

    def write(rel, obj):
        with open(os.path.join(bench, rel), "w") as f:
            f.write(obj if isinstance(obj, str) else json.dumps(obj))

    with open(os.path.join(bench, "configs", "ioniq_demo.json")) as f:
        config = json.load(f)
    config.update(name="tiny_demo", width=20, height=12)
    write("configs/tiny_demo.json", config)
    write("traffic/train_1spp.json", {"loop": "train", "spp": 1, "remat_bounces": True,
                                      "warmup_steps": 1, "check_steps": 1, "block_rows": 4})
    write("checks/tiny_demo.train_1spp.json",
          {"limits": {k: {"limit": 1e-3} for k in ("loss_rel", "grad_norm_gap", "grad_diff")}})
    write("metrics/steps.tiny.py", "def read(run):\n    return float(run.calls)\n")

    before = copy.deepcopy(spec)
    spec["configs"].append({"name": "tiny_demo", "source": "test", "reduced": [], "why": "test",
                            "file": "benchmark/configs/tiny_demo.json"})
    spec["workloads"].append({"name": "tiny_demo.train_1spp", "config": "tiny_demo",
                              "traffic": "train_1spp", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps.tiny", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "Training step", "moves":
                              "train_mrays_s", "workloads": ["tiny_demo.train_1spp"]})
    next(m for m in spec["end_to_end"] if m["name"] == "train_mrays_s")["workloads"].append(
        "tiny_demo.train_1spp")
    assert only_added(before, spec)
    write_spec(root, spec)

    plain = harness.run_cell(root, "tiny_demo.train_1spp", SEED, 0.3, False, "cpu", time.time())[0]
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"train_mrays_s", "setup_s"}
    traced = harness.run_cell(root, "tiny_demo.train_1spp", SEED, 0.3, True, "cpu", time.time())[0]
    assert traced["metrics"]["steps.tiny"]["value"] >= 1.0
    assert "train_step.host_ms" not in traced["metrics"]  # its cells are listed
