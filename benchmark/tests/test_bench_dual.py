"""The dual cell (`dual_mesh.train`, BASELINE configuration 5) on the CPU at
24x16, the triangle sphere cut to 12x6: it runs and reads correct; the
bfloat16 control and each of `dual_faults`' faults read not correct; a
program whose dual step draws the analytic spheres with another model's
transform is refused at set-up. On the card, a traced run at the cell's
own size reads the four span metrics and both SoftRas rooflines above 0.
"""

import math
import os
import time

import pytest
import torch

from benchmark import dual_faults, harness, program_dual

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "dual_mesh.train"
SEED = 2**31 + 2468
SPAN_METRICS = ("dual_step.trace_ms", "dual_step.jitter_ms", "dual_step.raster_ms",
                "dual_step.backward_ms")
ROOFLINES = ("soft_fwd_roofline", "soft_bwd_roofline")


def small() -> dict:
    config = harness.find(ROOT, CELL)[2]
    return {"width": 24, "height": 16,
            "meshes": {**config["meshes"],
                       "ball": {**config["meshes"]["ball"], "segments": 12, "rings": 6}}}


def run():
    return harness.run_cell(ROOT, CELL, SEED, 0.3, False, "cpu", time.time(),
                            overrides=small())[0]


def test_cell_runs_and_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_mrays_s", "setup_s"}  # the peak: the card's
    assert result["metrics"]["train_mrays_s"]["value"] > 0


def test_control_is_not_correct():
    r, loop, kept = harness.measure(ROOT, CELL, SEED, 0.3, False, "cpu", time.time(),
                                    overrides=small())
    checks = harness.compare(ROOT, CELL, loop.check(r, kept, torch.bfloat16))
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("fault", dual_faults.FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(program_dual, *dual_faults.plant("dual", fault))
    result = run()
    assert not result["correct"], result["checks"]


def test_a_program_that_draws_another_scene_is_refused(monkeypatch):
    monkeypatch.setattr(program_dual, "draws_each_model", lambda: False)
    with pytest.raises(RuntimeError, match="cannot run the dual configuration"):
        run()


@pytest.mark.cuda
def test_span_metrics_and_rooflines_read_above_zero_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the profiler's device trace at the cell's size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = harness.run_cell(ROOT, CELL, SEED, 3.0, True, torch.device("cuda", 0),
                              time.time())[0]
    assert result["correct"], result["checks"]
    for name in SPAN_METRICS + ROOFLINES:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    for name in ROOFLINES:
        assert result["metrics"][name]["value"] <= 100.0, name
