"""The per-layer metrics that read the program's spans (`benchmark/spans.py`),
each cell at 24x16 on the CPU, traced: every one reads a finite number above
0 in its cell, and None on a trace that holds no ``ptre.*`` event (a program
without spans, as the parent of the spans had)."""

import dataclasses
import math
import os
import time

import pytest

from benchmark import harness, spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 8765

#: the metrics that read spans, by the cell that reports them
SPAN_METRICS = {
    "mixed_mesh.render": ("render_step.pack_ms", "wave_wait.render"),
    "mixed_mesh.train": ("wave_wait.train", "train_step.forward_ms", "train_step.backward_ms",
                         "train_step.recompute_ms"),
}


def small(workload: str) -> dict:
    """Configuration keys that shrink a cell to 24x16 (the mixed scene's
    triangle sphere to 264 rows: still the wavefront route)."""
    config = harness.find(ROOT, workload)[2]
    return {"width": 24, "height": 16,
            "meshes": {**config["meshes"],
                       "ball": {**config["meshes"]["ball"], "segments": 12, "rings": 6}}}


@pytest.fixture(scope="module", params=sorted(SPAN_METRICS))
def traced(request):
    workload = request.param
    run, _, _ = harness.measure(ROOT, workload, SEED, 0.3, True, "cpu", time.time(),
                                overrides=small(workload))
    return workload, run


def test_span_metrics_read_above_zero(traced):
    workload, run = traced
    spec, cell = harness.find(ROOT, workload)[:2]
    listed = {m["name"] for m in harness.metrics_of(spec, cell, "per_layer")}
    assert set(SPAN_METRICS[workload]) <= listed
    out = harness.read_metrics(run, "per_layer")
    for name in SPAN_METRICS[workload]:
        value = out[name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
        assert out[name]["unit"] == "ms"


def test_span_metrics_read_none_without_spans(traced):
    workload, run = traced
    host = [e for e in run.profile.host if not e[0].startswith("ptre.")]
    assert len(host) < len(run.profile.host)
    bare = dataclasses.replace(run, profile=dataclasses.replace(run.profile, host=host))
    for name in SPAN_METRICS[workload]:
        assert harness.read_metric(bare, name) is None, name
    assert harness.read_metric(dataclasses.replace(run, profile=None),
                               SPAN_METRICS[workload][0]) is None


@pytest.mark.parametrize("traced", ["mixed_mesh.train"], indirect=True)
def test_recompute_lies_inside_the_backward(traced):
    workload, run = traced
    calls = run.profile.calls
    samples = spans.starting_inside(spans.intervals(run, "ptre.train.sample"),
                                    run.profile.ranges)
    inside = spans.starting_inside(samples, spans.intervals(run, "ptre.train.backward"))
    spp = int(run.traffic["spp"])
    # every sample once in the forward and once more in the backward's recompute
    assert len(samples) == 2 * spp * calls and len(inside) == spp * calls
    backward = spans.ms_per_call(run, "ptre.train.backward")
    assert 0 < spans.ms_per_call(run, "ptre.train.sample", within="ptre.train.backward") \
        <= backward


def test_starting_inside_counts_by_start():
    ranges = [(0.0, 1.0), (2.0, 3.0)]
    got = spans.starting_inside([(-0.5, 0.5), (0.5, 2.5), (1.5, 1.8), (3.0, 4.0)], ranges)
    assert got == [(0.5, 2.5), (3.0, 4.0)]
