"""The harness finds a cell, its configuration, its kind and a per-layer
metric from files it has never seen, and a run of it, driven on the CPU
with the card's check skipped, ends correct with the contract's keys."""

import json
import os
import time

import torch

from benchmark import harness
from benchmark.tests.tiny import TRAIN_LIMITS, bench_dir


def test_a_new_cell_configuration_and_metric_are_found_by_name(tmp_path):
    d, spec = bench_dir(str(tmp_path / "b"), "train", "single-inst-decoder", {"corpus_items": 6, "settle_s": 0.0},
                        TRAIN_LIMITS, cell="new.cell")
    with open(os.path.join(d, "metrics", "new.metric.py"), "w") as f:
        f.write("def read(run):\n    return run.layer['rows'] * 2\n")
    spec["per_layer"].append({"name": "new.metric", "unit": "rows", "better": "higher",
                              "source": "program_counter", "layer": "trainer",
                              "moves": "train_step_ms", "workloads": ["new.cell"]})
    run = harness.run_cell(spec, "new.cell", 2**31 + 12345, 1.0, True, torch.device("cpu"),
                           time.monotonic(), bench_dir=d)
    assert run.correct, run.checks
    line = harness.result_line(spec, "new.cell", run, True, "cpu", bench_dir=d)
    assert line["metrics"]["new.metric"] == {"value": 2.0 * 2 * 32, "unit": "rows"}
    assert list(line)[-1] == "checks" and {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    json.dumps(line)
    plain = harness.result_line(spec, "new.cell", run, False, "cpu", bench_dir=d)
    assert set(plain["metrics"]) == {"train_step_ms", "setup_s"}


def test_metrics_for_follows_workloads_and_moves():
    spec = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "s"}],
            "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.metrics_for(spec, "x", "end_to_end")] == ["a", "s"]
    assert [m["name"] for m in harness.metrics_for(spec, "x", "per_layer")] == ["p"]
    assert [m["name"] for m in harness.metrics_for(spec, "y", "per_layer")] == ["q"]
