"""Metrics sink: an append-only `metrics.jsonl` in the run directory, one
{"tag", "value", "step", "time"} record per scalar — the JSON stream of
ddsp_pytorch_tpu/training/metrics.py:19-86.  TensorBoard, audio and figure
sinks wait (ROADMAP.md)."""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        record = {"tag": tag, "value": float(value), "step": int(step), "time": time.time()}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


def read_metrics(run_dir: str, tag: str):
    """[(step, value)] of every `tag` record in run_dir/metrics.jsonl."""
    out = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag:
                out.append((rec["step"], rec["value"]))
    return out
