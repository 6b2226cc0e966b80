"""Finds a cell's files by the names in BENCHMARK.json and runs it.

  benchmark/configs/<config>.json     the configuration as it is run
  benchmark/workloads/<cell>.json     the cell's kind, traffic parameters
                                      and correctness limits
  benchmark/kinds/<kind>.py           the general driver of that kind
  benchmark/metrics/<metric>.py       one per-layer metric's reader:
                                      read(run) → a number, or None where
                                      the run holds nothing to read

A later cell, configuration or metric is new files and new entries in
BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ddsp_pytorch_tpu")


@dataclass
class Run:
    """What a kind's run hands back: end-to-end values, the counts, the
    checks behind `correct`, and what the per-layer readers read."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, List[float]]  # name → [value, limit]
    memory_peak_bytes: int
    info: Dict[str, object] = field(default_factory=dict)  # printed on stderr
    trace: Optional[object] = None  # lib.trace.Trace of the traced window
    layer: Dict[str, object] = field(default_factory=dict)  # for the metric readers
    cfg: Dict[str, object] = field(default_factory=dict)
    params: Dict[str, object] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(spec: dict, name: str, bench_dir: str = HERE):
    """(BENCHMARK.json entry, configuration, cell file) of cell `name`."""
    entry = cell_entry(spec, name)
    cfg = load_json(os.path.join(bench_dir, "configs", entry["config"] + ".json"))
    cell = load_json(os.path.join(bench_dir, "workloads", name + ".json"))
    if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json does not match its BENCHMARK.json entry")
    return entry, cfg, cell


def load_kind(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def metrics_for(spec: dict, name: str, section: str) -> List[dict]:
    """The cell's metrics of `section`: those that list it, and those that
    list no cells (per-layer ones then follow the end-to-end metric they
    move)."""
    e2e_here = {m["name"] for m in spec["end_to_end"]
                if "workloads" not in m or name in m["workloads"]}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def read_metric(metric: str, run: Run, bench_dir: str = HERE):
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool, device,
             mono_start: float, bench_dir: str = HERE, overrides: Optional[dict] = None) -> Run:
    entry, cfg, cell = load_cell(spec, name, bench_dir)
    params = dict(cell["params"], **(overrides or {}))
    run = load_kind(cell["kind"]).run(cfg=cfg, params=params, limits=cell["limits"], seed=seed,
                                      seconds=seconds, trace=trace, device=device,
                                      mono_start=mono_start)
    run.cfg, run.params = cfg, params
    return run


def result_line(spec: dict, name: str, run: Run, trace: bool, device_kind: str,
                bench_dir: str = HERE) -> dict:
    """The JSON object a run prints last, `checks` its last key."""
    metrics = {}
    if trace:
        for m in metrics_for(spec, name, "per_layer"):
            value = read_metric(m["name"], run, bench_dir)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in metrics_for(spec, name, "end_to_end"):
            metrics[m["name"]] = {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": 1,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def forbidden_loaded(modules) -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the last)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN_MODULES))
