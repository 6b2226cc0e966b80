"""A tiny configuration and a throwaway benchmark folder, for the CPU tests."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.harness import HERE, benchmark_spec

TRAIN_LIMITS = {"loss_gap": 1e-2, "update_gap": 0.25}  # float32 at a toy width
SERVE_LIMITS = {"audio_rms_gap": 1e-3}


def tiny_cfg(model: str) -> dict:
    return {
        "name": "tiny-" + model, "source": "test",
        "model": {"name": model, "hidden_size": 16, "n_harmonic": 8, "n_bands": 17,
                  "sample_rate": 16000, "block_size": 256, "has_reverb": True},
        "preprocess": {"sample_rate": 16000, "signal_length": 8192, "block_size": 256, "n_mfcc": 30,
                       "mfcc_n_fft": 512, "mfcc_fmin": 20.0, "mfcc_fmax": 8000.0, "n_mels": 128,
                       "mfcc_ref_db": 0.0},
        "train": {"scales": [512, 256], "overlap": 0.75, "batch": 2, "lr": 1e-3, "optimizer": "adam"},
        "assumed": {"steps_per_call": 4, "scan_unroll": 1},
    }


def serve_params(sessions: int, compared: int = 2) -> dict:
    return {"glide_s": 64.0, "drain_s": 10.0, "trace_s": 0.5, "mean_loudness": -32.5,
            "std_loudness": 10.0, "warm_blocks": 3, "compared_sessions": compared,
            "sessions": sessions}


def bench_dir(root: str, kind: str, model: str, params: dict, limits: dict, cell: str = "tiny.cell"):
    """A benchmark folder under `root` holding one new configuration and one
    new cell, with the real metric readers; returns (folder, spec)."""
    os.makedirs(os.path.join(root, "configs"))
    os.makedirs(os.path.join(root, "workloads"))
    shutil.copytree(os.path.join(HERE, "metrics"), os.path.join(root, "metrics"))
    cfg = tiny_cfg(model)
    with open(os.path.join(root, "configs", cfg["name"] + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "workloads", cell + ".json"), "w") as f:
        json.dump({"config": cfg["name"], "traffic": "tiny", "kind": kind, "params": params,
                   "limits": limits}, f)
    spec = benchmark_spec()
    spec["workloads"] = [{"name": cell, "config": cfg["name"], "traffic": "tiny", "chips": 1, "why": "test"}]
    if kind == "serve":  # the served metrics, as a served cell's entries would give them
        spec["end_to_end"] += [{"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": []}
                               for n in ("block_p50_ms", "block_p99_ms")]
    e2e = ("train_step_ms",) if kind == "train" else ("block_p50_ms", "block_p99_ms")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell] if m["name"] in e2e or m.get("moves") in e2e else []
    return root, spec
