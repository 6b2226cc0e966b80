"""The port's sustained-run pipeline (ddsp_pytorch_tpu_torch/trainrun.py, the
port of scripts/trainrun_tpu.py) end to end on the CPU, at a small width
(hidden 64, 16 kHz, block 256, 8 harmonics, 17 bands, batch 2, a hybrid-
tracked fixture corpus of 2 + 1 notes), 4 steps in segments of 2 and 2 at
steps_per_call 2: prep, probe, the segmented children and the validation,
each in its own process.

Checked: the report's keys are TRAINRUN_r05.json's plus `card`, and each
per-segment row has that file's keys; segments.jsonl holds one
prime-stats row and two train rows, each exit 0; the losses and the
validation loss are finite; the written config equals, as a Config, the
one the JAX package's scripts/_workload.py gives with the same knobs and
overrides (its dict parsed by the JAX Config; the port imports no yaml).
"""

import importlib.util
import json
import math
import os

import pytest
import torch

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu_torch import trainrun
from ddsp_pytorch_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ["preprocess.sample_rate=16000", "preprocess.signal_length=8192", "preprocess.block_size=256",
        "model.kwargs.sample_rate=16000", "model.kwargs.block_size=256", "model.kwargs.hidden_size=64",
        "model.kwargs.n_harmonic=8", "model.kwargs.n_bands=17", "train.scales=[512, 256]", "train.batch=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainrun")
    out = str(root / "trainrun.json")
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # every child at one thread
    try:
        report = trainrun.main(["--device", "cpu", "--steps", "4", "--segment-schedule", "2,2",
                                "--steps-per-call", "2", "--n-train", "2", "--n-validation", "1",
                                "--root", str(root), "--out", out, *[a for kv in SETS for a in ("--set", kv)]])
    finally:
        mp.undo()
    return str(root), out, report


def test_report_keys_are_the_tpu_artifacts_plus_the_card(run):
    _, out, report = run
    with open(os.path.join(REPO, "TRAINRUN_r05.json")) as f:
        tpu = json.load(f)
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(report))
    assert set(report) == set(tpu) | {"card"}
    assert report["card"] is None and report["platform"]["platform"] == "cpu"
    assert len(report["per_segment"]) == 2
    for row in report["per_segment"]:
        assert set(tpu["per_segment"][0]) <= set(row)
        assert row["steps"] == 2 and row["steps_per_s_wall"] > 0 and row["steps_per_s_train_window"] > 0
    assert report["total_steps"] == report["target_steps"] == 4
    assert report["n_train_segments"] == 2 and report["segment_steps"] == "2,2"
    assert math.isfinite(report["loss_first10_mean"]) and math.isfinite(report["loss_last100_mean"])
    assert math.isfinite(report["final_val_loss"])
    assert [p["step"] for p in report["loss_curve"]] == [1, 2, 3, 4]


def test_segments_are_a_prime_and_two_train_children(run):
    root, _, _ = run
    with open(os.path.join(root, "runs", trainrun.RUN_NAME, "segments.jsonl")) as f:
        segs = [json.loads(line) for line in f]
    assert [(s["label"], s["to_step"], s["returncode"]) for s in segs] == [
        ("prime-stats", 0, 0), ("train", 2, 0), ("train", 4, 0)]


def test_written_config_is_the_jax_workload(run):
    root, _, _ = run
    spec = importlib.util.spec_from_file_location("_jax_workload", os.path.join(REPO, "scripts", "_workload.py"))
    workload = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(workload)
    raw = workload.reference_workload_config(
        os.path.join(root, "corpus"), os.path.join(root, "cache"), preprocess={"pitch_tracker": "hybrid"},
        train={"steps": 4, "steps_per_call": 2, "scan_unroll": 1})
    want = JaxConfig.from_dict(raw).apply_overrides(SETS).to_dict()
    got = Config.from_yaml(os.path.join(root, "trainrun.yaml")).to_dict()
    assert got == want


def test_needs_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trainrun.main(["--steps", "2", "--root", str(tmp_path), "--out", str(tmp_path / "r.json")])
    assert not os.listdir(tmp_path)  # nothing made, no child started
