"""Segmented and profiled runs of the port's training CLI
(ddsp_pytorch_tpu_torch/train.py --segment-steps, --segment-schedule,
--profile) on the CPU, at a tiny width.

A segmented run is a stats-priming child and one fresh child process a
segment, each resuming the checkpoint the one before it saved; its final
parameters, optimizer state, generator state and per-step losses equal an
unsegmented run's bit for bit (the CPU steps run the same arithmetic in
the same order).  The workload config the segmenter's callers write goes
through config.dump_yaml and reads back through config.load_yaml to the
same values.
"""

import json
import os

import pytest
import torch

from ddsp_pytorch_tpu_torch import train as train_cli
from ddsp_pytorch_tpu_torch.config import Config, dump_yaml, load_yaml
from ddsp_pytorch_tpu_torch.data import make_synthetic_dataset
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.workload import reference_workload_config

STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(config path, root) of a tiny decoder run on a synthetic cache."""
    root = tmp_path_factory.mktemp("seg")
    cache = str(root / "cache")
    make_synthetic_dataset(cache, n_items=4, sample_rate=16000, signal_length=8192, block_size=256,
                           n_harmonic=8, device="cpu")
    raw = reference_workload_config(str(root / "wavs"), cache,
                                    preprocess={"sample_rate": 16000, "signal_length": 8192, "block_size": 256},
                                    train={"scales": [512, 256], "batch": 2, "steps": STEPS, "steps_per_call": 2})
    raw["model"]["kwargs"].update(sample_rate=16000, block_size=256, hidden_size=32, n_harmonic=8, n_bands=17)
    path = str(root / "tiny.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    return path, str(root)


def _run(tiny, name, *extra):
    path, root = tiny
    return train_cli.main(["--config", path, "--root", os.path.join(root, "runs"), "--name", name,
                           "--device", "cpu", "--no-tensorboard", *extra])


def _final(run_dir):
    saved = torch.load(os.path.join(run_dir, "checkpoints", f"{STEPS}.pt"), weights_only=False)
    return saved, [v for _, v in read_metrics(run_dir, "loss")]


@pytest.fixture(scope="module")
def unsegmented(tiny):
    state = _run(tiny, "whole")
    assert state.step == STEPS
    return _final(os.path.join(tiny[1], "runs", "whole"))


def _assert_bitwise(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("flags, boundaries", [(["--segment-steps", "2"], [0, 2, 4]),
                                               (["--segment-schedule", "1,3"], [0, 1, 4])],
                         ids=["2+2", "schedule-1,3"])
def test_segmented_run_equals_unsegmented_bitwise(tiny, unsegmented, flags, boundaries):
    name = "seg_" + flags[1].replace(",", "_")
    assert _run(tiny, name, "--steps", str(STEPS), *flags) == STEPS
    run_dir = os.path.join(tiny[1], "runs", name)
    saved, losses = _final(run_dir)
    want_saved, want_losses = unsegmented
    assert losses == want_losses and len(losses) == STEPS
    _assert_bitwise(saved, want_saved)
    with open(os.path.join(run_dir, "segments.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [rec["to_step"] for rec in lines] == boundaries
    assert [rec["label"] for rec in lines] == ["prime-stats"] + ["train"] * (len(boundaries) - 1)
    assert all(rec["returncode"] == 0 and rec["total"] == STEPS and rec["wall_s"] > 0 for rec in lines)
    # the priming child froze the loudness stats into the run's config
    frozen = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    assert frozen.data.mean_loudness is not None and frozen.data.std_loudness is not None


def test_failing_child_stops_the_run(tiny):
    path, root = tiny
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--config", path, "--root", os.path.join(root, "runs"), "--name", "bad",
                        "--device", "cpu", "--segment-steps", "2", "--set", "model.name=no-such-model"])
    assert exc.value.code != 0
    with open(os.path.join(root, "runs", "bad", "segments.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["label"] == "prime-stats" and lines[0]["returncode"] != 0


def test_segment_arguments():
    argv = ["--config", "c.yaml", "--steps", "9", "--segment-steps", "3", "--segment-schedule=1,2",
            "--steps=4", "--device", "cpu"]
    assert train_cli.child_args(argv) == ["--config", "c.yaml", "--device", "cpu"]
    args = train_cli._parser().parse_args(["--segment-schedule", "5,0"])
    with pytest.raises(ValueError, match="positive"):
        train_cli.segment_schedule(args)
    args = train_cli._parser().parse_args(["--segment-steps", "3"])
    assert train_cli.segment_schedule(args) == [3]


def test_workload_config_round_trips_through_load_yaml(tmp_path):
    raw = reference_workload_config("/data/wavs", "/data/cache", train={"steps": 20000, "steps_per_call": 50})
    assert load_yaml(dump_yaml(raw)) == raw
    cfg = Config.from_dict(raw)
    cfg.to_yaml(str(tmp_path / "w.yaml"))
    assert Config.from_yaml(str(tmp_path / "w.yaml")).to_dict() == cfg.to_dict()
    assert cfg.train.steps == 20000 and cfg.train.batch == 16 and cfg.model.kwargs["hidden_size"] == 512
    assert cfg.train.metrics_flush_steps == 10**9 and cfg.train.val_interval_epochs == 0


def test_profile_writes_a_trace(tiny):
    _run(tiny, "profiled", "--steps", "2", "--profile")
    run_dir = os.path.join(tiny[1], "runs", "profiled")
    with open(os.path.join(run_dir, "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert len(read_metrics(run_dir, "loss")) == 2
