"""MetricsWriter's optional TensorBoard sink (training/metrics.py, the JAX
writer's ddsp_pytorch_tpu/training/metrics.py:34-86) on the CPU: with the
sink on, scalars, audio and figures reach event files that TensorBoard's
EventAccumulator reads back; with torch.utils.tensorboard failing to
import, the sink is off and the run directory holds what it holds without
it; the Trainer mirrors its metrics and closes the writer's thread when
`fit` returns."""

import json
import os
import sys
import threading

import pytest
import torch

from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.training.metrics import MetricsWriter, read_metrics

event_accumulator = pytest.importorskip(
    "tensorboard.backend.event_processing.event_accumulator",
    reason="the tensorboard package reads the event files back")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(run_dir: str):
    acc = event_accumulator.EventAccumulator(run_dir, size_guidance={"scalars": 0, "audio": 0, "images": 0})
    acc.Reload()
    return acc


def _event_files(run_dir: str) -> list:
    return sorted(f for f in os.listdir(run_dir) if f.startswith("events.out.tfevents"))


def _write(writer: MetricsWriter) -> None:
    for step, value in enumerate([3.5, 2.25, 1.125]):
        writer.add_scalar("loss", value, step)
    writer.add_scalar("val/loss", 4.0, 2)
    writer.add_audio("rec/val", torch.linspace(-0.5, 0.5, 800), 2, 8000)


def test_scalars_and_audio_read_back(tmp_path):
    run = str(tmp_path / "run")
    writer = MetricsWriter(run)
    assert writer.tensorboard
    _write(writer)
    writer.close()
    writer.close()  # idempotent
    acc = _events(run)
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(0, 3.5), (1, 2.25), (2, 1.125)]
    assert [(e.step, e.value) for e in acc.Scalars("val/loss")] == [(2, 4.0)]
    assert [e.step for e in acc.Audio("rec/val")] == [2]
    assert read_metrics(run, "loss") == [(0, 3.5), (1, 2.25), (2, 1.125)]
    assert os.path.exists(os.path.join(run, "audio", "rec_val_2.wav"))


def test_figure_reads_back(tmp_path):
    plt = pytest.importorskip("matplotlib.pyplot", reason="a figure needs matplotlib")
    run = str(tmp_path / "run")
    writer = MetricsWriter(run)
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    writer.add_figure("reconstruction/val", fig, 5)
    plt.close(fig)
    writer.close()
    assert [e.step for e in _events(run).Images("reconstruction/val")] == [5]
    assert os.path.exists(os.path.join(run, "figures", "reconstruction_val_5.png"))


def test_writes_after_end_tensorboard_open_a_new_event_file(tmp_path):
    run = str(tmp_path / "run")
    writer = MetricsWriter(run)
    writer.add_scalar("loss", 1.0, 0)
    writer.end_tensorboard()
    writer.add_scalar("loss", 0.5, 1)
    writer.close()
    assert len(_event_files(run)) == 2
    assert [(e.step, e.value) for e in _events(run).Scalars("loss")] == [(0, 1.0), (1, 0.5)]


def _jsonl_without_times(run: str) -> list:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


@pytest.mark.parametrize("how", ["flag", "no-import"])
def test_sink_off_leaves_only_the_jsonl_and_media(tmp_path, monkeypatch, how):
    """use_tensorboard=False, or torch.utils.tensorboard failing to import:
    no event file, and metrics.jsonl and the wavs as with the sink on."""
    on = str(tmp_path / "on")
    writer = MetricsWriter(on)
    _write(writer)
    writer.close()

    off = str(tmp_path / "off")
    if how == "no-import":
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        writer = MetricsWriter(off)
    else:
        writer = MetricsWriter(off, use_tensorboard=False)
    assert not writer.tensorboard
    _write(writer)
    writer.close()
    assert sorted(os.listdir(off)) == ["audio", "metrics.jsonl"]
    assert _jsonl_without_times(off) == _jsonl_without_times(on)
    with open(os.path.join(off, "audio", "rec_val_2.wav"), "rb") as a, \
            open(os.path.join(on, "audio", "rec_val_2.wav"), "rb") as b:
        assert a.read() == b.read()


def test_disabled_writer_opens_nothing(tmp_path):
    writer = MetricsWriter(str(tmp_path / "r1"), enabled=False)
    assert not writer.tensorboard
    writer.add_scalar("loss", 1.0, 0)
    writer.close()
    assert os.listdir(tmp_path / "r1") == []


def test_trainer_mirrors_its_metrics_and_closes_the_writer(tmp_path):
    cache = str(tmp_path / "cache")
    make_synthetic_dataset(cache, n_items=4, sample_rate=16000, signal_length=4096, block_size=256,
                           n_harmonic=4, device="cpu")
    cfg = Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 4096, "block_size": 256, "out_dir": cache},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 16, "n_harmonic": 4, "n_bands": 5, "sample_rate": 16000, "block_size": 256,
            "has_reverb": False}},
        "train": {"scales": [512, 256], "batch": 2, "steps": 3, "val_interval_epochs": 0}})
    dm = Datamodule(cfg, device="cpu")
    dm.setup()
    run = str(tmp_path / "run")
    before = set(threading.enumerate())
    trainer = Trainer(cfg, run, device="cpu")
    assert trainer.metrics.tensorboard
    trainer.fit(dm)
    assert trainer.metrics._tb is None  # fit closed the SummaryWriter
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]
    trainer.close()
    losses = read_metrics(run, "loss")
    assert len(losses) == 3
    got = [(e.step, e.value) for e in _events(run).Scalars("loss")]
    assert [s for s, _ in got] == [s for s, _ in losses]
    assert [v for _, v in got] == pytest.approx([v for _, v in losses], rel=1e-6)
