"""The Trainer's media reports and the profiling hooks of the port
(ddsp_pytorch_tpu_torch/training/reports.py, metrics.py, profiling.py,
utils/plots.py) against the JAX package, on the CPU at a tiny width.

Validation and the per-log-epoch eval write the first item's target and
reconstruction as audio/<tag>_<step>.wav, always, and the reconstruction
figure as figures/<tag>_<step>.png where matplotlib imports.  stft_to_mel
equals the JAX op within 1e-5 of its peak (float32 products in two
orders).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops.spectral import stft_to_mel as jax_stft_to_mel
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.ops.spectral import multiscale_fft, stft_to_mel
from ddsp_pytorch_tpu_torch.training import Trainer, profiling
from ddsp_pytorch_tpu_torch.training import train as train_module
from ddsp_pytorch_tpu_torch.training.metrics import MetricsWriter
from ddsp_pytorch_tpu_torch.utils.audio_io import pcm16, read_wav

MEL_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("reports") / "cache")
    make_synthetic_dataset(out, n_items=4, sample_rate=16000, signal_length=8192, block_size=256,
                           n_harmonic=8, device="cpu")
    return out


def _fit(cache, run_dir, steps=4):
    cfg = Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 8192, "block_size": 256, "out_dir": cache},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 32, "n_harmonic": 8, "n_bands": 17, "sample_rate": 16000, "block_size": 256,
            "has_reverb": True}},
        "train": {"scales": [512, 256], "batch": 2, "steps": steps, "val_interval_epochs": 2,
                  "log_interval_epochs": 2, "checkpoint_every_steps": 0},
    })
    datamodule = Datamodule(cfg, device="cpu")
    datamodule.setup()
    trainer = Trainer(cfg, run_dir, device="cpu", use_tensorboard=False)
    try:
        trainer.fit(datamodule)
    finally:
        trainer.close()
    return cfg, datamodule


def _names(run_dir, sub):
    path = os.path.join(run_dir, sub)
    return sorted(os.listdir(path)) if os.path.exists(path) else []


def test_reports_write_wavs_and_figures(cache, tmp_path):
    pytest.importorskip("matplotlib")
    run_dir = str(tmp_path / "run")
    cfg, datamodule = _fit(cache, run_dir)
    # 2 steps an epoch: validation and the log eval at epochs 0 (step 2)
    assert _names(run_dir, "audio") == ["rec_train_2.wav", "rec_val_2.wav", "sig_train_2.wav", "sig_val_2.wav"]
    assert _names(run_dir, "figures") == ["reconstruction_train_2.png", "reconstruction_val_2.png"]
    for name in _names(run_dir, "figures"):
        with open(os.path.join(run_dir, "figures", name), "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    # the validation target wav is the last validation batch's first item
    last = list(datamodule.val_dataloader())[-1]
    data, sr = read_wav(os.path.join(run_dir, "audio", "sig_val_2.wav"))
    assert sr == 16000
    np.testing.assert_array_equal(data, pcm16(last["sig"][0]))
    rec, _ = read_wav(os.path.join(run_dir, "audio", "rec_val_2.wav"))
    assert rec.shape == data.shape and np.any(rec != 0)


def test_reports_without_matplotlib_write_the_wavs(cache, tmp_path, monkeypatch):
    def no_matplotlib():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(train_module, "pyplot", no_matplotlib)
    run_dir = str(tmp_path / "run")
    _fit(cache, run_dir)
    assert _names(run_dir, "audio") == ["rec_train_2.wav", "rec_val_2.wav", "sig_train_2.wav", "sig_val_2.wav"]
    assert _names(run_dir, "figures") == []


def test_eval_step_carries_the_spectrograms_and_audio(cache, tmp_path):
    cfg, datamodule = _fit(cache, str(tmp_path / "run"), steps=2)
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu", use_tensorboard=False)
    state, resumed = trainer.resume_or_init()
    assert resumed
    batch = next(iter(datamodule.val_dataloader()))
    out = trainer._eval(state, batch, 0)
    trainer.close()
    sig = torch.tensor(batch["sig"])
    torch.testing.assert_close(out["sig"], sig, rtol=0, atol=0)
    torch.testing.assert_close(out["rec"], out["signal"], rtol=0, atol=0)
    for got, want in zip(out["sig_stft"], multiscale_fft(sig, [512, 256], 0.75)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(out["rec_stft"]) == 2


def test_metrics_writer_media_names(tmp_path):
    writer = MetricsWriter(str(tmp_path))
    path = writer.add_audio("sig/val", torch.full((1, 300), 0.25), 7, 16000)
    writer.close()
    assert path == os.path.join(str(tmp_path), "audio", "sig_val_7.wav")
    data, sr = read_wav(path)
    assert sr == 16000 and data.shape == (300,)


def test_stft_to_mel_matches_jax():
    mag = np.abs(np.random.default_rng(0).standard_normal((2, 257, 20))).astype(np.float32)
    got = stft_to_mel(torch.tensor(mag), 16000, 512).numpy()
    want = np.asarray(jax_stft_to_mel(jnp.asarray(mag), 16000, 512))
    assert got.shape == want.shape == (2, 128, 20)
    assert np.max(np.abs(got - want)) <= MEL_REL * np.max(np.abs(want))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace"), "cpu"):
        with profiling.annotate("ddsp_region"):
            torch.fft.rfft(torch.ones(1024)).abs().sum()
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "ddsp_region" in names
    assert any(str(n).startswith("aten::") for n in names)
