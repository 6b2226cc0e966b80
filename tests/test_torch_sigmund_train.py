"""The port's sigmund training path (ddsp_pytorch_tpu_torch/train_sigmund.py)
against scripts/train_sigmund.py's analyzer, scipy and the JAX ingestion,
on the CPU at a tiny size.

Tolerances:
  * `lop` (Pd's lop~ 1000): scipy.signal.lfilter with the script's zi
    within 1e-6 of the peak;
  * the float32 3-channel wav: byte for byte what scipy.io.wavfile.write
    writes, read back bit for bit by read_wav and by scipy;
  * the analyzer channels against the script's (JAX YIN and loudness per
    file, scipy's lop): audio bit for bit, pitch within 1e-4 relative
    (the two YINs' float32 CMNDFs), loudness within 1e-3 (two FFTs);
  * the cache preprocess_from_sigmund makes from the port's wav equals
    the JAX function's from the same wav, bit for bit.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
from scipy.io import wavfile

from ddsp_pytorch_tpu.config import Config as JConfig
from ddsp_pytorch_tpu.data.sigmund import preprocess_from_sigmund as jax_from_sigmund
from ddsp_pytorch_tpu.ops import extract_loudness as jax_loudness
from ddsp_pytorch_tpu.ops import extract_pitch as jax_pitch
from ddsp_pytorch_tpu_torch import train_sigmund
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data.fixtures import DEGRADATIONS, make_degrader, render_note
from ddsp_pytorch_tpu_torch.data.sigmund import preprocess_from_sigmund
from ddsp_pytorch_tpu_torch.utils.audio_io import read_wav, save_wav_float

LOP_REL = 1e-6
PITCH_RTOL = 1e-4
LOUDNESS_ATOL = 1e-3
TINY = ["--set", "preprocess.sample_rate=16000", "--set", "preprocess.signal_length=8192",
        "--set", "preprocess.block_size=256", "--set", "model.kwargs.sample_rate=16000",
        "--set", "model.kwargs.block_size=256", "--set", "model.kwargs.hidden_size=32",
        "--set", "model.kwargs.n_harmonic=8", "--set", "model.kwargs.n_bands=17",
        "--set", "train.scales=[512, 256]"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script_lop(x, sr, fc=1000.0):
    """scripts/train_sigmund.py's lop (its _PREP source), sr passed in."""
    a = 1.0 - np.exp(-2.0 * np.pi * fc / sr)
    zi = np.asarray([(1.0 - a) * x[0]])
    y, _ = scipy.signal.lfilter([a], [1.0, -(1.0 - a)], x, zi=zi)
    return y.astype(np.float32)


@pytest.mark.parametrize("sr", [16000, 48000])
def test_lop_matches_scipy_lfilter(sr):
    rng = np.random.default_rng(sr)
    x = np.repeat(rng.uniform(80.0, 900.0, 200), 256).astype(np.float32)
    got = train_sigmund.lop(x, sr)
    want = _script_lop(x, sr)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= LOP_REL * np.max(np.abs(want))


def test_float_wav_round_trips_bit_for_bit(tmp_path):
    tri = np.random.default_rng(0).standard_normal((4097, 3)).astype(np.float32)
    tri[:, 1] = 50.0 + 900.0 * np.abs(tri[:, 1])  # pitch in Hz, far outside [-1, 1]
    ours, theirs = str(tmp_path / "ours.wav"), str(tmp_path / "scipy.wav")
    save_wav_float(ours, tri, 48000)
    wavfile.write(theirs, 48000, tri)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back, sr = read_wav(ours)
    assert sr == 48000 and back.dtype == np.float32
    np.testing.assert_array_equal(back, tri)
    sr_s, back_s = wavfile.read(ours)
    assert sr_s == 48000
    np.testing.assert_array_equal(back_s, tri)
    mono = tri[:, 0].copy()
    save_wav_float(ours, mono, 16000)
    wavfile.write(theirs, 16000, mono)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_analyzer_channels_match_the_script(tmp_path):
    sr, block = 16000, 256
    degrade = make_degrader(**DEGRADATIONS["full_chain"])
    rng = np.random.default_rng(3)
    sigs = np.stack([degrade(0.7 * render_note(fam, f0, 8192, sr, rng)[0], sr)
                     for fam, f0 in (("pluck", 196.0), ("bowed", 330.0))])
    got = train_sigmund.sigmund_channels(sigs, sr, block, device="cpu")
    # the script: YIN and loudness a file, concatenated, held, lop~'d
    f0 = np.concatenate([np.asarray(jax_pitch(s, sr, block)) for s in sigs])
    loud = np.concatenate([np.asarray(jax_loudness(jnp.asarray(s[None, :]), sr, block))[0] for s in sigs])
    want_pitch = _script_lop(np.repeat(f0, block).astype(np.float32), sr)
    want_loud = _script_lop(np.repeat(loud, block).astype(np.float32), sr)
    assert got.shape == (sigs.size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], sigs.reshape(-1))
    np.testing.assert_allclose(got[:, 1], want_pitch, rtol=PITCH_RTOL)
    np.testing.assert_allclose(got[:, 2], want_loud, atol=LOUDNESS_ATOL)

    wav = str(tmp_path / "train.wav")
    save_wav_float(wav, got, sr)
    raw = {"preprocess": {"sample_rate": sr, "signal_length": 4096, "block_size": block}}
    for name, fn, cfg_cls in (("p", preprocess_from_sigmund, Config), ("j", jax_from_sigmund, JConfig)):
        raw["preprocess"]["out_dir"] = str(tmp_path / name)
        fn(wav, cfg_cls.from_dict(raw), "train")
    for name in ("signals", "pitchs", "loudness"):
        np.testing.assert_array_equal(np.load(tmp_path / "p" / "train" / f"{name}.npy"),
                                      np.load(tmp_path / "j" / "train" / f"{name}.npy"))


def test_cli_trains_segmented_and_exports(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root, out = tmp_path / "root", tmp_path / "out"
    traj = train_sigmund.main(["--device", "cpu", "--steps", "4", "--segment-steps", "2",
                               "--steps-per-call", "2", "--batch", "2", "--n-train", "3",
                               "--n-validation", "2", "--root", str(root), "--out", str(out), *TINY])
    with open(os.path.join(os.path.dirname(__file__), "..", "pretrained", "sigmund_loss.json")) as f:
        artifact = json.load(f)
    saved = json.loads((out / "sigmund_loss.json").read_text())
    assert saved.keys() == artifact.keys() and saved == json.loads(json.dumps(traj))
    assert saved["steps"] == 4 and np.isfinite(saved["loss_first10_mean"]) and len(saved["val_losses"]) == 1
    for name in ("ddsp_sigmund_bundle", "ddsp_sigmund_config.yaml", "ddsp_sigmund_impulse.wav"):
        assert (out / name).exists(), name
    tri, sr = read_wav(str(root / "wavs" / "train.wav"))
    assert sr == 16000 and tri.shape == (3 * 8192, 3) and tri.dtype == np.float32
    with open(root / "runs" / "sigmund" / "segments.jsonl") as f:
        assert [json.loads(line)["to_step"] for line in f] == [0, 2, 4]
    cfg = Config.from_yaml(str(root / "sigmund.yaml"))
    assert cfg.train.steps == 4 and cfg.preprocess.sample_rate == 16000 and cfg.train.val_interval_epochs == 0
    assert sorted(os.listdir(root / "runs" / "sigmund" / "audio")) == ["rec_val_4.wav", "sig_val_4.wav"]
