"""The port's out-of-family fixtures (ddsp_pytorch_tpu_torch/data/fixtures.py)
against the JAX package's (ddsp_pytorch_tpu/data/fixtures.py) and scipy, on
the CPU.

Tolerances:
  * every family and every DEGRADATIONS entry from the same seed: within
    1e-5 of the peak (the draws are the same; the IIR, the Butterworth
    design and the reverb's FFT convolution are numpy restatements of
    scipy's, which round differently);
  * butter_highpass2's coefficients: scipy's within 1e-12;
  * lfilter: scipy's within 1e-9 of the output's peak; fftconvolve within
    1e-6 of its peak (scipy convolves float32 in float32);
  * a small corpus: the same meta.json and truth; the clean wavs byte for
    byte, the degraded ones within one 16-bit step.
"""

import json
import os

import numpy as np
import pytest
import scipy.signal
import torch
from scipy.io import wavfile

from ddsp_pytorch_tpu.data import fixtures as J
from ddsp_pytorch_tpu_torch.data import fixtures as P

PEAK_REL = 1e-5
BUTTER_ATOL = 1e-12
LFILTER_REL = 1e-9
FFTCONV_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_of_peak(got, want, rel=PEAK_REL):
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= rel, err


@pytest.mark.parametrize("family", ["pluck", "fm_brass", "bowed"])
@pytest.mark.parametrize("f0", [66.0, 311.0, 1175.0])
def test_render_note_matches_jax(family, f0):
    sig, track = P.render_note(family, f0, 8000, 16000, np.random.default_rng(4))
    want, want_track = J.render_note(family, f0, 8000, 16000, np.random.default_rng(4))
    assert sig.dtype == want.dtype and track.dtype == want_track.dtype
    _close_of_peak(sig, want)
    np.testing.assert_array_equal(track, want_track)


@pytest.mark.parametrize("condition", sorted(J.DEGRADATIONS))
def test_degradation_matches_jax(condition):
    note, _ = J.render_note("bowed", 247.0, 8000, 16000, np.random.default_rng(1))
    note = 0.7 * note / np.max(np.abs(note))
    got = P.make_degrader(**P.DEGRADATIONS[condition])(note, 16000)
    want = J.make_degrader(**J.DEGRADATIONS[condition])(note, 16000)
    assert got.dtype == np.float32
    _close_of_peak(got, want)


def test_degradations_are_the_jax_table():
    assert P.DEGRADATIONS == J.DEGRADATIONS
    assert P.FAMILIES == J.FAMILIES


@pytest.mark.parametrize("wn", [80.0 / 24000.0, 80.0 / 8000.0, 0.05, 0.4, 0.9])
def test_butter_highpass2_matches_scipy(wn):
    b, a = P.butter_highpass2(wn)
    want_b, want_a = scipy.signal.butter(2, wn, btype="highpass")
    np.testing.assert_allclose(b, want_b, atol=BUTTER_ATOL, rtol=0)
    np.testing.assert_allclose(a, want_a, atol=BUTTER_ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 20000])
def test_lfilter_matches_scipy(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for b, a in (P.butter_highpass2(80.0 / 24000.0), P._biquad_peaking(48000, 4000.0, 6.0),
                 ([0.3, 0.0, -0.3], [1.3, -1.2, 0.7]), ([0.5], [1.0, -0.5])):
        got = P.lfilter(b, a, x)
        want = scipy.signal.lfilter(b, a, x)
        assert got.dtype == np.float64 and got.shape == want.shape
        _close_of_peak(got, want, LFILTER_REL)


def test_fftconvolve_matches_scipy():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(7919).astype(np.float32)
    h = rng.standard_normal(1201).astype(np.float32)
    got = P.fftconvolve(x, h)
    want = scipy.signal.fftconvolve(x, h)
    assert got.shape == want.shape
    _close_of_peak(got, want, FFTCONV_REL)


def test_noise_and_room_match_jax():
    for color in ("white", "pink"):
        np.testing.assert_array_equal(P.colored_noise(999, np.random.default_rng(3), color),
                                      J.colored_noise(999, np.random.default_rng(3), color))
    x = np.sin(np.arange(4000) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(P.add_noise_snr(x, 10.0, np.random.default_rng(5)),
                                  J.add_noise_snr(x, 10.0, np.random.default_rng(5)))
    np.testing.assert_array_equal(P.room_impulse_response(16000, np.random.default_rng(6), 0.3),
                                  J.room_impulse_response(16000, np.random.default_rng(6), 0.3))
    with pytest.raises(ValueError, match="noise color"):
        P.colored_noise(10, np.random.default_rng(0), "blue")
    with pytest.raises(ValueError, match="family"):
        P.render_note("harp", 220.0, 100, 16000, np.random.default_rng(0))


def test_scoring_matches_jax():
    rng = np.random.default_rng(7)
    est, true = rng.uniform(100, 400, 300), rng.uniform(100, 400, 300)
    voiced = rng.uniform(size=300) > 0.3
    np.testing.assert_array_equal(P.cents_error(est, true), J.cents_error(est, true))
    assert P.raw_pitch_accuracy(est, true, voiced) == J.raw_pitch_accuracy(est, true, voiced)
    assert P.summarize_cents(np.array([])) == J.summarize_cents(np.array([]))
    track = rng.uniform(100, 400, 256 * 12).astype(np.float32)
    voiced_s = rng.uniform(size=256 * 12) > 0.1
    for got, want in zip(P.frame_truth(track, voiced_s, 256, 12), J.frame_truth(track, voiced_s, 256, 12)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("condition", [None, "full_chain"], ids=["clean", "full_chain"])
def test_small_corpus_matches_jax(tmp_path, condition):
    kwargs = dict(sample_rate=16000, note_seconds=0.5, n_train=3, n_validation=2, seed=11)
    got = P.make_oof_corpus(str(tmp_path / "p"), **kwargs,
                            degrade_fn=P.make_degrader(**P.DEGRADATIONS[condition]) if condition else None)
    want = J.make_oof_corpus(str(tmp_path / "j"), **kwargs,
                             degrade_fn=J.make_degrader(**J.DEGRADATIONS[condition]) if condition else None)
    assert got == want
    meta = "truth/meta.json"
    assert (tmp_path / "p" / meta).read_text() == (tmp_path / "j" / meta).read_text()
    assert json.loads((tmp_path / "p" / meta).read_text()) == want
    for key in want["files"]:
        part, stem = key.split("/")
        wav_p, wav_j = (str(tmp_path / side / part / (stem + ".wav")) for side in ("p", "j"))
        if condition is None:
            assert open(wav_p, "rb").read() == open(wav_j, "rb").read(), key
        else:
            sr_p, a = wavfile.read(wav_p)
            sr_j, b = wavfile.read(wav_j)
            assert sr_p == sr_j and a.shape == b.shape
            assert np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))) <= 1, key
        for name in ("f0", "voiced"):
            np.testing.assert_array_equal(np.load(tmp_path / "p" / "truth" / part / (stem + ".npz"))[name],
                                          np.load(tmp_path / "j" / "truth" / part / (stem + ".npz"))[name])
    assert sorted(os.listdir(tmp_path / "p" / "train")) == sorted(os.listdir(tmp_path / "j" / "train"))


TINY = ["--set", "preprocess.sample_rate=16000", "--set", "preprocess.signal_length=8192",
        "--set", "preprocess.block_size=256", "--set", "model.kwargs.sample_rate=16000",
        "--set", "model.kwargs.block_size=256", "--set", "model.kwargs.hidden_size=32",
        "--set", "model.kwargs.n_harmonic=8", "--set", "model.kwargs.n_bands=17",
        "--set", "train.scales=[512, 256]", "--set", "preprocess.mfcc_n_fft=512"]


@pytest.mark.parametrize("model, degrade", [("decoder", None), ("autoencoder", "snr10")])
def test_train_oof_cli_trains_and_exports(tmp_path, model, degrade):
    """The fixture corpus through the whole pipeline at a tiny width:
    wavs → preprocess_folder (yin) → Trainer → export_run → oof_loss.json
    in the layout of pretrained/oof_loss.json (a superset of its keys)."""
    from ddsp_pytorch_tpu_torch import train_oof

    root, out = tmp_path / "root", tmp_path / "out"
    argv = ["--device", "cpu", "--steps", "4", "--batch", "2", "--steps-per-call", "2", "--n-train", "3",
            "--n-validation", "2", "--model", model, "--root", str(root), "--out", str(out),
            "--val-interval-epochs", "1", "--log-interval-epochs", "0", *TINY]
    if degrade:
        argv += ["--degrade", degrade]
    traj = train_oof.main(argv)
    with open(os.path.join(os.path.dirname(__file__), "..", "pretrained", "oof_loss.json")) as f:
        artifact = json.load(f)
    saved = json.loads((out / "oof_loss.json").read_text())
    assert set(artifact) <= set(saved) and saved == json.loads(json.dumps(traj))
    assert saved["steps"] == 4 and saved["degradation"] == degrade and np.isfinite(saved["loss_last10_mean"])
    assert saved["model"] == ("mfcc-autoencoder" if model == "autoencoder" else "single-inst-decoder")
    assert len(saved["val_losses"]) == 4  # one step an epoch, validation every epoch
    for name in ("ddsp_oof_bundle", "ddsp_oof_config.yaml", "ddsp_oof_impulse.wav"):
        assert (out / name).exists(), name
    # the corpus is the fixture corpus of the same seed, degraded as asked
    want = P.make_oof_corpus(str(tmp_path / "ref"), sample_rate=16000, note_seconds=8192 / 16000, n_train=3,
                             n_validation=2, seed=0,
                             degrade_fn=P.make_degrader(**P.DEGRADATIONS[degrade]) if degrade else None)
    assert json.loads((root / "corpus" / "truth" / "meta.json").read_text()) == want
    for key in want["files"]:
        part, stem = key.split("/")
        assert (root / "corpus" / part / (stem + ".wav")).read_bytes() == \
            (tmp_path / "ref" / part / (stem + ".wav")).read_bytes()
    assert np.load(root / "cache" / "train" / "signals.npy").shape == (3, 8192)
