"""The port's offline timbre transfer (inference.py, transfer.py) and its
ingestion of sigmund wavs and NSynth views (data/sigmund.py,
data/nsynth.py) against the JAX package's, on the CPU.

Every clip is 0.5 s at the bundles' 48 kHz, made from a seed with numpy;
the committed full-width bundles are pretrained/ddsp_sigmund_bundle
(single-inst-decoder, pitch_tracker hybrid) and
pretrained/ddsp_oof_ae_bundle (mfcc-autoencoder, hybrid).  Noise cannot
be drawn alike in both packages (torch.Generator against jax.random), so
the JAX StreamingSynth is made harmonic-only by monkeypatching the JAX
package's module attribute with noise_deterministic=True, and the port's
timbre_transfer is called with noise_deterministic=True.

Tolerances:
  * extract_controls: f0 within 1e-5 relative; loudness within 1e-4
    absolute (tests/test_torch_loudness.py's bound);
  * synthesis from the same controls (both sides' extract_controls
    replaced by the same arrays), with and without reverb: 1e-4 absolute;
  * the whole timbre_transfer: TRANSFER_ATOL = 2e-4 absolute, ~8× the
    largest difference measured on the CPU (2.6e-5, the oof_ae bundle
    with reverb, peak 0.39): the f0 tracks differ by ~1e-6 relative, which
    moves the oscillator's phase, so the stage-wise checks above carry the
    tight bounds;
  * sigmund ingestion: arrays equal bit for bit; NSynth views: the same
    counts and links.
"""

import functools
import json
import os
import wave

import numpy as np
import pytest
from scipy.io import wavfile

import ddsp_pytorch_tpu.inference as jax_inference
import ddsp_pytorch_tpu.streaming as jax_streaming
from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.data.nsynth import create_inst_view as jax_create_inst_view
from ddsp_pytorch_tpu.data.preprocess import make_pitch_fn as jax_make_pitch_fn
from ddsp_pytorch_tpu.data.sigmund import preprocess_from_sigmund as jax_from_sigmund
from ddsp_pytorch_tpu_torch import inference, nsynth_inst_split, transfer
from ddsp_pytorch_tpu_torch import preprocess as preprocess_cli
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data.nsynth import create_inst_view, filter_by_instrument
from ddsp_pytorch_tpu_torch.data.preprocess import make_pitch_fn
from ddsp_pytorch_tpu_torch.data.sigmund import preprocess_from_sigmund
from ddsp_pytorch_tpu_torch.utils import load_wav, save_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLES = {name: os.path.join(REPO, "pretrained", f"ddsp_{name}_bundle") for name in ("sigmund", "oof_ae")}
SR, BLOCK = 48000, 512
F0_RTOL, LOUDNESS_ATOL, SYNTH_ATOL, TRANSFER_ATOL = 1e-5, 1e-4, 1e-4, 2e-4


def _clip(seed=0, seconds=0.5, f_lo=220.0, f_hi=262.0):
    """A 5-harmonic glide with a -40 dB noise floor, float32."""
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    f0 = f_lo * (f_hi / f_lo) ** (np.arange(n) / n)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6)) + 0.003 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.fixture
def jax_harmonic_only(monkeypatch):
    monkeypatch.setattr(jax_streaming, "StreamingSynth",
                        functools.partial(jax_streaming.StreamingSynth, noise_deterministic=True))


def _cfg(bundle):
    path = os.path.join(BUNDLES[bundle], "config.yaml")
    return Config.from_yaml(path), JaxConfig.from_yaml(path)


@pytest.mark.parametrize("tracker", ["yin-default", "hybrid", "custom"])
def test_extract_controls_matches_jax(tracker):
    x = _clip(seed=1)
    if tracker == "yin-default":
        port_fn = jax_fn = None
    elif tracker == "hybrid":
        port_cfg, jax_cfg = _cfg("sigmund")
        port_fn, jax_fn = make_pitch_fn(port_cfg, device="cpu"), jax_make_pitch_fn(jax_cfg)
    else:
        calls = []

        def port_fn(row, sample_rate, block_size):
            calls.append((len(row), sample_rate, block_size))
            return np.full(len(row) // block_size, 123.0, np.float32)

        jax_fn = port_fn
    f0, loud = inference.extract_controls(x, SR, BLOCK, pitch_fn=port_fn, device="cpu")
    f0_j, loud_j = jax_inference.extract_controls(x, SR, BLOCK, pitch_fn=jax_fn)
    assert f0.shape == loud.shape == f0_j.shape == (x.size // BLOCK,)
    assert f0.dtype == loud.dtype == np.float32
    np.testing.assert_allclose(f0, f0_j, rtol=F0_RTOL)
    np.testing.assert_allclose(loud, loud_j, atol=LOUDNESS_ATOL)
    if tracker == "custom":
        assert calls == [(x.size // BLOCK * BLOCK, SR, BLOCK)] * 2
        np.testing.assert_array_equal(f0, 123.0)


@pytest.mark.parametrize("reverb", [False, True], ids=["dry", "reverb"])
@pytest.mark.parametrize("bundle", list(BUNDLES))
def test_synthesis_from_the_same_controls_matches_jax(monkeypatch, jax_harmonic_only, bundle, reverb):
    """Both packages render the same f0 and loudness (a glide, a loudness
    swell) through the bundle: the model, the oscillator, the MFCCs of the
    same audio for the autoencoder, and the trained reverb."""
    x = _clip(seed=2)
    frames = x.size // BLOCK
    f0 = np.linspace(180.0, 300.0, frames).astype(np.float32)
    loud = np.linspace(-9.0, -4.0, frames).astype(np.float32)
    # each side's extract_controls (its tracker and loudness) is replaced by the same arrays
    monkeypatch.setattr(inference, "extract_controls", lambda *a, **k: (f0, loud))
    monkeypatch.setattr(jax_inference, "extract_controls", lambda *a, **k: (f0, loud))
    got = inference.timbre_transfer(BUNDLES[bundle], x, SR, include_reverb=reverb, octave_shift=0.5,
                                    loudness_shift=0.25, noise_deterministic=True, device="cpu")
    want = jax_inference.timbre_transfer(BUNDLES[bundle], x, SR, include_reverb=reverb, octave_shift=0.5,
                                         loudness_shift=0.25)
    assert got.shape == want.shape == (frames * BLOCK,) and got.dtype == np.float32
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got, want, atol=SYNTH_ATOL)


@pytest.mark.parametrize("bundle, octave", [("sigmund", 0.0), ("oof_ae", 1.0)])
def test_timbre_transfer_matches_jax(jax_harmonic_only, bundle, octave):
    x = _clip(seed=3)
    got = inference.timbre_transfer(BUNDLES[bundle], x, SR, octave_shift=octave, noise_deterministic=True,
                                    device="cpu")
    want = jax_inference.timbre_transfer(BUNDLES[bundle], x, SR, octave_shift=octave)
    assert got.shape == want.shape == (x.size // BLOCK * BLOCK,)
    assert np.isfinite(got).all() and float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got, want, atol=TRANSFER_ATOL)


def test_timbre_transfer_refuses_another_rate():
    with pytest.raises(ValueError, match="48000"):
        inference.timbre_transfer(BUNDLES["sigmund"], _clip(), 16000, device="cpu")


def test_transfer_cli_writes_a_wav(tmp_path, capsys):
    """The CLI reads a 44.1 kHz wav (resampled on load to the bundle's
    48 kHz), renders it and writes 16-bit PCM of F·512 samples."""
    x = _clip(seed=4, seconds=0.4)
    save_wav(str(tmp_path / "in.wav"), x, 44100)
    n_in = load_wav(str(tmp_path / "in.wav"), SR)[0].size
    out = transfer.main(["--bundle", BUNDLES["sigmund"], "--input", str(tmp_path / "in.wav"),
                         "--output", str(tmp_path / "out.wav"), "--octave-shift", "1", "--device", "cpu"])
    assert out == str(tmp_path / "out.wav")
    with wave.open(out) as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, SR)
        assert f.getnframes() == n_in // BLOCK * BLOCK
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        transfer.main(["--bundle", str(tmp_path), "--input", out, "--output", out, "--device", "cpu"])


# ------------------------------------------------------------- ingestion


def _sigmund_raw(out_dir):
    return {"preprocess": {"sample_rate": 16000, "signal_length": 4096, "block_size": 256, "out_dir": str(out_dir)}}


@pytest.mark.parametrize("dtype", [np.int16, np.int32], ids=["16bit", "32bit"])
def test_preprocess_from_sigmund_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(5)
    n = 4096 * 2 + 1000  # pads to 3 chunks
    peak = np.iinfo(dtype).max
    x = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(100, 900, n) / 1000, rng.uniform(-0.9, 0, n)], axis=1)
    wavfile.write(str(tmp_path / "s.wav"), 16000, (x * peak).astype(dtype))
    port_cfg = Config.from_dict(_sigmund_raw(tmp_path / "port"))
    preprocess_from_sigmund(str(tmp_path / "s.wav"), port_cfg, "train")
    jax_from_sigmund(str(tmp_path / "s.wav"), JaxConfig.from_dict(_sigmund_raw(tmp_path / "jax")), "train")
    for name, shape in (("signals", (3, 4096)), ("pitchs", (3, 16)), ("loudness", (3, 16))):
        got, want = np.load(tmp_path / "port" / "train" / f"{name}.npy"), np.load(tmp_path / "jax" / "train" / f"{name}.npy")
        assert got.shape == want.shape == shape and got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want)
    # the CLI's --from-sigmund, without a partition
    port_cfg.to_yaml(str(tmp_path / "cfg.yaml"))
    preprocess_cli.main(["--config", str(tmp_path / "cfg.yaml"), "--from-sigmund", str(tmp_path / "s.wav"),
                         "--set", f"preprocess.out_dir={tmp_path / 'cli'}"])
    np.testing.assert_array_equal(np.load(tmp_path / "cli" / "signals.npy"),
                                  np.load(tmp_path / "jax" / "train" / "signals.npy"))


def test_preprocess_from_sigmund_refuses(tmp_path):
    port_cfg = Config.from_dict(_sigmund_raw(tmp_path / "never"))
    wavfile.write(str(tmp_path / "float.wav"), 16000, np.zeros((300, 3), np.float32))
    with pytest.raises(ValueError, match="IEEE float"):
        preprocess_from_sigmund(str(tmp_path / "float.wav"), port_cfg)
    wavfile.write(str(tmp_path / "mono.wav"), 16000, np.zeros(300, np.int16))
    with pytest.raises(ValueError, match="3-channel"):
        preprocess_from_sigmund(str(tmp_path / "mono.wav"), port_cfg)
    wavfile.write(str(tmp_path / "fast.wav"), 22050, np.zeros((300, 3), np.int16))
    with pytest.raises(ValueError, match="22050"):
        preprocess_from_sigmund(str(tmp_path / "fast.wav"), port_cfg)
    assert not (tmp_path / "never").exists()


def _fake_nsynth(root):
    """nsynth-{valid,train}/ with examples.json and audio/: violin and
    cello notes, a note without instrument_str, one wav missing; no test
    partition."""
    notes = {"valid": ["violin_acoustic_000-060-100", "cello_acoustic_001-048-075", "violin_synthetic_002-070-050"],
             "train": ["violin_acoustic_010-062-127", "keyboard_electronic_003-021-025", "violin_only_id"]}
    for part, ids in notes.items():
        pdir = root / f"nsynth-{part}"
        (pdir / "audio").mkdir(parents=True)
        examples = {}
        for note in ids:
            if note != "violin_only_id":
                examples[note] = {"instrument_str": note.rsplit("-", 2)[0], "pitch": 60}
            else:
                examples[note] = {"pitch": 60}
            if note != "violin_synthetic_002-070-050":
                (pdir / "audio" / f"{note}.wav").write_bytes(b"RIFF")
        (pdir / "examples.json").write_text(json.dumps(examples))


def _links(target):
    return sorted((str(p.relative_to(target)), os.path.realpath(p)) for p in target.rglob("*.wav"))


def test_create_inst_view_matches_jax(tmp_path, capsys):
    _fake_nsynth(tmp_path / "nsynth")
    want = jax_create_inst_view(tmp_path / "nsynth", tmp_path / "jax", "violin")
    got = create_inst_view(tmp_path / "nsynth", tmp_path / "port", "violin")
    assert got == want == {"valid": 1, "train": 2}
    assert _links(tmp_path / "port") == _links(tmp_path / "jax")
    assert all(os.path.islink(tmp_path / "port" / rel) for rel, _ in _links(tmp_path / "port"))
    # again: existing links are kept, none added
    assert create_inst_view(tmp_path / "nsynth", tmp_path / "port", "violin") == {"valid": 0, "train": 0}
    assert filter_by_instrument({"a": {"instrument_str": "cello_x"}, "violin_b": {}}, "violin") == ["violin_b"]
    counts = nsynth_inst_split.main(["--nsynth-root", str(tmp_path / "nsynth"), "--target", str(tmp_path / "cli"),
                                     "--instrument", "cello", "--partitions", "valid", "test"])
    assert counts == {"valid": 1}
    assert "valid: 1 files linked" in capsys.readouterr().out
