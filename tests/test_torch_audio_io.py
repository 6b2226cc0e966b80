"""The port's wav reading (`wave` + numpy) and polyphase resampler against
the JAX package's `load_wav` (scipy.io.wavfile + scipy.signal.resample_poly)
and scipy's `resample_poly`, on the CPU.

Tolerances: decoded samples equal; resampled audio within 1e-5 absolute of
scipy's (scipy filters float32 input in float32, the port in float64;
measured 7e-7 on unit-variance noise).
"""

import wave

import numpy as np
import pytest
from scipy.signal import resample_poly as scipy_resample_poly

from ddsp_pytorch_tpu.utils.audio_io import load_wav as jax_load_wav
from ddsp_pytorch_tpu_torch.utils import audio_io

RESAMPLE_ATOL = 1e-5


def _write(path, samples: np.ndarray, width: int, channels: int, sr: int):
    """A PCM wav of little-endian `width`-byte samples through `wave`."""
    if width == 1:
        raw = samples.astype(np.uint8).tobytes()
    elif width == 3:
        v = samples.astype("<i4").view(np.uint8).reshape(-1, 4)
        raw = v[:, :3].tobytes()
    else:
        raw = samples.astype({2: "<i2", 4: "<i4"}[width]).tobytes()
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(raw)


@pytest.mark.parametrize("width", [1, 2, 3, 4], ids=["8bit", "16bit", "24bit", "32bit"])
@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_load_wav_matches_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    n = 3001 * channels
    if width == 1:
        samples = rng.integers(0, 256, n)
    else:
        bits = 8 * width
        samples = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), n, dtype=np.int64)
        samples[:4] = [-(2 ** (bits - 1)), 2 ** (bits - 1) - 1, 0, -1]
    path = tmp_path / "x.wav"
    _write(path, samples, width, channels, 16000)
    got, sr = audio_io.load_wav(str(path))
    want, sr_want = jax_load_wav(str(path))
    assert sr == sr_want == 16000
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (3001,)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 1.0


def test_load_wav_resamples_like_jax(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(22050) / 44100
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size)
    audio_io.save_wav(str(tmp_path / "a.wav"), x, 44100)
    got, sr = audio_io.load_wav(str(tmp_path / "a.wav"), 48000)
    want, sr_want = jax_load_wav(str(tmp_path / "a.wav"), 48000)
    assert sr == sr_want == 48000 and got.dtype == np.float32 and got.shape == want.shape == (24000,)
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL)


@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000), (22050, 48000)],
                         ids=["44k1-48k", "48k-16k", "22k05-48k"])
def test_resample_poly_matches_scipy(rates):
    sr_in, sr_out = rates
    g = np.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    x = np.random.default_rng(sr_in).standard_normal(sr_in // 4 + 7).astype(np.float32)
    got = audio_io.resample_poly(x, up, down)
    want = scipy_resample_poly(x, up, down)
    assert got.shape == want.shape == (-(-x.size * up // down),)
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL)
    np.testing.assert_allclose(got, scipy_resample_poly(x.astype(np.float64), up, down), atol=1e-12)


def test_resample_poly_edges():
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(audio_io.resample_poly(x, 3, 3), x)
    np.testing.assert_allclose(audio_io.resample_poly(x, 3, 2), scipy_resample_poly(x.astype(np.float64), 3, 2),
                               atol=1e-12)
    with pytest.raises(ValueError, match=r"\(T,\)"):
        audio_io.resample_poly(np.zeros((2, 5)), 2, 1)
