"""The port's wav reading (`wave` + numpy) and polyphase resampler against
the JAX package's `load_wav` (scipy.io.wavfile + scipy.signal.resample_poly)
and scipy's `resample_poly`, on the CPU.

Tolerances: decoded samples equal, and read_wav's arrays equal
scipy.io.wavfile.read's bit for bit, dtype included; resampled audio within 1e-5 absolute of
scipy's (scipy filters float32 input in float32, the port in float64;
measured 7e-7 on unit-variance noise).
"""

import struct
import wave

import numpy as np
import pytest
import torch
from scipy.io import wavfile
from scipy.signal import resample_poly as scipy_resample_poly

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.data.sigmund import preprocess_from_sigmund as jax_from_sigmund
from ddsp_pytorch_tpu.utils.audio_io import load_wav as jax_load_wav
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data.sigmund import preprocess_from_sigmund
from ddsp_pytorch_tpu_torch.utils import audio_io

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _extensible(path, samples: np.ndarray, sr: int, subformat: int, bits: int):
    """A WAVE_FORMAT_EXTENSIBLE file (40-byte fmt chunk, a LIST chunk of odd
    size before the data) of `samples` (T, C), little-endian."""
    t, c = samples.shape
    width = samples.dtype.itemsize
    guid = struct.pack("<I", subformat) + bytes.fromhex("000010008000 00aa00389b71".replace(" ", ""))
    fmt = struct.pack("<HHIIHHHHI", 0xFFFE, c, sr, sr * c * width, c * width, bits, 22, bits, 0) + guid
    data = samples.astype(samples.dtype.newbyteorder("<")).tobytes()
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"LIST" + struct.pack("<I", 3) + b"abc\0"
    body += b"data" + struct.pack("<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("channels", [1, 3], ids=["mono", "3ch"])
def test_float_wav_matches_scipy(tmp_path, dtype, channels):
    rng = np.random.default_rng(channels)
    x = rng.uniform(-1.5, 1.5, (2001, channels)).astype(dtype)
    x = x[:, 0] if channels == 1 else x
    wavfile.write(str(tmp_path / "f.wav"), 22050, x)
    got, sr = audio_io.read_wav(str(tmp_path / "f.wav"))
    want_sr, want = wavfile.read(str(tmp_path / "f.wav"))
    assert sr == want_sr == 22050 and got.dtype == want.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    got, _ = audio_io.load_wav(str(tmp_path / "f.wav"), 16000)
    want, _ = jax_load_wav(str(tmp_path / "f.wav"), 16000)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL)
    np.testing.assert_array_equal(audio_io.load_wav(str(tmp_path / "f.wav"))[0],
                                  jax_load_wav(str(tmp_path / "f.wav"))[0])


@pytest.mark.parametrize("case", ["float32", "float64", "pcm16", "pcm32"])
def test_extensible_wav_matches_scipy(tmp_path, case):
    rng = np.random.default_rng(7)
    if case.startswith("float"):
        x, tag = rng.uniform(-1, 1, (513, 2)).astype(case), 3
    else:
        bits = int(case[3:])
        x, tag = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), (513, 2)).astype(f"int{bits}"), 1
    _extensible(tmp_path / "e.wav", x, 44100, tag, 8 * x.dtype.itemsize)
    got, sr = audio_io.read_wav(str(tmp_path / "e.wav"))
    want_sr, want = wavfile.read(str(tmp_path / "e.wav"))
    assert sr == want_sr == 44100 and got.dtype == want.dtype and got.shape == want.shape == (513, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio_io.load_wav(str(tmp_path / "e.wav"))[0],
                                  jax_load_wav(str(tmp_path / "e.wav"))[0])


@pytest.mark.parametrize("tag,name", [(6, "A-law"), (7, "mu-law"), (0x55, "MPEG")])
def test_other_wav_formats_raise(tmp_path, tag, name):
    wavfile.write(str(tmp_path / "f.wav"), 16000, np.zeros(64, np.float32))
    raw = bytearray((tmp_path / "f.wav").read_bytes())
    raw[20:22] = tag.to_bytes(2, "little")  # the fmt chunk's format tag
    (tmp_path / "x.wav").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=name):
        audio_io.read_wav(str(tmp_path / "x.wav"))
    (tmp_path / "rifx.wav").write_bytes(b"RIFX" + bytes(raw[4:]))
    with pytest.raises(ValueError, match="RIFX"):
        audio_io.load_wav(str(tmp_path / "rifx.wav"))


def test_float_sigmund_wav_matches_jax(tmp_path):
    """A 3-channel float32 sigmund wav (audio, pitch in Hz near 440,
    loudness), as Pd records it: ingested bit for bit as the JAX package
    ingests it."""
    rng = np.random.default_rng(11)
    n = 4096 * 2 + 777
    t = np.arange(n) / 16000
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t), 440 + 3 * rng.standard_normal(n),
                  -6 + rng.standard_normal(n)], axis=1).astype(np.float32)
    wavfile.write(str(tmp_path / "s.wav"), 16000, x)
    raw = {"preprocess": {"sample_rate": 16000, "signal_length": 4096, "block_size": 256}}
    port = Config.from_dict({"preprocess": {**raw["preprocess"], "out_dir": str(tmp_path / "port")}})
    jax = JaxConfig.from_dict({"preprocess": {**raw["preprocess"], "out_dir": str(tmp_path / "jax")}})
    preprocess_from_sigmund(str(tmp_path / "s.wav"), port, "train")
    jax_from_sigmund(str(tmp_path / "s.wav"), jax, "train")
    for name, shape in (("signals", (3, 4096)), ("pitchs", (3, 16)), ("loudness", (3, 16))):
        got = np.load(tmp_path / "port" / "train" / f"{name}.npy")
        want = np.load(tmp_path / "jax" / "train" / f"{name}.npy")
        assert got.shape == want.shape == shape and got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want)
    pitch = np.load(tmp_path / "port" / "train" / "pitchs.npy")
    assert 420 < np.median(pitch[:2]) < 460  # Hz kept, not clipped into [-1, 1)
