"""Wav reading and writing through the standard library's `wave` module, and
a polyphase resampler in numpy.

Port of ddsp_pytorch_tpu/utils/audio_io.py:15-42, which reads and writes
through scipy.io.wavfile and resamples with scipy.signal.resample_poly:
`load_wav` decodes 8-, 16-, 24- and 32-bit PCM as scipy does (24-bit
samples as the top three bytes of an int32), scales them as the JAX
function does, mixes the channels to mono and resamples; `save_wav` writes
the same 16-bit PCM samples, mono; `resample_poly` is scipy's, with its
default filter (a Kaiser-windowed sinc, β = 5) and its zero padding.
"""

from __future__ import annotations

import math
import re
import wave

import numpy as np

# scipy.signal.resample_poly's default design: a firwin low-pass of
# 2·HALF_LEN_PER_RATE·max(up, down) + 1 taps, window np.kaiser(·, KAISER_BETA)
HALF_LEN_PER_RATE = 10
KAISER_BETA = 5.0
# outputs computed per block in resample_poly (bounds its temporary arrays)
_OUT_BLOCK = 1 << 16
# WAVE format tags that `wave` cannot decode, by name
_WAV_FORMATS = {3: "IEEE float", 6: "A-law", 7: "mu-law", 0xFFFE: "extensible"}


def pcm16(audio) -> np.ndarray:
    """float audio in [-1, 1] → int16 samples: clipped, × 32767, truncated
    toward zero (numpy's float → int16 cast)."""
    clipped = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype(np.int16)


def save_wav(path: str, audio, sample_rate: int) -> None:
    """Write mono float32 audio in [-1, 1] as 16-bit PCM."""
    samples = pcm16(audio).reshape(-1)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(samples.astype("<i2").tobytes())


def read_pcm(path: str) -> tuple:
    """(samples (T,) or (T, channels), sample rate) of a PCM wav, in the
    integer types scipy.io.wavfile returns: uint8, int16, or int32 for 24-
    and 32-bit samples (24-bit ones shifted into the top three bytes).
    Another format (IEEE-float WAV among them, which scipy reads and
    `wave` cannot) raises a ValueError that names it."""
    try:
        with wave.open(path, "rb") as f:
            channels, width, sr = f.getnchannels(), f.getsampwidth(), f.getframerate()
            raw = f.readframes(f.getnframes())
    except wave.Error as e:
        m = re.search(r"unknown format: (\d+)", str(e))
        tag = int(m.group(1)) if m else None
        name = _WAV_FORMATS.get(tag, f"format {tag}" if m else str(e))
        raise ValueError(f"{path}: {name} WAV is not supported (8, 16, 24 or 32-bit PCM only)") from e
    if width == 1:
        data = np.frombuffer(raw, np.uint8)
    elif width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.int16)
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.uint32)
        data = ((b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)).view(np.int32)
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.int32)
    else:
        raise ValueError(f"{path}: {8 * width}-bit samples are not supported (8, 16, 24 or 32-bit PCM)")
    if channels > 1:
        data = data.reshape(-1, channels)
    return data, sr


def load_wav(path: str, sample_rate: int | None = None) -> tuple:
    """Read a PCM wav as float32 in [-1, 1], mono-mixed, resampled to
    `sample_rate` if given.  Returns (audio (T,), sample rate)."""
    data, sr = read_pcm(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    else:  # uint8
        audio = (data.astype(np.float32) - 128.0) / 128.0
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        g = math.gcd(int(sample_rate), int(sr))
        audio = resample_poly(audio, sample_rate // g, sr // g).astype(np.float32)
        sr = sample_rate
    return audio, sr


def lowpass_taps(up: int, down: int) -> np.ndarray:
    """scipy's default resample_poly filter (float64): firwin(2·10·m + 1,
    1/m, window=('kaiser', 5.0)) with m = max(up, down), scaled to unit DC
    gain, then × up."""
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate
    numtaps = 2 * HALF_LEN_PER_RATE * max_rate + 1
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = cutoff * np.sinc(cutoff * m)
    h = h * np.kaiser(numtaps, KAISER_BETA)
    h = h / np.sum(h)
    return h * up


def _output_len(len_h: int, n_in: int, up: int, down: int) -> int:
    """Length of upfirdn's full output."""
    return ((n_in - 1) * up + len_h - 1) // down + 1


def resample_poly(x, up: int, down: int) -> np.ndarray:
    """Resample the (T,) signal x by up/down as scipy.signal.resample_poly
    does with its defaults: zero-stuff by `up`, filter with `lowpass_taps`,
    keep every `down`-th sample, the filter's delay removed, ceil(T·up /
    down) samples, computed in float64."""
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError(f"resample_poly expects a (T,) signal, got {x.shape}")
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == down == 1:
        return x.copy()
    n_in = x.shape[0]
    n_out = -(-n_in * up // down)
    h = lowpass_taps(up, down)
    half_len = HALF_LEN_PER_RATE * max(up, down)
    # zero-pad the filter in front so the kept outputs are centered
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    n_post_pad = 0
    while _output_len(len(h) + n_pre_pad + n_post_pad, n_in, up, down) < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    # polyphase: full output y[m] = Σ_i x[i]·h[m·down − i·up]; with
    # t = m·down, the taps are h[t mod up + q·up] on x[t // up − q]
    n_taps = -(-len(h) // up)
    phases = np.zeros(n_taps * up)
    phases[: len(h)] = h
    phases = phases.reshape(n_taps, up).T  # (up, n_taps): phases[p, q] = h[p + q·up]
    xpad = np.concatenate([np.zeros(n_taps - 1), x, np.zeros(n_taps)])
    out = np.empty(n_out)
    q = np.arange(n_taps)
    for start in range(0, n_out, _OUT_BLOCK):
        m = np.arange(start, min(start + _OUT_BLOCK, n_out)) + n_pre_remove
        t = m * down
        i_max = t // up
        # x[i_max − q] sits at xpad[i_max − q + n_taps − 1]
        samples = xpad[(i_max + n_taps - 1)[:, None] - q[None, :]]
        out[m - n_pre_remove] = np.einsum("mq,mq->m", phases[t % up], samples)
    return out
