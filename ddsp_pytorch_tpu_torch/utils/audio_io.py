"""Wav reading (a numpy walk of the RIFF chunks) and writing (the standard
library's `wave`), and a polyphase resampler in numpy.

Port of ddsp_pytorch_tpu/utils/audio_io.py:15-42, which reads and writes
through scipy.io.wavfile and resamples with scipy.signal.resample_poly:
`read_wav` returns what scipy.io.wavfile.read returns for PCM (8- to
64-bit; 24-bit samples as the top three bytes of an int32), IEEE float
(32- and 64-bit) and WAVE_FORMAT_EXTENSIBLE files; `load_wav` scales them
as the JAX function does, mixes the channels to mono and resamples; `save_wav` writes
the same 16-bit PCM samples, mono; `save_wav_float` writes float32 audio of
any channel count, byte for byte as scipy.io.wavfile.write writes a
float32 array (what the sigmund wavs of train_sigmund.py need: pitch in
Hz); `resample_poly` is scipy's, with its
default filter (a Kaiser-windowed sinc, β = 5) and its zero padding.
"""

from __future__ import annotations

import math
import struct
import wave

import numpy as np

# scipy.signal.resample_poly's default design: a firwin low-pass of
# 2·HALF_LEN_PER_RATE·max(up, down) + 1 taps, window np.kaiser(·, KAISER_BETA)
HALF_LEN_PER_RATE = 10
KAISER_BETA = 5.0
# outputs computed per block in resample_poly (bounds its temporary arrays)
_OUT_BLOCK = 1 << 16
# WAVE format tags (RFC 2361): the two read here, and names for the refusals
_PCM, _IEEE_FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE
_WAV_FORMATS = {2: "ADPCM", 6: "A-law", 7: "mu-law", 0x11: "IMA ADPCM", 0x55: "MPEG layer 3",
                _EXTENSIBLE: "extensible (unknown subformat)"}
# the last 12 bytes of an extensible subformat GUID {XXXXXXXX-0000-0010-8000-00AA00389B71}
_GUID_TAIL = b"\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


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


def save_wav_float(path: str, audio, sample_rate: int) -> None:
    """Write float32 audio (T,) or (T, channels) as an IEEE-float wav, the
    bytes scipy.io.wavfile.write gives a float32 array: a fmt chunk of 18
    bytes (cbSize 0), a fact chunk with the frame count, then the data."""
    data = np.ascontiguousarray(np.asarray(audio, "<f4"))
    channels = 1 if data.ndim == 1 else data.shape[1]
    fmt = struct.pack("<HHIIHH", _IEEE_FLOAT, channels, int(sample_rate), int(sample_rate) * 4 * channels,
                      4 * channels, 32) + b"\x00\x00"
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"fact" + struct.pack("<II", 4, data.shape[0])
            + b"data" + struct.pack("<I", data.nbytes) + data.tobytes())
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _chunks(raw: bytes):
    """(id, payload) of each RIFF chunk after the WAVE header; a chunk of
    odd size is followed by a pad byte."""
    pos = 12
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = int.from_bytes(raw[pos + 4 : pos + 8], "little")
        yield cid, raw[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)


def _format(fmt: bytes, path: str) -> tuple:
    """(format tag, channels, sample rate, block align, bits) of a `fmt `
    chunk; WAVE_FORMAT_EXTENSIBLE resolves to its subformat's tag when the
    GUID is the standard one, as scipy.io.wavfile does."""
    if len(fmt) < 16:
        raise ValueError(f"{path}: fmt chunk of {len(fmt)} bytes is not a WAV fmt chunk")
    tag, channels, sr, byte_rate, align, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == _EXTENSIBLE:
        if len(fmt) < 40 or struct.unpack("<H", fmt[16:18])[0] < 22:
            raise ValueError(f"{path}: extensible fmt chunk too short ({len(fmt)} bytes)")
        guid = fmt[24:40]
        if guid[4:] == _GUID_TAIL:
            tag = struct.unpack("<I", guid[:4])[0]
    if tag == _PCM and byte_rate != sr * align:
        raise ValueError(f"{path}: byte rate {byte_rate} != sample rate {sr} × block align {align}")
    return tag, channels, sr, align, bits


def read_wav(path: str) -> tuple:
    """(samples (T,) or (T, channels), sample rate) of a WAV file, in the
    types scipy.io.wavfile.read returns: PCM as uint8 (8 bits or fewer),
    int16, int32 (24-bit samples in its top three bytes) or int32/int64
    by container width; IEEE float as float32 or float64;
    WAVE_FORMAT_EXTENSIBLE by its PCM or float subformat.  The RIFF chunks
    are walked in numpy; chunks other than `fmt ` and `data` are skipped.
    Another format (A-law, mu-law, a compressed one, big-endian RIFX)
    raises a ValueError that names it."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        what = "big-endian RIFX" if raw[:4] == b"RIFX" else f"{raw[:4]!r} file"
        raise ValueError(f"{path}: {what} is not a little-endian RIFF WAVE file")
    fmt = None
    for cid, payload in _chunks(raw):
        if cid == b"fmt ":
            fmt = _format(payload, path)
        elif cid == b"data":
            if fmt is None:
                raise ValueError(f"{path}: data chunk before the fmt chunk")
            return _samples(payload, *fmt, path), fmt[2]
    raise ValueError(f"{path}: no {'data' if fmt else 'fmt'} chunk")


def _samples(data: bytes, tag: int, channels: int, sr: int, align: int, bits: int, path: str):
    width = align // channels
    if tag == _PCM:
        if 1 <= bits <= 8:
            dtype = np.uint8
        elif width in (3, 5, 6, 7):
            dtype = None
        elif bits <= 64 and width in (2, 4, 8):
            dtype = f"<i{width}"
        else:
            raise ValueError(f"{path}: {bits}-bit PCM in {width}-byte containers is not supported")
    elif tag == _IEEE_FLOAT:
        if bits not in (32, 64):
            raise ValueError(f"{path}: {bits}-bit IEEE float WAV is not supported (32 or 64)")
        dtype = f"<f{width}"
    else:
        name = _WAV_FORMATS.get(tag, f"format tag {tag:#06x}")
        raise ValueError(f"{path}: {name} WAV is not supported (PCM or IEEE float only)")
    n = len(data) // width
    if dtype is not None:
        out = np.frombuffer(data, dtype, count=n).copy()
    else:  # odd container widths: the bytes at the top of an int32 or int64, as scipy packs them
        wide = 4 if width == 3 else 8
        b = np.zeros((n, wide), np.uint8)
        b[:, wide - width :] = np.frombuffer(data, np.uint8, count=n * width).reshape(n, width)
        out = b.view(f"<i{wide}").reshape(n)
    return out.reshape(-1, channels) if channels > 1 else out


def load_wav(path: str, sample_rate: int | None = None) -> tuple:
    """Read a wav as float32 (PCM scaled to [-1, 1], float as stored),
    mono-mixed, resampled to `sample_rate` if given.  Returns (audio (T,),
    sample rate)."""
    data, sr = read_wav(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32, float64 (and 64-bit PCM), as the JAX function casts them
        audio = data.astype(np.float32)
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
