"""Spectral ops: Hann window, framing, STFT, multi-scale magnitude STFT,
and the MFCC front end of the autoencoder (mel filterbank, DCT, dB, and
the amplitude form of the dB conversion the plots use).

Port of ddsp_pytorch_tpu/ops/spectral.py:26-245.  The STFT keeps the JAX
function's (and torch.stft's) conventions: centered reflect pad of n_fft/2,
periodic Hann window, × n_fft^-1/2 normalization unless asked otherwise,
(..., bins, frames) layout.  The JAX package computes these outside any
Pallas kernel, so the port frames with `Tensor.unfold` and transforms with
torch.fft (cuFFT on the GPU).  The mel filterbank and the DCT matrix are
numpy constants, this package's own copy of the JAX functions (`:98-170`).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window 0.5·(1 − cos(2π i / n))."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n))


def frame_signal(signal: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., T) → overlapping frames (..., n_frames, frame_length), with
    n_frames = 1 + (T − frame_length) // hop_length (spectral.py:32-45)."""
    return signal.unfold(-1, frame_length, hop_length)


def stft(signal: torch.Tensor, n_fft: int, hop_length: int, normalized: bool = True) -> torch.Tensor:
    """Magnitude STFT of a real (..., T) signal → (..., n_fft//2 + 1,
    n_frames), as the JAX `stft` (spectral.py:48-80): centered, magnitude,
    and × n_fft^-1/2 when `normalized` (its default).  The reflect pad needs
    T > n_fft/2."""
    pad = n_fft // 2
    lead = signal.shape[:-1]
    # F.pad's reflect mode wants a (N, C, T) input
    signal = F.pad(signal.reshape(-1, 1, signal.shape[-1]), (pad, pad), mode="reflect")
    signal = signal.reshape(*lead, signal.shape[-1])
    frames = frame_signal(signal, n_fft, hop_length)
    frames = frames * hann_window(n_fft, signal.dtype, signal.device)
    spec = torch.fft.rfft(frames, dim=-1)
    if normalized:
        spec = spec * (1.0 / math.sqrt(n_fft))
    return spec.transpose(-1, -2).abs()


def hop_length(n_fft: int, overlap: float) -> int:
    """The hop of scale n_fft at `overlap`: int(n_fft·(1 − overlap))."""
    return int(n_fft * (1.0 - overlap))


def multiscale_fft(
    signal: torch.Tensor, scales: Sequence[int], overlap: float
) -> List[torch.Tensor]:
    """Magnitude STFTs at each FFT size in `scales`, hop = int(s·(1 −
    overlap)) (spectral.py:83-92)."""
    return [stft(signal, s, hop_length(s, overlap)) for s in scales]


# ------------------------------------------------------------------ mel


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mel,
    )


def _mel_to_hz_slaney(mel: np.ndarray) -> np.ndarray:
    mel = np.asanyarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                    mel * f_sp)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (n_mels, 1 + n_fft//2),
    float32, as librosa.filters.mel(htk=False, norm='slaney')
    (spectral.py:127-152).  Read-only: callers share the cached array."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(fmin)), _hz_to_mel_slaney(np.array(fmax)),
                          n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney-style area normalization
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = (weights * enorm[:, None]).astype(np.float32)
    weights.flags.writeable = False
    return weights


def stft_to_mel(stft_mag: torch.Tensor, sample_rate: int, n_fft: int) -> torch.Tensor:
    """(..., bins, frames) magnitudes → (..., 128, frames) through the
    Slaney mel filterbank over 0 … sr/2, the magnitudes taken as they are
    (spectral.py:202-211, the reconstruction report's mel spectrogram)."""
    fb = torch.tensor(mel_filterbank(sample_rate, n_fft, 128, 0.0, sample_rate / 2.0),
                      dtype=stft_mag.dtype, device=stft_mag.device)
    return torch.einsum("mf,...ft->...mt", fb, stft_mag)


@functools.lru_cache(maxsize=None)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in), y = M @ x, as
    scipy.fftpack.dct(type=2, norm='ortho') cut to n_out rows
    (spectral.py:155-170).  Read-only: callers share the cached array."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    mat *= np.sqrt(1.0 / (4.0 * n_in))  # ortho normalization
    mat[0] *= np.sqrt(0.5)
    mat *= np.sqrt(2.0)
    mat = mat.astype(np.float32)
    mat.flags.writeable = False
    return mat


def power_to_db(s: torch.Tensor, amin: float = 1e-10, top_db: Optional[float] = 80.0,
                ref_db: Optional[float] = None) -> torch.Tensor:
    """10·log10(max(amin, s)) clipped to (ref − top_db), librosa's semantics
    (spectral.py:172-195).  With ref_db None the reference is the maximum
    over the last two axes (mels, frames) of each signal, which depends on
    future frames; a stream passes a fixed ref_db instead."""
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    if top_db is not None:
        if ref_db is None:
            ref = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
        else:
            ref = torch.as_tensor(ref_db, dtype=log_spec.dtype, device=log_spec.device)
        log_spec = torch.maximum(log_spec, ref - top_db)
    return log_spec


def amplitude_to_db(s: torch.Tensor, amin: float = 1e-5, top_db: Optional[float] = 80.0) -> torch.Tensor:
    """librosa's amplitude_to_db: power_to_db of s² with the floor amin²
    (spectral.py:197-199)."""
    return power_to_db(torch.square(s), amin=amin * amin, top_db=top_db)


def mfcc(signal: torch.Tensor, sample_rate: int, *, n_mfcc: int = 30, n_fft: int = 1024,
         hop_length: int = 512, fmin: float = 20.0, fmax: float = 8000.0, n_mels: int = 128,
         ref_db: Optional[float] = None) -> torch.Tensor:
    """MFCCs as librosa.feature.mfcc (spectral.py:214-245), (..., T) →
    (..., n_frames, n_mfcc): power spectrogram (centered reflect pad,
    periodic Hann, not normalized) → Slaney mel filterbank → power_to_db
    (top_db 80, reference `ref_db` or the global maximum) → orthonormal
    DCT-II, first n_mfcc coefficients."""
    power = torch.square(stft(signal, n_fft, hop_length, normalized=False))  # (..., bins, frames)
    fb = torch.tensor(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax), dtype=power.dtype,
                      device=power.device)
    mel = torch.einsum("mf,...ft->...mt", fb, power)
    mel_db = power_to_db(mel, amin=1e-10, top_db=80.0, ref_db=ref_db)
    dct = torch.tensor(dct_matrix(n_mfcc, n_mels), dtype=power.dtype, device=power.device)
    return torch.einsum("cm,...mt->...ct", dct, mel_db).transpose(-1, -2)
