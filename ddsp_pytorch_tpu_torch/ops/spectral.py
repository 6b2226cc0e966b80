"""Spectral ops: Hann window, framing, STFT, multi-scale magnitude STFT.

Port of ddsp_pytorch_tpu/ops/spectral.py:26-92.  The STFT keeps the JAX
function's (and torch.stft's) conventions: centered reflect pad of n_fft/2,
periodic Hann window, × n_fft^-1/2 normalization, (..., bins, frames)
layout.  The JAX package computes these outside any Pallas kernel, so the
port frames with `Tensor.unfold` and transforms with torch.fft (cuFFT on
the GPU).
"""

from __future__ import annotations

import math
from typing import List, Sequence

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


def stft(signal: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Magnitude STFT of a real (..., T) signal → (..., n_fft//2 + 1,
    n_frames), as the JAX `stft` with its defaults (spectral.py:48-80):
    centered, normalized, magnitude.  The reflect pad needs T > n_fft/2."""
    pad = n_fft // 2
    lead = signal.shape[:-1]
    # F.pad's reflect mode wants a (N, C, T) input
    signal = F.pad(signal.reshape(-1, 1, signal.shape[-1]), (pad, pad), mode="reflect")
    signal = signal.reshape(*lead, signal.shape[-1])
    frames = frame_signal(signal, n_fft, hop_length)
    frames = frames * hann_window(n_fft, signal.dtype, signal.device)
    spec = torch.fft.rfft(frames, dim=-1) * (1.0 / math.sqrt(n_fft))
    return spec.transpose(-1, -2).abs()


def multiscale_fft(
    signal: torch.Tensor, scales: Sequence[int], overlap: float
) -> List[torch.Tensor]:
    """Magnitude STFTs at each FFT size in `scales`, hop = int(s·(1 −
    overlap)) (spectral.py:83-92)."""
    return [stft(signal, s, int(s * (1.0 - overlap))) for s in scales]
