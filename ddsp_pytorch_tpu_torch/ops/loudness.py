"""A-weighted loudness feature.

Port of ddsp_pytorch_tpu/ops/loudness.py:18-73 (`fft_frequencies`,
`a_weighting`, `extract_loudness`): a centered, reflect-padded, unnormalized
magnitude STFT (hop = block_size, periodic Hann) → log(mag + 1e-7) → plus the
IEC A-weighting curve of each bin (floored at −80 dB) → mean over bins →
the last frame dropped.  The weighting curve is a float64 numpy constant,
this package's own copy of the JAX function.

`log_magnitude_loudness` is RAVE v1's loudness (rave/core.py `Loudness`),
which its phase-1 loss compares by squared error: the same weighted
log-magnitude, every frame kept, differentiable and in the signal's dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.ops.spectral import stft


def fft_frequencies(sample_rate: float, n_fft: int) -> np.ndarray:
    """Center frequencies of the rfft bins: linspace(0, sr/2, 1 + n_fft//2)."""
    return np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)


def a_weighting(frequencies: np.ndarray, min_db: float = -80.0) -> np.ndarray:
    """IEC 61672 A-weighting curve in dB (librosa.A_weighting semantics),
    float64; the DC bin evaluates to −inf and is clamped at min_db."""
    f_sq = np.asanyarray(frequencies, dtype=np.float64) ** 2.0
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2.0
    with np.errstate(divide="ignore"):
        weights = 2.0 + 20.0 * (
            np.log10(const[0])
            + 2.0 * np.log10(np.where(f_sq > 0, f_sq, 1.0))
            + np.where(f_sq > 0, 0.0, -np.inf)
            - np.log10(f_sq + const[0])
            - np.log10(f_sq + const[1])
            - 0.5 * np.log10(f_sq + const[2])
            - 0.5 * np.log10(f_sq + const[3])
        )
    if min_db is not None:
        weights = np.maximum(min_db, weights)
    return weights


@functools.lru_cache(maxsize=None)
def _weights(sample_rate: int, n_fft: int) -> np.ndarray:
    weights = a_weighting(fft_frequencies(sample_rate, n_fft)).astype(np.float32)
    weights.flags.writeable = False
    return weights


@functools.lru_cache(maxsize=None)
def weights_tensor(sample_rate: int, n_fft: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The A-weighting of each bin (bins,), computed in float64 and rounded
    once to `dtype` on `device` (cached: a captured step copies nothing
    from the host).  Read-only: callers share the cached tensor."""
    return torch.tensor(a_weighting(fft_frequencies(sample_rate, n_fft)), dtype=dtype, device=device)


def log_magnitude_loudness(signal: torch.Tensor, sample_rate: int, n_fft: int = 2048,
                           hop: int = 512) -> torch.Tensor:
    """RAVE's loudness of (..., T) → (..., 1 + T // hop): the mean over
    bins of log(|STFT| + 1e-7) + A(f), the STFT centred, reflect-padded,
    Hann-windowed and not normalised; A the A-weighting in dB floored at
    −80, in the signal's dtype.  Differentiable."""
    mag = stft(signal, n_fft, hop, normalized=False)  # (..., bins, frames)
    weights = weights_tensor(int(sample_rate), int(n_fft), signal.dtype, signal.device)
    return torch.mean(torch.log(mag + 1e-7) + weights[:, None], dim=-2)


def extract_loudness(signal, sample_rate: int, block_size: int, n_fft: int = 2048, *,
                     device="cuda") -> torch.Tensor:
    """Frame-rate A-weighted log-loudness, (..., T) → (..., T // block_size)
    float32 on `device`: one frame a block (the STFT's 1 + T // hop frames,
    the last dropped).  `signal` is a numpy array or a tensor; it is moved
    to `device`, so the default needs a card."""
    device = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32).to(device)
    mag = stft(signal, n_fft, block_size, normalized=False)  # (..., bins, frames)
    log_mag = torch.log(mag + 1e-7)
    weights = torch.tensor(_weights(int(sample_rate), int(n_fft)), device=device)
    loud = torch.mean(log_mag + weights[:, None], dim=-2)
    return loud[..., :-1]
