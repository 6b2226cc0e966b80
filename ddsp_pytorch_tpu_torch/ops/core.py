"""Elementwise primitives of the DSP core.

Port of ddsp_pytorch_tpu/ops/core.py:24-117 (safe_log, scale_function,
remove_above_nyquist, the sample-rate upsample and resample,
mean_std_loudness).  Operation order follows the JAX functions so that
float32 results agree to rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_EPS = 1e-7


def safe_log(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """log(x + 1e-7) (ops/core.py:24-26)."""
    return torch.log(x + eps)


def scale_function(x: torch.Tensor) -> torch.Tensor:
    """Exponentiated sigmoid 2·sigmoid(x)^log(10) + 1e-7, in its log-sigmoid
    form exp(log(10)·log_sigmoid(x)) (ops/core.py:29-37)."""
    return 2.0 * torch.exp(math.log(10.0) * F.logsigmoid(x)) + _EPS


def remove_above_nyquist(
    amplitudes: torch.Tensor, f0: torch.Tensor, sample_rate: float
) -> torch.Tensor:
    """Scale harmonics k·f0 ≥ Nyquist to 1e-4 (ops/core.py:40-56).

    amplitudes (..., K); f0 (..., 1) in Hz, broadcastable to amplitudes.
    """
    n_harmonic = amplitudes.shape[-1]
    harm_numbers = torch.arange(
        1, n_harmonic + 1, dtype=amplitudes.dtype, device=amplitudes.device
    )
    pitches = f0 * harm_numbers
    mask = (pitches < sample_rate / 2.0).to(amplitudes.dtype) + 1e-4
    return amplitudes * mask


def upsample(signal: torch.Tensor, factor: int) -> torch.Tensor:
    """Frame rate → sample rate by nearest repeat along time (ops/core.py:59-66):
    (B, F, C) → (B, F·factor, C)."""
    return torch.repeat_interleave(signal, int(factor), dim=1)


def resample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Frame rate → sample rate by zero-stuffing and Hann overlap-add
    (ops/core.py:69-98): zero-stuff by `factor`, copy the last sample into
    the final slot, pad by `factor` on each side, cross-correlate with a
    periodic Hann of length 2·factor (F.conv1d does not flip its kernel)
    and drop the last sample.  (B, F, C) → (B, F·factor, C)."""
    batch, frames, channels = x.shape
    y = x.transpose(1, 2).reshape(batch * channels, frames)
    stuffed = x.new_zeros((batch * channels, frames * factor))
    stuffed[:, ::factor] = y
    stuffed[:, -1] = y[:, -1]
    n = torch.arange(2 * factor, dtype=x.dtype, device=x.device)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / (2 * factor)))
    padded = F.pad(stuffed, (factor, factor))
    out = F.conv1d(padded[:, None, :], window[None, None, :])[:, 0, :-1]
    return out.reshape(batch, channels, frames * factor).transpose(1, 2)


def batch_loudness_stats(loudness: torch.Tensor) -> torch.Tensor:
    """One batch's float32 loudness mean and std (ddof=1), as a (2,) tensor
    on the batch's device."""
    loudness = loudness.to(torch.float32)
    return torch.stack([loudness.mean(), loudness.std(unbiased=True)])


def running_mean_stats(per_batch) -> tuple:
    """The host-float running means of per-batch (mean, std) pairs, in
    batch order (ops/core.py:101-117)."""
    mean = 0.0
    std = 0.0
    for n, (m, s) in enumerate(per_batch, start=1):
        mean += (m - mean) / n
        std += (s - std) / n
    return mean, std


def mean_std_loudness(batches) -> tuple:
    """Running-mean estimate of loudness mean and std over an iterable of
    batches with a 'loudness' key (ops/core.py:101-117): the running mean of
    per-batch float32 means and of per-batch stds with ddof=1 — not the
    global std, as in the reference, because the stats are baked into
    exported models."""
    return running_mean_stats(
        batch_loudness_stats(torch.as_tensor(batch["loudness"])).tolist() for batch in batches
    )
