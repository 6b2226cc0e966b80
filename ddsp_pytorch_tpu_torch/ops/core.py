"""Elementwise primitives of the DSP core.

Port of ddsp_pytorch_tpu/ops/core.py:24-56 and :101-117 (safe_log,
scale_function, remove_above_nyquist, mean_std_loudness).  Operation order follows the JAX functions so that
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


def mean_std_loudness(batches) -> tuple:
    """Running-mean estimate of loudness mean and std over an iterable of
    batches with a 'loudness' key (ops/core.py:101-117): the running mean of
    per-batch float32 means and of per-batch stds with ddof=1 — not the
    global std, as in the reference, because the stats are baked into
    exported models."""
    mean = 0.0
    std = 0.0
    n = 0
    for batch in batches:
        loud = torch.as_tensor(batch["loudness"], dtype=torch.float32)
        n += 1
        mean += (float(loud.mean()) - mean) / n
        std += (float(loud.std(unbiased=True)) - std) / n
    return mean, std
