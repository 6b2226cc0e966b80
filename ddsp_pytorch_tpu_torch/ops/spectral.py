"""Spectral helpers.  Port of ddsp_pytorch_tpu/ops/spectral.py:26-29
(`hann_window`) — the only spectral op the serving path needs."""

from __future__ import annotations

import math

import torch


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window 0.5·(1 − cos(2π i / n))."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n))
