"""Synthesizer modules: HarmonicSynth, FilteredNoise, Reverb.

Port of ddsp_pytorch_tpu/models/modules.py:22-185, keeping its
get_controls() → forward() split.  Audio is (B, T) float32 (float64 after
`.double()`, the CPU reference).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddsp_pytorch_tpu_torch import ops


class HarmonicSynth(nn.Module):
    """Harmonic oscillator bank (modules.py:22-85)."""

    def __init__(self, block_size: int, sample_rate: int):
        super().__init__()
        self.block_size = int(block_size)
        self.sample_rate = int(sample_rate)

    def get_controls(
        self,
        amplitudes: torch.Tensor,
        harmonic_distribution: torch.Tensor,
        f0: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """amplitudes (B,F,1), harmonic_distribution (B,F,K), f0 (B,F,1):
        exponentiated sigmoid, Nyquist mask, distribution normalized to 1."""
        amplitudes = ops.scale_function(amplitudes)
        harmonic_distribution = ops.scale_function(harmonic_distribution)
        harmonic_distribution = ops.remove_above_nyquist(
            harmonic_distribution, f0, self.sample_rate
        )
        harmonic_distribution = harmonic_distribution / torch.sum(
            harmonic_distribution, dim=-1, keepdim=True
        )
        return {
            "f0": f0,
            "harmonic_distribution": harmonic_distribution,
            "amplitudes": amplitudes,
        }

    def forward(
        self,
        amplitudes: torch.Tensor,
        harmonic_distribution: torch.Tensor,
        f0: torch.Tensor,
        phase0: Optional[torch.Tensor] = None,
        return_phase: bool = False,
    ):
        """Render (B, F·S) audio from controls; with return_phase also the
        (B,) phase carry."""
        return ops.harmonic_synth_frames(
            f0[..., 0],
            harmonic_distribution * amplitudes,
            self.block_size,
            self.sample_rate,
            phase0=phase0,
            return_phase=return_phase,
        )


class FilteredNoise(nn.Module):
    """Frame-wise FIR-filtered uniform noise (modules.py:88-140)."""

    def __init__(self, block_size: int, window_size: int, initial_bias: float = -5.0):
        super().__init__()
        self.block_size = int(block_size)
        self.window_size = int(window_size)
        self.initial_bias = float(initial_bias)

    def get_controls(self, magnitudes: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"magnitudes": ops.scale_function(magnitudes + self.initial_bias)}

    def forward(
        self,
        magnitudes: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """magnitudes (B, F, n_bands) → (B, F·S); noise (B, F, S) injected,
        else drawn from `generator`."""
        return ops.filtered_noise(
            magnitudes, self.block_size, noise=noise, generator=generator
        )


class Reverb(nn.Module):
    """Trainable convolution reverb (modules.py:143-185): a 1 s noise IR
    under a learned exponential decay and wet gain, dry tap = 1.

    Parameters start as placeholders (noise zeros); a bundle's weights
    replace them (weights.py), or init_params draws fresh ones."""

    def __init__(
        self,
        length: int,
        sample_rate: int,
        initial_wet: float = 0.0,
        initial_decay: float = 5.0,
    ):
        super().__init__()
        self.length = int(length)
        self.sample_rate = int(sample_rate)
        self.initial_wet = float(initial_wet)
        self.initial_decay = float(initial_decay)
        self.noise = nn.Parameter(torch.zeros(self.length))
        self.decay = nn.Parameter(torch.tensor(float(initial_decay)))
        self.wet = nn.Parameter(torch.tensor(float(initial_wet)))

    def build_impulse(self) -> torch.Tensor:
        """(length,) impulse: noise · exp-decay envelope · sigmoid(wet)."""
        # in the parameters' type: torch would not promote a float32 grid by
        # the 0-d decay
        t = torch.arange(self.length, dtype=self.noise.dtype, device=self.noise.device)
        t = t / self.sample_rate
        envelope = torch.exp(-F.softplus(-self.decay) * t * 500.0)
        impulse = self.noise * envelope * torch.sigmoid(self.wet)
        return torch.cat([torch.ones_like(impulse[:1]), impulse[1:]])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T) → (B, T); the IR is zero-padded to T, or truncated when
        the signal is shorter than it."""
        impulse = self.build_impulse()
        t = x.shape[-1]
        if t >= self.length:
            impulse = F.pad(impulse, (0, t - self.length))
        else:
            impulse = impulse[:t]
        return ops.fft_convolve(x, impulse[None, :])
