"""FIR filter design + FFT convolution (filtered noise & reverb).

Port of ddsp_pytorch_tpu/ops/filters.py:29-99.  The JAX package has no
Pallas kernel here; the FFTs run on torch.fft (cuFFT on the GPU).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ddsp_pytorch_tpu_torch.ops.spectral import hann_window


def amp_to_impulse_response(amp: torch.Tensor, target_size: int) -> torch.Tensor:
    """(..., n_bands) zero-phase magnitudes → (..., target_size) linear-phase
    FIR stored causally from index 0 with its tail wrapped (filters.py:29-53).
    """
    # complex64 as in the JAX function; complex128 for float64 magnitudes
    complex_dtype = torch.complex128 if amp.dtype == torch.float64 else torch.complex64
    impulse = torch.fft.irfft(amp.to(complex_dtype))
    filter_size = impulse.shape[-1]  # 2 * (n_bands - 1)
    impulse = torch.roll(impulse, filter_size // 2, dims=-1)
    impulse = impulse * hann_window(filter_size, impulse.dtype, impulse.device)
    impulse = F.pad(impulse, (0, int(target_size) - filter_size))
    return torch.roll(impulse, -(filter_size // 2), dims=-1)


def fft_convolve(signal: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Both (..., N) → (..., N): signal padded right and kernel left to 2N,
    irfft(rfft·rfft), second half kept (filters.py:56-70)."""
    n = signal.shape[-1]
    signal = F.pad(signal, (0, n))
    kernel = F.pad(kernel, (kernel.shape[-1], 0))
    out = torch.fft.irfft(torch.fft.rfft(signal) * torch.fft.rfft(kernel))
    return out[..., out.shape[-1] // 2 :]


def uniform_noise(shape, generator: Optional[torch.Generator], dtype, device) -> torch.Tensor:
    """Uniform noise in [-1, 1) drawn from `generator`: the draw
    `filtered_noise` makes when no noise is injected.  A caller that draws
    the noise ahead of the step (the captured train step) calls this with
    the same arguments, so the values and the generator's advance are the
    same."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device) * 2.0 - 1.0


def filtered_noise(
    magnitudes: torch.Tensor,
    block_size: int,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Frame-wise FIR of uniform noise in [-1, 1) (filters.py:73-99).

    magnitudes (B, F, n_bands); noise (B, F, block_size) if injected, else
    drawn from `generator` (which must live on magnitudes' device).
    Returns (B, F * block_size).
    """
    b, f, _ = magnitudes.shape
    impulse = amp_to_impulse_response(magnitudes, block_size)
    if noise is None:
        noise = uniform_noise((b, f, block_size), generator, magnitudes.dtype, magnitudes.device)
    out = fft_convolve(noise, impulse)
    return out.reshape(b, f * block_size)
