"""Uniform partitioned convolution (a frequency-domain delay line).

Port of ddsp_pytorch_tpu/ops/partitioned_conv.py:28-102, the streaming
form of the reverb's causal FFT convolution (ops/filters.py
`fft_convolve`).  The length-L impulse is split into P = ⌈L/B⌉ block-sized
partitions whose 2B-point spectra form a delay line; each block t gives

    y_t = Σ_p  last-B-samples( irfft( IR_p ⊙ X_{t−p} ) ),
    X_t = rfft([x_{t−1}; x_t])          (overlap-save)

so streamed output equals the offline convolution.  All k blocks of a
chunk are transformed at once and reduced over the partitions in one
product, as in the JAX function.  The JAX package has no Pallas kernel
here: it is XLA's FFT there and torch.fft (cuFFT on the GPU) here, in
complex64.

State per stream: x_hist (..., P, B+1) complex, newest first, and the
previous input block prev (..., B).  The functions are pure: a call
returns a new state and leaves the one passed in as it was.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class PartitionedIR(NamedTuple):
    spectra: torch.Tensor  # (P, B+1) complex64: rfft(2B) of each partition
    block: int


class ConvState(NamedTuple):
    x_hist: torch.Tensor  # (..., P, B+1) complex64, newest at index 0
    prev: torch.Tensor  # (..., B) the previous input block


def partition_ir(ir: torch.Tensor, block: int) -> PartitionedIR:
    """Split a (L,) impulse response into 2B-point partition spectra."""
    block = int(block)
    length = ir.shape[-1]
    p = -(-length // block)
    parts = F.pad(ir.to(torch.float32), (0, p * block - length)).reshape(p, block)
    # zero-pad each partition to 2B on the right: a linear convolution each
    parts = F.pad(parts, (0, block))
    return PartitionedIR(spectra=torch.fft.rfft(parts, dim=-1), block=block)


def init_state(pir: PartitionedIR, batch_shape: Tuple[int, ...] = ()) -> ConvState:
    p, bins = pir.spectra.shape
    device = pir.spectra.device
    return ConvState(
        x_hist=torch.zeros(tuple(batch_shape) + (p, bins), dtype=torch.complex64, device=device),
        prev=torch.zeros(tuple(batch_shape) + (pir.block,), dtype=torch.float32, device=device),
    )


def streaming_convolve(pir: PartitionedIR, state: ConvState, x: torch.Tensor):
    """Convolve n = k·B samples, (..., n) → ((..., n), new state): the causal
    linear convolution y[t] = Σ_{τ≤t} ir[τ]·x[t−τ], continued across calls."""
    b = pir.block
    n = x.shape[-1]
    if n % b:
        raise ValueError(f"chunk of {n} samples is not a multiple of the partition block {b}")
    k = n // b
    p = pir.spectra.shape[0]
    lead = x.shape[:-1]
    blocks = x.reshape(lead + (k, b))

    # 2B overlap-save buffers per block: [x_{t-1}; x_t]
    prev_blocks = torch.cat([state.prev[..., None, :], blocks[..., :-1, :]], dim=-2)
    x_spec = torch.fft.rfft(torch.cat([prev_blocks, blocks], dim=-1), dim=-1)  # (..., k, B+1)

    # time order: the P-1 newest history spectra (oldest first), then this
    # chunk's k spectra
    x_all = torch.cat([state.x_hist[..., :-1, :].flip(-2), x_spec], dim=-2)  # (..., P-1+k, bins)
    # X_{t-p} = x_all[P-1 + t - p] for t < k, p < P
    dev = x_all.device
    idx = (p - 1) + torch.arange(k, device=dev)[:, None] - torch.arange(p, device=dev)[None, :]
    windows = x_all[..., idx, :]  # (..., k, P, bins)
    y_spec = torch.sum(pir.spectra * windows, dim=-2)  # (..., k, bins)
    y = torch.fft.irfft(y_spec, n=2 * b, dim=-1)[..., b:]  # (..., k, B)

    new_hist = x_all.flip(-2)[..., :p, :]  # the newest P spectra, newest first
    return y.reshape(lead + (n,)), ConvState(x_hist=new_hist, prev=blocks[..., -1, :])
