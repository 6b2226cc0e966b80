"""Multi-scale STFT spectral loss (port of ddsp_pytorch_tpu/training/
loss.py:21-55): for each FFT scale, the mean L1 distance between linear
magnitudes plus that between safe-log magnitudes, summed over scales.
Computed in float32, or in float64 where the reconstruction is (the CPU
reference).

Two paths compute it.  The plain one (`spectral_loss_from_signals`: the
STFTs of ops/spectral.py, then the means, with autograd's backward) runs on
the CPU, in float64, and wherever the spectrograms are wanted (the eval
step).  A train step's loss on the card (`spectral_loss`, float32 signals
with gradients enabled) runs the hand-written kernels around cuFFT of
ops/stft_loss.py, the same loss and gradient in five passes a scale; their
launches are counted in ops/kernels, and the plain path launches none."""

from __future__ import annotations

from typing import List, Sequence

import torch

from ddsp_pytorch_tpu_torch.ops import multiscale_fft, safe_log
from ddsp_pytorch_tpu_torch.ops.stft_loss import multiscale_spectral_loss


def multiscale_spec_loss(
    ori_stft: List[torch.Tensor], rec_stft: List[torch.Tensor]
) -> torch.Tensor:
    """Σ_scales [ mean|S_x − S_y| + mean|log S_x − log S_y| ]."""
    loss = torch.zeros((), dtype=ori_stft[0].dtype, device=ori_stft[0].device)
    for s_x, s_y in zip(ori_stft, rec_stft):
        lin = torch.mean(torch.abs(s_x - s_y))
        log = torch.mean(torch.abs(safe_log(s_x) - safe_log(s_y)))
        loss = loss + lin + log
    return loss


def spectral_loss_from_signals(
    target: torch.Tensor,
    reconstruction: torch.Tensor,
    scales: Sequence[int],
    overlap: float,
):
    """Both multiscale STFTs and the loss → (loss, ori_stft, rec_stft): the
    plain path."""
    _check_lengths(target, reconstruction)
    dtype = torch.promote_types(reconstruction.dtype, torch.float32)
    ori = multiscale_fft(target.to(dtype), scales, overlap)
    rec = multiscale_fft(reconstruction.to(dtype), scales, overlap)
    return multiscale_spec_loss(ori, rec), ori, rec


def spectral_loss(
    target: torch.Tensor,
    reconstruction: torch.Tensor,
    scales: Sequence[int],
    overlap: float,
) -> torch.Tensor:
    """The loss alone, as a train step takes it: through the fused kernels
    (ops/stft_loss.py) where `fused_takes`, else the plain path."""
    _check_lengths(target, reconstruction)
    if fused_takes(target, reconstruction):
        return multiscale_spectral_loss(target.float(), reconstruction.float(), scales, overlap)
    return spectral_loss_from_signals(target, reconstruction, scales, overlap)[0]


def fused_takes(target: torch.Tensor, reconstruction: torch.Tensor) -> bool:
    """Whether the fused kernels compute the loss: a reconstruction on the
    card that is float32 after the promotion to at least float32 (a bf16
    model's signal too), gradients enabled, and a target that wants none.
    The CPU, float64 and calls without gradients take the plain path."""
    return (reconstruction.is_cuda and torch.promote_types(reconstruction.dtype, torch.float32) == torch.float32
            and torch.is_grad_enabled() and not target.requires_grad)


def _check_lengths(target: torch.Tensor, reconstruction: torch.Tensor) -> None:
    if target.shape[-1] != reconstruction.shape[-1]:
        raise ValueError(
            f"target length {target.shape[-1]} != reconstruction length "
            f"{reconstruction.shape[-1]} — sig must be exactly "
            "n_frames * block_size samples"
        )
