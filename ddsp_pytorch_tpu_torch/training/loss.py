"""Multi-scale STFT spectral loss (port of ddsp_pytorch_tpu/training/
loss.py:21-55): for each FFT scale, the mean L1 distance between linear
magnitudes plus that between safe-log magnitudes, summed over scales.
Computed in float32."""

from __future__ import annotations

from typing import List, Sequence

import torch

from ddsp_pytorch_tpu_torch.ops import multiscale_fft, safe_log


def multiscale_spec_loss(
    ori_stft: List[torch.Tensor], rec_stft: List[torch.Tensor]
) -> torch.Tensor:
    """Σ_scales [ mean|S_x − S_y| + mean|log S_x − log S_y| ]."""
    loss = torch.zeros((), dtype=torch.float32, device=ori_stft[0].device)
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
    """Both multiscale STFTs and the loss → (loss, ori_stft, rec_stft)."""
    if target.shape[-1] != reconstruction.shape[-1]:
        raise ValueError(
            f"target length {target.shape[-1]} != reconstruction length "
            f"{reconstruction.shape[-1]} — sig must be exactly "
            "n_frames * block_size samples"
        )
    ori = multiscale_fft(target.float(), scales, overlap)
    rec = multiscale_fft(reconstruction.float(), scales, overlap)
    return multiscale_spec_loss(ori, rec), ori, rec
