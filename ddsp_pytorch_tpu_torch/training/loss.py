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
launches are counted in ops/kernels, and the plain path launches none.

RAVE v1's phase-1 loss (`rave_loss`, models/rave.py) takes the same two
paths for its distance D: `rave_distance` through the fused kernels'
"rave" form where `fused_takes`, else `rave_distance_plain`."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ddsp_pytorch_tpu_torch.ops import multiscale_fft, safe_log
from ddsp_pytorch_tpu_torch.ops.loudness import log_magnitude_loudness
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


# ------------------------------------------------------------------ RAVE
def rave_distance_plain(x: torch.Tensor, y: torch.Tensor, scales: Sequence[int], overlap: float) -> torch.Tensor:
    """RAVE's distance D of signals x (target) and y (..., T), every row a
    signal: Σ_scales ‖S_x − S_y‖_F / ‖S_x‖_F + mean|log(S_x + ε) − log(S_y
    + ε)|, each norm and mean over the whole scale; the plain STFTs."""
    _check_lengths(x, y)
    ori = multiscale_fft(x.reshape(-1, x.shape[-1]), scales, overlap)
    rec = multiscale_fft(y.reshape(-1, y.shape[-1]), scales, overlap)
    loss = torch.zeros((), dtype=y.dtype, device=y.device)
    for s_x, s_y in zip(ori, rec):
        lin = torch.linalg.vector_norm(s_x - s_y) / torch.linalg.vector_norm(s_x)
        log = torch.mean(torch.abs(safe_log(s_x) - safe_log(s_y)))
        loss = loss + lin + log
    return loss


def rave_distance(x: torch.Tensor, y: torch.Tensor, scales: Sequence[int], overlap: float) -> torch.Tensor:
    """D through the fused kernels' "rave" form where `fused_takes`, else
    the plain path."""
    _check_lengths(x, y)
    if fused_takes(x, y):
        t = y.shape[-1]
        return multiscale_spectral_loss(x.reshape(-1, t).float(), y.reshape(-1, t).float(), scales, overlap,
                                        form="rave")
    return rave_distance_plain(x, y, scales, overlap)


def rave_loss(model, bands: torch.Tensor, rec_bands: torch.Tensor, kl: torch.Tensor, scales: Sequence[int],
              overlap: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RAVE v1's phase-1 loss and its terms for `model` (models/rave.py:
    its bank, loudness STFT, sample rate and kl_beta): D(X, Y) over the
    bands X (the target's, B × M rows), D(P⁻¹X, P⁻¹Y) over the bank's
    reconstructions, mean((ℓ(P⁻¹X) − ℓ(P⁻¹Y))²) of the loudness ℓ
    (ops/loudness.py `log_magnitude_loudness`), and kl_beta·KL."""
    x, y = model.pqmf.synthesis(bands)[:, 0], model.pqmf.synthesis(rec_bands)[:, 0]
    terms = {"multiband": rave_distance(bands, rec_bands, scales, overlap),
             "fullband": rave_distance(x, y, scales, overlap)}
    loud = [log_magnitude_loudness(s, model.sample_rate, model.loudness_n_fft, model.loudness_hop) for s in (x, y)]
    terms["loudness"] = torch.mean((loud[0] - loud[1]) ** 2)
    terms["kl"] = kl
    loss = terms["multiband"] + terms["fullband"] + terms["loudness"] + model.kl_beta * kl
    return loss, terms
