"""Harmonic oscillator bank — the hand-written forward and backward kernels.

Port of ddsp_pytorch_tpu/ops/oscillator.py.  Phase is frame-factored
exactly as there (`:1-38`): f0 is constant within a frame, so

    theta[b, j·S + i] = phi[b, j] + (i+1)·omega[b, j],
    phi[b, j] = (Σ_{m<j} S·omega[b, m]) mod 2π,

and the bank y = Σ_k A_k·sin(k·theta) runs on independent rows (one row =
one frame of one batch item) through the Chebyshev recurrence
sin kθ = 2cosθ·sin(k−1)θ − sin(k−2)θ.

`oscillator_bank` and `oscillator_bank_bwd` are the two dispatch points: a
CPU tensor goes to the plain PyTorch version (`oscillator_bank_plain`, the
same arithmetic as the JAX XLA path `_harmonic_synth_frames_xla`,
`:117-146`; `oscillator_bank_bwd_plain`, that of the Pallas `_bwd_kernel`),
a CUDA tensor launches the hand-written kernel
(`ops/kernels/oscillator_fwd.cu`, `oscillator_bwd.cu`, the ports of
`ops/pallas_kernels/oscillator.py::_fwd_kernel` and `::_bwd_kernel`).
Nothing falls back.  `OscillatorBank` joins the two as one autograd
function, the counterpart of the Pallas pair's `_osc_rows` custom_vjp: it
saves φ, ω, A and recomputes the sines in backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ddsp_pytorch_tpu_torch.ops import kernels

TWO_PI = 2.0 * math.pi


def phase_accumulate_frames(
    f0: torch.Tensor, block_size: int, sample_rate: float, phase0=None
):
    """Frame-start phases for frame-rate f0 (oscillator.py:49-75).

    f0 (B, F) Hz; phase0 optional (B,) carry.  Returns (phi (B, F), phase_out
    (B,)), both wrapped to [0, 2π).  Each frame's increment is wrapped mod 2π
    *before* the cumsum, which keeps f32 phase exact over long signals.
    """
    omega = 2.0 * math.pi * f0 / sample_rate
    dphi = block_size * omega
    inc = torch.cumsum(torch.remainder(dphi, TWO_PI), dim=-1)
    phi = torch.remainder(F.pad(inc[..., :-1], (1, 0)), TWO_PI)
    if phase0 is not None:
        phi = torch.remainder(phi + phase0[..., None], TWO_PI)
        phase_out = torch.remainder(inc[..., -1] + phase0, TWO_PI)
    else:
        phase_out = torch.remainder(inc[..., -1], TWO_PI)
    return phi, phase_out


def oscillator_bank_plain(
    phi: torch.Tensor, omega: torch.Tensor, amp: torch.Tensor, block_size: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: rows (R,), (R,), (R, K) → (R, S).

    The Chebyshev bank of oscillator.py:117-146, materializing (R, S) per
    step and never (R, S, K).
    """
    ramp = torch.arange(1, block_size + 1, dtype=phi.dtype, device=phi.device)
    theta = phi[:, None] + omega[:, None] * ramp
    s_curr = torch.sin(theta)
    two_c = 2.0 * torch.cos(theta)
    s_prev = torch.zeros_like(s_curr)
    acc = torch.zeros_like(s_curr)
    for j in range(amp.shape[-1]):
        acc = acc + amp[:, j : j + 1] * s_curr
        s_prev, s_curr = s_curr, two_c * s_curr - s_prev
    return acc


def oscillator_bank_bwd_plain(
    phi: torch.Tensor,
    omega: torch.Tensor,
    amp: torch.Tensor,
    grad: torch.Tensor,
    block_size: int,
):
    """Plain PyTorch version of the backward kernel: rows (R,), (R,), (R, K)
    and the audio cotangent (R, S) → (dphi (R,), domega (R,), damp (R, K)).

    The arithmetic of the Pallas `_bwd_kernel` (pallas_kernels/oscillator.py
    :60-88): the sin recurrence and its cos twin, recomputed;
    dA_k = Σ_i g·sin kθ, dθ = g·Σ_k k·A_k·cos kθ, dφ = Σ_i dθ,
    dω = Σ_i (i+1)·dθ.  Materializes (R, S) per step, never (R, S, K).
    """
    ramp = torch.arange(1, block_size + 1, dtype=phi.dtype, device=phi.device)
    theta = phi[:, None] + omega[:, None] * ramp
    s_curr = torch.sin(theta)
    c_curr = torch.cos(theta)
    two_c = 2.0 * c_curr
    s_prev = torch.zeros_like(s_curr)
    c_prev = torch.ones_like(c_curr)
    fac = torch.zeros_like(s_curr)
    damp = []
    for j in range(amp.shape[-1]):
        damp.append(torch.sum(grad * s_curr, dim=-1))
        fac = fac + float(j + 1) * amp[:, j : j + 1] * c_curr
        s_prev, s_curr = s_curr, two_c * s_curr - s_prev
        c_prev, c_curr = c_curr, two_c * c_curr - c_prev
    dtheta = grad * fac
    return (
        torch.sum(dtheta, dim=-1),
        torch.sum(dtheta * ramp, dim=-1),
        torch.stack(damp, dim=-1),
    )


# Shared memory holds a row's K amplitudes: 48 KB without opting in to more.
MAX_KERNEL_HARMONICS = 48 * 1024 // 4
# The backward kernel also keeps one K-vector of partial sums per warp (16
# warps at S = 512) and two per-warp scalars: (48 KB/4 − 2·16) / (1 + 16).
MAX_BWD_KERNEL_HARMONICS = (48 * 1024 // 4 - 2 * 16) // (1 + 16)


def _check_rows(phi, omega, amp, block_size, grad=None) -> int:
    """Validate the row tensors of either kernel; returns block_size."""
    if phi.dim() != 1 or omega.shape != phi.shape or amp.dim() != 2 or amp.shape[0] != phi.shape[0]:
        raise ValueError(
            f"need phi (R,), omega (R,), amp (R, K); got {tuple(phi.shape)}, "
            f"{tuple(omega.shape)}, {tuple(amp.shape)}"
        )
    block_size = int(block_size)
    named = [("phi", phi), ("omega", omega), ("amp", amp)]
    if grad is not None:
        if grad.shape != (phi.shape[0], block_size):
            raise ValueError(
                f"need grad (R, S) = ({phi.shape[0]}, {block_size}); got {tuple(grad.shape)}"
            )
        named.append(("grad", grad))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != phi.device:
            raise ValueError(f"{name} is on {t.device}, phi on {phi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_size < 1 or amp.shape[1] < 1:
        raise ValueError("need block_size ≥ 1 and K ≥ 1")
    if phi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {phi.device}")
    return block_size


def oscillator_bank(
    phi: torch.Tensor, omega: torch.Tensor, amp: torch.Tensor, block_size: int
) -> torch.Tensor:
    """The oscillator bank on rows: phi (R,), omega (R,), amp (R, K), all
    float32 and contiguous on one device → audio (R, block_size).

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count the launch in `oscillator_bank.launches`.
    """
    block_size = _check_rows(phi, omega, amp, block_size)
    if phi.device.type == "cpu":
        return oscillator_bank_plain(phi, omega, amp, block_size)
    rows, n_harmonic = amp.shape
    if n_harmonic > MAX_KERNEL_HARMONICS:
        raise ValueError(f"kernel takes K ≤ {MAX_KERNEL_HARMONICS}, got {n_harmonic}")
    out = torch.empty((rows, block_size), dtype=torch.float32, device=phi.device)
    if rows == 0:
        return out
    launch = kernels.launcher("oscillator_fwd")
    with torch.cuda.device(phi.device):
        err = launch(
            phi.data_ptr(), omega.data_ptr(), amp.data_ptr(), out.data_ptr(),
            rows, n_harmonic, block_size,
            torch.cuda.current_stream(phi.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"oscillator_fwd launch failed: cudaError {err}")
    oscillator_bank.launches += 1
    return out


oscillator_bank.launches = 0


def oscillator_bank_bwd(
    phi: torch.Tensor,
    omega: torch.Tensor,
    amp: torch.Tensor,
    grad: torch.Tensor,
    block_size: int,
):
    """The bank's backward on rows: phi (R,), omega (R,), amp (R, K) and the
    audio cotangent grad (R, block_size), all float32 and contiguous on one
    device → (dphi (R,), domega (R,), damp (R, K)).

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count the launch in `oscillator_bank_bwd.launches`.
    """
    block_size = _check_rows(phi, omega, amp, block_size, grad)
    if phi.device.type == "cpu":
        return oscillator_bank_bwd_plain(phi, omega, amp, grad, block_size)
    rows, n_harmonic = amp.shape
    if n_harmonic > MAX_BWD_KERNEL_HARMONICS:
        raise ValueError(
            f"backward kernel takes K ≤ {MAX_BWD_KERNEL_HARMONICS}, got {n_harmonic}"
        )
    dphi = torch.empty((rows,), dtype=torch.float32, device=phi.device)
    domega = torch.empty((rows,), dtype=torch.float32, device=phi.device)
    damp = torch.empty((rows, n_harmonic), dtype=torch.float32, device=phi.device)
    if rows == 0:
        return dphi, domega, damp
    launch = kernels.launcher("oscillator_bwd")
    with torch.cuda.device(phi.device):
        err = launch(
            phi.data_ptr(), omega.data_ptr(), amp.data_ptr(), grad.data_ptr(),
            dphi.data_ptr(), domega.data_ptr(), damp.data_ptr(),
            rows, n_harmonic, block_size,
            torch.cuda.current_stream(phi.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"oscillator_bwd launch failed: cudaError {err}")
    oscillator_bank_bwd.launches += 1
    return dphi, domega, damp


oscillator_bank_bwd.launches = 0


class OscillatorBank(torch.autograd.Function):
    """The bank on rows with its analytic backward: `oscillator_bank` forward,
    `oscillator_bank_bwd` backward (the kernels on CUDA tensors, the plain
    versions on CPU tensors).  Saves φ, ω, A only; the sines are recomputed
    in backward, as in the Pallas pair (pallas_kernels/oscillator.py
    :126-181)."""

    @staticmethod
    def forward(ctx, phi, omega, amp, block_size):
        ctx.save_for_backward(phi, omega, amp)
        ctx.block_size = int(block_size)
        return oscillator_bank(phi, omega, amp, block_size)

    @staticmethod
    def backward(ctx, grad):
        phi, omega, amp = ctx.saved_tensors
        # the cotangent can arrive non-contiguous from the reshapes around
        # the bank
        dphi, domega, damp = oscillator_bank_bwd(
            phi, omega, amp, grad.contiguous(), ctx.block_size
        )
        return dphi, domega, damp, None


def synth_from_phases(
    f0: torch.Tensor,
    amplitudes: torch.Tensor,
    phi: torch.Tensor,
    block_size: int,
    sample_rate: float,
) -> torch.Tensor:
    """(B, F) f0, (B, F, K) amplitudes, (B, F) frame-start phases →
    (B, F·S) audio (oscillator.py:191-218, harmonic_synth_pallas:184-214):
    flatten batch and frames to rows and run the bank.  ω = 2π/sr·f0 stays
    in differentiable torch, so dω and dφ chain to df0 through autograd."""
    b, f = f0.shape
    k = amplitudes.shape[-1]
    omega = (2.0 * math.pi / sample_rate) * f0
    audio = OscillatorBank.apply(
        phi.reshape(b * f).float().contiguous(),
        omega.reshape(b * f).float().contiguous(),
        amplitudes.reshape(b * f, k).float().contiguous(),
        block_size,
    )
    return audio.reshape(b, f * block_size)


def harmonic_synth_frames(
    f0: torch.Tensor,
    amplitudes: torch.Tensor,
    block_size: int,
    sample_rate: float,
    *,
    phase0: Optional[torch.Tensor] = None,
    return_phase: bool = False,
):
    """Harmonic bank from frame-rate controls (oscillator.py:221-253).

    f0 (B, F) or (B, F, 1) Hz; amplitudes (B, F, K), already scaled and
    masked; phase0 optional (B,) carry.  Returns (B, F·S) audio, and the
    phase carry when return_phase.
    """
    if f0.dim() == 3:
        f0 = f0[..., 0]
    phi, phase_out = phase_accumulate_frames(f0, block_size, sample_rate, phase0)
    audio = synth_from_phases(f0, amplitudes, phi, block_size, sample_rate)
    if return_phase:
        return audio, phase_out
    return audio
