"""Monophonic pitch tracking: YIN on a log pitch grid, smoothed by Viterbi.

Port of ddsp_pytorch_tpu/ops/pitch.py:28-245 (`_frame_centered`, `cmndf`,
`_pitch_grid`, `yin_emission`, `_viterbi`, `_track`, `extract_pitch`).  The
cumulative-mean-normalized difference function of each center-padded frame
comes from one FFT cross-correlation; it is read on a log-spaced grid by
quadratic interpolation in lag, with a small per-octave penalty against
subharmonics; a min-sum Viterbi over the grid with a jump cost of 0.6 per
octave picks the path, and a parabola through the path bin's neighbours
refines it.

Every frame of a batch of signals is processed at once on the tensors'
device (the JAX function takes one signal; its preprocessing loops over
chunks).  The Viterbi's forward recursion is a loop over frames on the
device, batched over signals, with each argmin taken as the first index
that reaches the minimum (exact on any device, as jnp.argmin picks); the
backtrack runs on the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ddsp_pytorch_tpu_torch import resolve_device

# the Viterbi's jump cost, per octave between adjacent frames (pitch.py:184)
SWITCH_PER_OCTAVE = 0.6
# the subharmonic penalty, per octave of lag above the grid's smallest
# (pitch.py:162)
SUBHARMONIC_PER_OCTAVE = 0.02


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def frame_centered(signal: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Center-padded framing (..., T) → (..., 1 + T // hop, frame_length):
    frame i covers [i·hop − L/2, i·hop + L/2) of the reflect-padded signal
    (pitch.py:32-39).  The reflect pad needs T > L/2."""
    t = signal.shape[-1]
    pad = frame_length // 2
    lead = signal.shape[:-1]
    padded = F.pad(signal.reshape(-1, 1, t), (pad, pad), mode="reflect").reshape(*lead, t + 2 * pad)
    n_frames = 1 + t // hop
    idx = (torch.arange(n_frames, device=signal.device)[:, None] * hop
           + torch.arange(frame_length, device=signal.device)[None, :])
    return padded[..., idx]


def cmndf(frames: torch.Tensor, window: int, tau_max: int) -> torch.Tensor:
    """Cumulative-mean-normalized difference function of each frame
    (pitch.py:42-78): (..., L) frames with L ≥ window + tau_max →
    (..., tau_max + 1) d'(τ), with d'(0) = 1, in float32."""
    frames = frames.to(torch.float32)
    head = frames[..., :window]
    # C(τ) = Σ_{j<W} x_j · x_{j+τ} by FFT cross-correlation
    n_fft = _next_pow2(frames.shape[-1] + window)
    spec_full = torch.fft.rfft(frames, n_fft)
    spec_head = torch.fft.rfft(head, n_fft)
    corr = torch.fft.irfft(spec_full * torch.conj(spec_head), n_fft)[..., : tau_max + 1]
    # E0 = Σ_{j<W} x_j², E(τ) = Σ_{j=τ}^{τ+W−1} x_j², from an exclusive prefix sum
    csum = F.pad(torch.cumsum(torch.square(frames), dim=-1), (1, 0))
    taus = torch.arange(tau_max + 1, device=frames.device)
    energy_tau = csum[..., taus + window] - csum[..., taus]
    energy0 = energy_tau[..., :1]
    diff = torch.clamp(energy0 + energy_tau - 2.0 * corr, min=0.0)  # d(τ)
    # d'(τ) = d(τ)·τ / Σ_{j≤τ} d(j)
    cum = torch.cumsum(diff[..., 1:], dim=-1)
    norm = diff[..., 1:] * taus[1:] / torch.clamp(cum, min=1e-12)
    return torch.cat([torch.ones_like(diff[..., :1]), norm], dim=-1)


@functools.lru_cache(maxsize=None)
def pitch_grid(fmin: float, fmax: float, bins_per_octave: int) -> np.ndarray:
    """The log-spaced pitch grid in Hz, float64 (pitch.py:81-84).
    Read-only: callers share the cached array."""
    n_bins = int(math.ceil(bins_per_octave * math.log2(fmax / fmin))) + 1
    grid = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    grid.flags.writeable = False
    return grid


def yin_emission(signal: torch.Tensor, sample_rate: int, block_size: int, fmin: float = 50.0,
                 fmax: float = 2000.0, frame_length: int = 2048,
                 bins_per_octave: int = 60) -> torch.Tensor:
    """Per-frame YIN emission costs on the log pitch grid (pitch.py:117-167):
    (..., T) → (..., 1 + T // block_size, n_bins), the CMNDF read on the
    grid by quadratic interpolation in lag, floored at 0, plus the
    subharmonic penalty."""
    tau_max = int(math.ceil(sample_rate / fmin))
    frames = frame_centered(signal.to(torch.float32), frame_length + tau_max, block_size)
    d = cmndf(frames, frame_length, tau_max)  # (..., F, tau_max + 1)
    grid = pitch_grid(fmin, fmax, bins_per_octave)
    taus = sample_rate / grid  # fractional lags, descending
    k = np.clip(np.round(taus).astype(np.int32), 1, tau_max - 1)
    delta = torch.tensor((taus - k).astype(np.float32), device=d.device)  # in [−0.5, 0.5]
    k = torch.tensor(k.astype(np.int64), device=d.device)
    dm, d0, dp = d[..., k - 1], d[..., k], d[..., k + 1]
    emis = d0 + 0.5 * delta * (dp - dm) + 0.5 * torch.square(delta) * (dp - 2.0 * d0 + dm)
    emis = torch.clamp(emis, min=0.0)
    penalty = (SUBHARMONIC_PER_OCTAVE * np.log2(taus / taus.min())).astype(np.float32)
    return emis + torch.tensor(penalty, device=d.device)


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The first index at which `x` reaches its minimum along `dim` (ties to
    the lowest index, as jnp.argmin), exact on every device."""
    lowest = torch.amin(x, dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    index = torch.arange(n, device=x.device).reshape(shape)
    return torch.amin(torch.where(x == lowest, index, n), dim=dim)


def switch_cost(n_bins: int, bins_per_octave: float, per_octave: float = SWITCH_PER_OCTAVE) -> np.ndarray:
    """The (n_bins, n_bins) float32 jump cost: `per_octave` × the distance
    in octaves (pitch.py:180-185; models/crepe.py's decoders use their own
    per-octave cost on the 60-bin-an-octave cents grid)."""
    dist = np.abs(np.arange(n_bins)[:, None] - np.arange(n_bins)[None, :]) / bins_per_octave
    return (per_octave * dist).astype(np.float32)


def viterbi(emission: torch.Tensor, switch: torch.Tensor) -> np.ndarray:
    """Min-sum Viterbi over (..., F, n_bins) emission costs with an (n_bins,
    n_bins) transition cost (pitch.py:87-114): the forward recursion as a
    loop over frames on the emission's device, the backtrack on the host.
    Returns the (..., F) int64 best paths (numpy)."""
    lead, n_frames, n_bins = emission.shape[:-2], emission.shape[-2], emission.shape[-1]
    emis = emission.reshape(-1, n_frames, n_bins)
    cost = emis[:, 0]
    back = []
    for t in range(1, n_frames):
        total = cost[:, :, None] + switch  # (N, bins_prev, bins)
        back.append(first_argmin(total, dim=1))
        cost = torch.amin(total, dim=1) + emis[:, t]
    last = first_argmin(cost, dim=1).cpu().numpy()
    back = torch.stack(back, dim=1).cpu().numpy() if back else np.zeros((emis.shape[0], 0, n_bins), np.int64)
    path = np.empty((emis.shape[0], n_frames), np.int64)
    path[:, -1] = last
    rows = np.arange(emis.shape[0])
    for t in range(n_frames - 2, -1, -1):
        path[:, t] = back[rows, t, path[:, t + 1]]
    return path.reshape(*lead, n_frames)


def track(signal: torch.Tensor, sample_rate: int, block_size: int, fmin: float, fmax: float,
          frame_length: int, bins_per_octave: int) -> torch.Tensor:
    """f0 of every center-padded frame, (..., T) → (..., 1 + T // block_size)
    Hz (pitch.py:170-220): the Viterbi path through the YIN emission,
    refined by a parabola through the path bin's neighbours where that bin is
    a local minimum, not at the grid's edges."""
    grid = pitch_grid(fmin, fmax, bins_per_octave)
    n_bins = grid.shape[0]
    emis = yin_emission(signal, sample_rate, block_size, fmin, fmax, frame_length, bins_per_octave)
    switch = torch.tensor(switch_cost(n_bins, bins_per_octave), device=emis.device)
    path = torch.as_tensor(viterbi(emis, switch)).to(emis.device)
    pm = torch.clamp(path - 1, 0, n_bins - 1)
    pp = torch.clamp(path + 1, 0, n_bins - 1)
    em, e0, ep = (torch.gather(emis, -1, p[..., None])[..., 0] for p in (pm, path, pp))
    denom = em - 2.0 * e0 + ep
    delta = torch.where(denom > 1e-12, 0.5 * (em - ep) / torch.clamp(denom, min=1e-12),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    delta = torch.where((path == 0) | (path == n_bins - 1), torch.zeros_like(delta), delta)
    log2_grid = torch.log2(torch.tensor(grid.astype(np.float32), device=emis.device))
    return 2.0 ** (log2_grid[path] + delta / bins_per_octave)


def extract_pitch(signal, sample_rate: int, block_size: int, fmin: float = 50.0,
                  fmax: float = 2000.0, frame_length: int = 2048, bins_per_octave: int = 60, *,
                  device="cuda") -> torch.Tensor:
    """Frame-rate f0 in Hz of a mono signal (T,), or of each row of a batch
    (N, T), → (..., T // block_size) float32 on `device` (pitch.py:223-245:
    one frame a block, the last center-padded frame dropped).  `signal` is a
    numpy array or a tensor; it is moved to `device`, so the default needs a
    card."""
    device = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32).to(device)
    if signal.dim() not in (1, 2):
        raise ValueError(f"extract_pitch expects a mono (T,) signal or a batch (N, T), got {tuple(signal.shape)}")
    f0 = track(signal, int(sample_rate), int(block_size), float(fmin), float(fmax), int(frame_length),
               int(bins_per_octave))
    return f0[..., : signal.shape[-1] // block_size]
