"""Time-sharded DSP ops: the distributed phase scan, the halo'd causal
convolution and the sharded multi-scale STFT loss.

Port of ddsp_pytorch_tpu/parallel/ops.py:75-376.  Every op takes local
tensors whose leading dimension is the time shards this process holds
(parallel/mesh.py): (s, B, F_local[, ...]) at frame rate, (s, B, C) at
sample rate, C = F_local · block the shard's chunk, and a `TimeAxis` (or a
`Mesh`, for the loss) whose collectives carry what crosses a shard edge.

  * sharded_phase_offsets / sharded_harmonic_synth — the oscillator's
    phase sum as a local float64 cumsum plus an exclusive scan of the
    shards' float64 totals (one small all_gather), wrapped mod 2π at each
    level as in JAX; then the local oscillator, `synth_from_phases`, on
    all s·B·F_local rows in one launch of the hand-written kernels on the
    card.  The port's unsharded phase sum runs in float64
    (ops/oscillator.phase_accumulate_frames); so does this one, or the two
    would differ by float32 rounding of F·2π-sized partial sums.
  * sharded_fft_convolve_causal — the reverb: each shard convolves its
    chunk with the IR (torch.fft) and hands the overflowing tail to the
    ⌈(L−1)/C⌉ shards it bleeds into (`shift`).
  * sharded_multiscale_spec_loss — STFT frames that straddle a shard edge
    get n_fft/2-sample halos from both neighbours, the global reflect
    padding is rebuilt at the outer shards, and the per-process partial
    loss is summed over the mesh (one `psum` for all scales).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ddsp_pytorch_tpu_torch.ops.oscillator import TWO_PI, synth_from_phases
from ddsp_pytorch_tpu_torch.ops.spectral import hann_window
from ddsp_pytorch_tpu_torch.parallel.mesh import Mesh, TimeAxis

# the loss's log floor (training/loss.py, ops/core.safe_log)
_LOG_EPS = 1e-7


# ------------------------------------------------------------- layout


def to_time_shards(x: torch.Tensor, axis: TimeAxis) -> torch.Tensor:
    """(B, L, ...) with L = n·c on dim 1 → (s, B, c, ...): the local shards'
    slices, stacked (a view)."""
    b, length = x.shape[:2]
    if length % axis.n:
        raise ValueError(f"length {length} does not divide into {axis.n} time shards")
    shards = x.unflatten(1, (axis.n, length // axis.n)).movedim(1, 0)
    return shards[axis.first : axis.first + axis.count]


def from_time_shards(x: torch.Tensor) -> torch.Tensor:
    """(s, B, c, ...) → (B, s·c, ...): the local shards' span, contiguous in
    time."""
    return x.movedim(0, 1).flatten(1, 2)


def _where_shard(axis: TimeAxis, index: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a on the local shard whose global index is `index`, b elsewhere."""
    mask = axis.indices(a.device) == index
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


# ---------------------------------------------------------- phase scan


def sharded_phase_offsets(f0: torch.Tensor, block_size: int, sample_rate: float, axis: TimeAxis):
    """Distributed exclusive phase scan (parallel/ops.py:75-100).

    f0 (s, B, F_local) Hz.  Returns (phi (s, B, F_local), phase_out (s, B)):
    each frame's start phase with the offset of every shard to its left,
    and each shard's outgoing phase, wrapped to [0, 2π), in f0's type.
    Summed in float64 and rounded once, as the unsharded scan."""
    dphi = torch.remainder(block_size * (TWO_PI * f0.double() / sample_rate), TWO_PI)
    inc = torch.cumsum(dphi, dim=-1)
    local_total = torch.remainder(inc[..., -1], TWO_PI)  # (s, B)
    totals = axis.all_gather(local_total)  # (n, B), float64
    left = torch.cumsum(totals, dim=0) - totals  # exclusive scan over the shards
    offset = torch.remainder(left[axis.first : axis.first + axis.count], TWO_PI)
    phi_excl = torch.remainder(torch.nn.functional.pad(inc[..., :-1], (1, 0)), TWO_PI)
    phi = torch.remainder(phi_excl + offset[..., None], TWO_PI)
    phase_out = torch.remainder(local_total + offset, TWO_PI)
    return phi.to(f0.dtype), phase_out.to(f0.dtype)


def sharded_harmonic_synth(f0: torch.Tensor, amp: torch.Tensor, block_size: int,
                           sample_rate: float, axis: TimeAxis) -> torch.Tensor:
    """Time-sharded oscillator bank (parallel/ops.py:103-125): f0 (s, B,
    F_local), amp (s, B, F_local, K) → (s, B, F_local·S), each shard's span
    of the unsharded bank.  One launch of the forward kernel (and, in a
    backward, of the backward kernel) over the s·B·F_local rows."""
    s, b, f = f0.shape
    phi, _ = sharded_phase_offsets(f0, block_size, sample_rate, axis)
    audio = synth_from_phases(f0.reshape(s * b, f), amp.reshape(s * b, f, amp.shape[-1]),
                              phi.reshape(s * b, f), block_size, sample_rate)
    return audio.view(s, b, f * block_size)


# ------------------------------------------------ halo'd causal convolution


def sharded_fft_convolve_causal(x: torch.Tensor, ir: torch.Tensor, axis: TimeAxis) -> torch.Tensor:
    """Causal convolution of a time-sharded signal with an IR that every
    shard holds (parallel/ops.py:128-163): out[t] = Σ_{τ≤t} ir[τ]·x[t−τ].

    x (s, B, C), ir (L,).  Each shard convolves its chunk (length C+L−1),
    keeps [0, C) and sends the tail in C-sized pieces k = 1 … ⌈(L−1)/C⌉
    shards to the right; pieces past the last shard fall off the signal.
    The same function as the reverb's full-signal fft_convolve with the IR
    padded to the signal's length (models/modules.Reverb)."""
    c = x.shape[-1]
    length = ir.shape[-1]
    n_fft = 1 << math.ceil(math.log2(c + length))
    full = torch.fft.irfft(torch.fft.rfft(x, n_fft) * torch.fft.rfft(ir, n_fft), n_fft)
    full = full[..., : c + length - 1]
    out = full[..., :c]
    n_hops = min(-(-(length - 1) // c), axis.n - 1)
    for k in range(1, n_hops + 1):
        piece = full[..., k * c : (k + 1) * c]
        piece = torch.nn.functional.pad(piece, (0, c - piece.shape[-1]))
        out = out + axis.shift(piece, k)
    return out


# --------------------------------------------------- sharded multiscale loss


def reflect_tail_into_pad(x: torch.Tensor, t_valid: int, axis: TimeAxis) -> torch.Tensor:
    """Overwrite the samples at global index ≥ t_valid with the signal's
    reflection about its true end (parallel/ops.py:166-199): on [t_valid,
    T_pad) the result is x[:t_valid] reflect-padded, out[t_valid + k] =
    x[t_valid − 2 − k].  That is how the pad-and-mask loss rebuilds the
    STFT's centered reflect padding at the true end.  The pad region and
    its sources must lie on the last shard (training/time_sharded.
    plan_time_padding sees to it).  Differentiable: the reversed slice's
    gradient lands on the interior samples, as reflect padding's does."""
    c = x.shape[-1]
    t_pad = axis.n * c
    if t_valid >= t_pad:
        return x
    m = t_valid - (axis.n - 1) * c  # valid samples on the last shard
    lo = 2 * m - 1 - c
    if lo < 0:
        raise ValueError(
            f"reflect_tail_into_pad: reflection sources reach below the last shard "
            f"(t_valid={t_valid}, chunk={c}, shards={axis.n}); the time padding plan must "
            f"keep 2*t_valid - T_pad - 1 >= (n-1)*chunk"
        )
    reflected = torch.cat([x[..., :m], x[..., lo : m - 1].flip(-1)], dim=-1)
    return _where_shard(axis, axis.n - 1, reflected, x)


def _edge_reflect(x: torch.Tensor, pad: int, side: str) -> torch.Tensor:
    """The reflect padding of a global edge, from the edge shard's own
    samples (parallel/ops.py:202-207)."""
    if side == "left":
        return x[..., 1 : pad + 1].flip(-1)
    return x[..., -pad - 1 : -1].flip(-1)


def _halo_exchange(x: torch.Tensor, pad: int, axis: TimeAxis) -> torch.Tensor:
    """(s, B, C) → (s, B, C + 2·pad): each chunk with `pad` samples of each
    neighbour, reflect padding at the global edges (parallel/ops.py:210-223)."""
    from_left = axis.shift(x[..., -pad:], 1)
    from_right = axis.shift(x[..., :pad], -1)
    from_left = _where_shard(axis, 0, _edge_reflect(x, pad, "left"), from_left)
    from_right = _where_shard(axis, axis.n - 1, _edge_reflect(x, pad, "right"), from_right)
    return torch.cat([from_left, x, from_right], dim=-1)


def sharded_scale_mags(x: torch.Tensor, n_fft: int, hop: int, axis: TimeAxis,
                       t_valid: Optional[int] = None):
    """Magnitude STFT frames owned by the local shards (parallel/ops.py
    :226-271): (mags (s, B, n_loc, bins), valid (s, n_loc)).

    The global frame set (centered, 1 + t_valid // hop frames) is split by
    frame centre: a shard owns the frames centred in its chunk, plus a last
    slot valid only on the last shard; with t_valid below the padded
    length, frames centred past it are masked out.  Needs C % hop == 0 and
    n_fft/2 < C.  The frames are the unsharded STFT's: windowed, × n_fft^−½
    and then the magnitude (ops/spectral.stft)."""
    c = x.shape[-1]
    pad = n_fft // 2
    if c % hop:
        raise ValueError(f"time-shard chunk ({c}) must be a multiple of the STFT hop ({hop}); "
                         "choose a shard count dividing T/hop")
    if pad >= c:
        raise ValueError(f"n_fft/2 ({pad}) must be smaller than the time-shard chunk ({c}); "
                         "use fewer time shards or smaller FFT scales")
    frames = _halo_exchange(x, pad, axis).unfold(-1, n_fft, hop)  # (s, B, n_loc, n_fft)
    n_loc = c // hop + 1
    spec = torch.fft.rfft(frames * hann_window(n_fft, x.dtype, x.device), dim=-1)
    mags = (spec * (1.0 / math.sqrt(n_fft))).abs()
    if t_valid is None:
        t_valid = axis.n * c
    index = axis.indices(x.device)
    centres = index[:, None] * c + torch.arange(n_loc, device=x.device) * hop
    owned = torch.ones((axis.count, n_loc), dtype=torch.bool, device=x.device)
    owned[:, -1] = index == axis.n - 1
    return mags, (owned & (centres <= t_valid)).to(x.dtype)


def sharded_multiscale_spec_loss(target: torch.Tensor, recon: torch.Tensor, scales: Sequence[int],
                                 overlap: float, mesh: Mesh, t_valid: Optional[int] = None
                                 ) -> torch.Tensor:
    """The training loss (training/loss.py) of time-sharded signals
    (parallel/ops.py:274-320): target, recon (s, B, C) → the loss of the
    whole global batch on every process.

    Σ_scales [mean|S_t − S_r| + mean|log S_t − log S_r|], each mean over
    the global batch, bins and the unsharded frame count 1 + t_total // hop.
    With t_valid set (pad-and-mask), frames centred past it are left out and
    both signals' pad regions must hold the reflection about t_valid
    (reflect_tail_into_pad).  In float32, or float64 where recon is."""
    axis = mesh.time_axis
    dtype = torch.promote_types(recon.dtype, torch.float32)
    target, recon = target.to(dtype), recon.to(dtype)
    b_global = target.shape[1] * mesh.data_procs
    t_total = axis.n * target.shape[-1] if t_valid is None else t_valid
    total = torch.zeros((), dtype=dtype, device=recon.device)
    for n_fft in scales:
        hop = int(n_fft * (1.0 - overlap))
        mags_t, valid = sharded_scale_mags(target, n_fft, hop, axis, t_valid)
        mags_r, _ = sharded_scale_mags(recon, n_fft, hop, axis, t_valid)
        w = valid[:, None, :, None]
        lin = torch.sum(torch.abs(mags_t - mags_r) * w)
        log = torch.sum(torch.abs(torch.log(mags_t + _LOG_EPS) - torch.log(mags_r + _LOG_EPS)) * w)
        count = b_global * (n_fft // 2 + 1) * (1 + t_total // hop)
        total = total + (lin + log) / count
    return mesh.psum(total)


# ------------------------------------------------------------ wrappers


def make_time_sharded_synth(mesh: Mesh, block_size: int, sample_rate: float):
    """(f0 (B, F), amp (B, F, K)) → the local span (B, s·F_local·S) of the
    bank (parallel/ops.py:323-345)."""
    axis = mesh.time_axis

    def synth(f0, amp):
        f0, amp = mesh.data_rows(f0), mesh.data_rows(amp)
        audio = sharded_harmonic_synth(to_time_shards(f0, axis), to_time_shards(amp, axis),
                                       block_size, sample_rate, axis)
        return from_time_shards(audio)

    return synth


def make_time_sharded_loss(mesh: Mesh, scales: Sequence[int], overlap: float,
                           t_valid: Optional[int] = None):
    """(target (B, T), recon (B, T)) → the scalar loss, T over the time axis
    (parallel/ops.py:348-364)."""
    axis = mesh.time_axis

    def loss(target, recon):
        return sharded_multiscale_spec_loss(
            to_time_shards(mesh.data_rows(target), axis), to_time_shards(mesh.data_rows(recon), axis),
            scales, overlap, mesh, t_valid,
        )

    return loss


def make_time_sharded_reverb(mesh: Mesh):
    """(x (B, T), ir (L,)) → the local span of the causal convolution, T over
    the time axis (parallel/ops.py:367-376)."""
    axis = mesh.time_axis

    def reverb(x, ir):
        return from_time_shards(sharded_fft_convolve_causal(to_time_shards(mesh.data_rows(x), axis),
                                                            ir, axis))

    return reverb
