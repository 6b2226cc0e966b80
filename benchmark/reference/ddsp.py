"""Plain PyTorch reference of the two DDSP models the benchmark measures.

Written from the published description (hugofloresgarcia/ddsp_pytorch:
`core.py`, `model.py`, `train.py`), not from the program under test, whose
package this module never imports.  Every function takes its parameters as
a dict of tensors keyed by the flax-style names the benchmark's weights use
(benchmark/lib/weights.py), and computes in the dtype of those tensors:
float64 for the judge, float32 (with or without TF32) for the control.

  controls   f0, loudness and (autoencoder) MFCC MLPs → GRU → skip-concat
             → output MLP → harmonic amplitude and distribution (Nyquist
             mask, normalised), noise band magnitudes (bias −5)
  harmonic   per-sample phase as the cumulative sum of 2π·f0/sr with f0
             held over each block (summed in float64; a stream's phase,
             carried between calls, kept in float32), Σ_k A_k·sin(k·θ)
  noise      each block's uniform noise convolved with the zero-phase,
             Hann-windowed FIR of its band magnitudes, first block_size
             samples of the linear convolution
  reverb     the signal convolved with noise·exp(−softplus(−decay)·t·500)·
             sigmoid(wet), tap 0 set to 1, first T samples kept
  loss       Σ_scales mean|S_x − S_y| + mean|log(S_x + 1e-7) − log(S_y + 1e-7)|
             over torch.stft magnitudes (centred, reflect pad, periodic Hann,
             normalised), hop = scale·(1 − overlap)
  adam       optax's update: u = −lr·(m/(1 − b1ⁿ)) / (√(v/(1 − b2ⁿ)) + eps)
  mfcc       power STFT (reflect pad, periodic Hann) → Slaney mel bank →
             10·log10 floored at ref_db − 80 → orthonormal DCT-II

Departures from the published code, on purpose: none in the arithmetic;
the streaming functions run a whole session as one offline pass, which is
what a stream with carried state must equal.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6
NOISE_BIAS = -5.0
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def scale_function(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sigmoid(x) ** math.log(10.0) + 1e-7


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[name + ".weight"].T + p[name + ".bias"]


def _layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[name + ".weight"] + p[name + ".bias"]


def mlp(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    for i in range(3):
        x = _linear(p, f"{prefix}.Dense_{i}", x)
        x = _layer_norm(p, f"{prefix}.LayerNorm_{i}", x)
        x = F.leaky_relu(x, 0.01)
    return x


def gru(p: Params, prefix: str, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """(B, F, in) → (outputs (B, F, H), last state (B, H)); gates [r, z, n]."""
    w_ih, w_hh = p[prefix + ".weight_ih"], p[prefix + ".weight_hh"]
    b_ih, b_hh = p[prefix + ".bias_ih"], p[prefix + ".bias_hh"]
    hidden = w_hh.shape[1]
    h = x.new_zeros((x.shape[0], hidden)) if h0 is None else h0
    xp = x @ w_ih.T + b_ih
    outs = []
    for t in range(x.shape[1]):
        hp = h @ w_hh.T + b_hh
        xr, xz, xn = xp[:, t].split(hidden, dim=-1)
        hr, hz, hn = hp.split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=1), h


def encode(p: Params, mfcc: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """The autoencoder's encoder: MFCC (B, F, 30) → z (B, F, 16), state."""
    x = _layer_norm(p, "encoder.LayerNorm_0", mfcc)
    out, h = gru(p, "encoder.GRU_0", x, h0)
    return _linear(p, "encoder.Dense_0", out), h


def controls(p: Params, sample_rate: int, f0: torch.Tensor, loudness: torch.Tensor,
             z: Optional[torch.Tensor] = None, h0: Optional[torch.Tensor] = None):
    """f0 (Hz) and normalised loudness (B, F, 1) [and z] → (harmonic
    amplitudes A_k (B, F, K), noise magnitudes (B, F, n_bands), GRU state)."""
    parts = [mlp(p, "decoder.f0_mlp", f0), mlp(p, "decoder.loudness_mlp", loudness)]
    if z is not None:
        parts.append(mlp(p, "decoder.z_mlp", z))
    hidden, h = gru(p, "decoder.gru", torch.cat(parts, dim=-1), h0)
    hidden = mlp(p, "decoder.out_mlp", torch.cat([hidden, f0, loudness], dim=-1))
    param = scale_function(_linear(p, "harmonic_proj", hidden))
    total, dist = param[..., :1], param[..., 1:]
    k = torch.arange(1, dist.shape[-1] + 1, dtype=dist.dtype, device=dist.device)
    dist = dist * ((f0 * k < sample_rate / 2.0).to(dist.dtype) + 1e-4)
    amps = dist / dist.sum(-1, keepdim=True) * total
    noise_mag = scale_function(_linear(p, "noise_proj", hidden) + NOISE_BIAS)
    return amps, noise_mag, h


def harmonic(f0: torch.Tensor, amps: torch.Tensor, block: int, sample_rate: int,
             steps=None, carry_dtype=torch.float32) -> torch.Tensor:
    """f0 (B, F, 1) and amplitudes (B, F, K), both held over each block →
    (B, F·block) audio, phase from 0 at the first sample's increment.

    The phase is a sum over up to millions of samples: it is accumulated
    in float64 whatever the dtype.  With `steps` (the frames of each call
    of a stream, in order) it is a stream's: the phase carried from one
    call to the next is stored in `carry_dtype`, the state's type, so it is
    rounded to it at each call's end (frame phases within a call are not).
    """
    omega = 2.0 * math.pi * f0[..., 0].double() / sample_rate  # (B, F)
    if steps is None:
        theta = torch.cumsum(omega.repeat_interleave(block, dim=1), dim=1)
    else:
        phi = torch.zeros_like(omega)
        carry = omega.new_zeros(omega.shape[0])
        j = 0
        for n in steps:
            inc = torch.cumsum(torch.remainder(block * omega[:, j:j + n], 2.0 * math.pi), dim=1)
            phi[:, j:j + n] = torch.remainder(F.pad(inc[:, :-1], (1, 0)) + carry[:, None], 2.0 * math.pi)
            carry = torch.remainder(inc[:, -1] + carry, 2.0 * math.pi).to(carry_dtype).double()
            j += n
        ramp = torch.arange(1, block + 1, dtype=omega.dtype, device=omega.device)
        theta = (phi[..., None] + omega[..., None] * ramp).reshape(omega.shape[0], -1)
    theta = torch.remainder(theta, 2.0 * math.pi).to(amps.dtype)
    out = torch.zeros_like(theta)
    for k in range(amps.shape[-1]):
        out = out + amps[..., k].repeat_interleave(block, dim=1) * torch.sin((k + 1) * theta)
    return out


def noise_impulse(mag: torch.Tensor, block: int) -> torch.Tensor:
    """(..., n_bands) magnitudes → (..., block) FIR: zero-phase irfft,
    centred, periodic Hann, zero-padded, rotated back to index 0."""
    ir = torch.fft.irfft(torch.complex(mag, torch.zeros_like(mag)))
    size = ir.shape[-1]
    ir = torch.roll(ir, size // 2, dims=-1)
    ir = ir * torch.hann_window(size, dtype=ir.dtype, device=ir.device)
    ir = F.pad(ir, (0, block - size))
    return torch.roll(ir, -(size // 2), dims=-1)


def filtered_noise(mag: torch.Tensor, noise: torch.Tensor, block: int) -> torch.Tensor:
    """mag (B, F, n_bands), noise (B, F, block) → (B, F·block): each
    block's causal linear convolution with its FIR, first `block` samples."""
    ir = noise_impulse(mag, block)
    n = 2 * block
    y = torch.fft.irfft(torch.fft.rfft(noise, n) * torch.fft.rfft(ir, n), n)[..., :block]
    return y.reshape(noise.shape[0], -1)


def reverb(p: Params, x: torch.Tensor, sample_rate: int) -> torch.Tensor:
    noise = p["reverb.noise"]
    t = torch.arange(noise.shape[0], dtype=x.dtype, device=x.device) / sample_rate
    ir = noise * torch.exp(-F.softplus(-p["reverb.decay"]) * t * 500.0) * torch.sigmoid(p["reverb.wet"])
    ir = torch.cat([torch.ones_like(ir[:1]), ir[1:]])
    length = x.shape[-1]
    ir = ir[:length]
    n = length + ir.shape[0]
    return torch.fft.irfft(torch.fft.rfft(x, n) * torch.fft.rfft(ir, n), n)[..., :length]


def forward(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], noise: torch.Tensor,
            mean_loudness: float, std_loudness: float) -> torch.Tensor:
    """The training forward: batch {pitch, loudness (B, F, 1)[, mfcc]} and
    noise (B, F, block) → (B, F·block) signal, reverb included."""
    m = cfg["model"]
    f0 = batch["pitch"]
    loud = (batch["loudness"] - mean_loudness) / std_loudness
    z = encode(p, batch["mfcc"])[0] if "mfcc" in batch else None
    amps, mag, _ = controls(p, m["sample_rate"], f0, loud, z)
    signal = harmonic(f0, amps, m["block_size"], m["sample_rate"])
    signal = signal + filtered_noise(mag, noise, m["block_size"])
    if m["has_reverb"]:
        signal = reverb(p, signal, m["sample_rate"])
    return signal


def spectral_loss(x: torch.Tensor, y: torch.Tensor, scales: Sequence[int], overlap: float):
    loss = x.new_zeros(())
    for s in scales:
        window = torch.hann_window(s, dtype=x.dtype, device=x.device)

        def mag(sig):
            return torch.stft(sig, s, int(s * (1 - overlap)), s, window, center=True,
                              pad_mode="reflect", normalized=True, return_complex=True).abs()

        sx, sy = mag(x), mag(y)
        loss = loss + (sx - sy).abs().mean() + (torch.log(sx + 1e-7) - torch.log(sy + 1e-7)).abs().mean()
    return loss


def train_steps(p: Params, cfg: dict, batches, noises, mean_loudness: float, std_loudness: float):
    """Adam steps from parameters `p` (a dict of leaf tensors, not changed):
    one per (batch, noise).  Returns each step's loss, the first step's
    gradients and the parameters after the last step."""
    tc = cfg["train"]
    names = list(p)
    params = {k: v.detach().clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    for n, (batch, noise) in enumerate(zip(batches, noises), start=1):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        signal = forward(leaves, cfg, batch, noise, mean_loudness, std_loudness)
        loss = spectral_loss(batch["sig"], signal, tc["scales"], tc["overlap"])
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            new = {}
            for k in names:
                g = grads[k]
                mu[k] = (1 - B1) * g + B1 * mu[k]
                nu[k] = (1 - B2) * g * g + B2 * nu[k]
                step = (mu[k] / (1 - B1 ** n)) / (torch.sqrt(nu[k] / (1 - B2 ** n)) + ADAM_EPS)
                new[k] = params[k].detach() - tc["lr"] * step
            params = new
    return losses, first_grads, params


# ----------------------------------------------------------------- MFCC

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3.0)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_bank(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular filters (n_mels, 1 + n_fft/2)."""
    freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    up = (freqs[None] - lo) / (mid - lo)
    down = (hi - freqs[None]) / (hi - mid)
    bank = np.maximum(0.0, np.minimum(up, down))
    return bank * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def dct_ortho(n_out: int, n_in: int) -> np.ndarray:
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] /= np.sqrt(2.0)
    return mat


def mfcc_frames(audio: torch.Tensor, pre: dict, n_frames: int) -> torch.Tensor:
    """(B, T) audio → its first `n_frames` MFCC frames (B, n, n_mfcc): frame
    j windows samples [j·hop − n_fft/2, j·hop + n_fft/2) of the signal with
    a reflect pad on the left; frames past the end of `audio` are not asked
    for."""
    n_fft, hop = pre["mfcc_n_fft"], pre["block_size"]
    half = n_fft // 2
    x = torch.cat([audio[:, 1:half + 1].flip(-1), audio], dim=1)
    need = (n_frames - 1) * hop + n_fft
    if x.shape[1] < need:
        raise ValueError("mfcc_frames: not enough audio for the frames asked")
    frames = x[:, :need].unfold(1, n_fft, hop)
    window = torch.hann_window(n_fft, dtype=audio.dtype, device=audio.device)
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    bank = torch.as_tensor(mel_bank(pre["sample_rate"], n_fft, pre["n_mels"], pre["mfcc_fmin"],
                                    pre["mfcc_fmax"]), dtype=audio.dtype, device=audio.device)
    db = 10.0 * torch.log10(torch.clamp(power @ bank.T, min=1e-10))
    if pre.get("mfcc_ref_db") is not None:
        db = torch.clamp(db, min=pre["mfcc_ref_db"] - 80.0)
    dct = torch.as_tensor(dct_ortho(pre["n_mfcc"], pre["n_mels"]), dtype=audio.dtype,
                          device=audio.device)
    return db @ dct.T


def stream_render(p: Params, cfg: dict, f0: torch.Tensor, loudness: torch.Tensor,
                  noise: torch.Tensor, steps, mfcc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What a dry stream renders from its start: f0 and normalised loudness
    (B, F, 1) of each block [and its MFCC frames], the noise each block
    drew (B, F, block), the frames of each of the stream's calls → (B,
    F·block); carries from zero, the phase carry kept in float32 (the
    configuration's type), no reverb."""
    m = cfg["model"]
    z = encode(p, mfcc)[0] if mfcc is not None else None
    amps, mag, _ = controls(p, m["sample_rate"], f0, loudness, z)
    return (harmonic(f0, amps, m["block_size"], m["sample_rate"], steps)
            + filtered_noise(mag, noise, m["block_size"]))


def frames_released(block_index: int, pre: dict) -> int:
    """MFCC frames a causal extractor can emit once blocks 0..block_index
    are in: frame j needs j·hop + n_fft/2 samples, frame 0 one more (its
    reflect pad mirrors x[1..n_fft/2])."""
    have = (block_index + 1) * pre["block_size"]
    half, hop = pre["mfcc_n_fft"] // 2, pre["block_size"]
    if have < half + 1:
        return 0
    return (have - half) // hop + 1


def stream_steps(n_frames: int, pre: dict, needs_audio: bool) -> list:
    """The frames of each call of a one-block-a-request stream, in order,
    covering `n_frames`: a frame a call, or for an autoencoder session as
    its causal MFCC extractor releases them (block 1 releases two)."""
    steps, done, b = [], 0, 0
    while done < n_frames:
        ready = min(frames_released(b, pre), b + 1) if needs_audio else b + 1
        if ready > done:
            steps.append(min(ready, n_frames) - done)
            done = min(ready, n_frames)
        b += 1
    return steps
