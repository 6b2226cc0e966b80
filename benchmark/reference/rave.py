"""Plain PyTorch reference of RAVE v1's phase-1 training step, for the
benchmark's `rave-*` configurations.

Written from the published model (Caillon & Esling, "RAVE: A variational
autoencoder for fast and high-quality neural audio synthesis",
arXiv:2111.05011; acids-ircam/RAVE v1: rave/model.py, rave/pqmf.py,
rave/core.py, the defaults of train_rave.py), not from the program under
test, whose package this module never imports.  Parameters and BatchNorm's
running statistics come as a dict of tensors under the program's
state_dict names (the benchmark's data format: `encoder.conv_in`,
`encoder.norms.<i>`, `encoder.convs.<i>`, `encoder.conv_out`,
`decoder.conv_in`, `decoder.ups.<i>`, `decoder.stacks.<i>.<j>.conv1|conv2`,
`decoder.wave`, `decoder.loud`, `decoder.noise.convs.<i>`; a
weight-normalised convolution holds `weight_v`, `weight_g` and `bias`),
and everything is computed in the dtype of those tensors: float64 for the
judge, float32 for a control.  TF32 is off in cuBLAS and cuDNN unless a
control asks for it.

  pqmf       the prototype: a Kaiser window (β and length from Kaiser's
             order formula at 100 dB and a transition width of wc/π, the
             length made odd) times the unscaled sinc of cutoff wc; wc the
             minimiser of RAVE's loss_wc (the largest |(h ∗ h reversed)| at
             the centre + 2M·k, k ≥ 1); the bank hₖ = 2h·cos((2k+1)π/(2M)·
             (n − (N−1)/2) + (−1)ᵏπ/4).  Analysis: each band cross-
             correlated with hₖ (zero pad N//2), every M-th sample, then the
             odd bands' even samples negated.  Synthesis: that sign undone,
             zeros between the samples and × M, cross-correlated with the
             flipped hₖ (pad N//2), summed over the bands
  encoder    conv(M → C, 7, pad 3); per ratio r: BatchNorm (train mode: the
             batch's mean and biased variance over batch and time, ε 1e-5;
             running ← 0.9·running + 0.1·batch, the variance unbiased) →
             LeakyReLU(0.2) → conv(stride r, width 2r+1, pad r);
             LeakyReLU → conv(→ 2·latent, 5, pad 2, groups 2) → [μ; s]
  latent     σ = softplus(s) + 1e-4, z = ε·σ + μ, KL = Σ_c(μ² + σ² −
             log σ² − 1) averaged over batch and frames
  generator  weight norm w = g·v/‖v‖ over each slice of v's first axis;
             conv(latent → C·2ⁿ, 7); per ratio r: LeakyReLU → transposed
             conv(width 2r, stride r, pad r/2), three residuals h + conv3(
             LeakyReLU(conv3 dilated 1, 3, 9 (LeakyReLU(h)))); bands =
             tanh(conv(→ M, 7)) · (2·sigmoid(conv(→ 1, 3))^2.3 + 1e-7)
  distance   D(a, b) = Σ over the scales of ‖S_a − S_b‖_F / ‖S_a‖_F +
             mean|log(S_a + 1e-7) − log(S_b + 1e-7)|; S the magnitude of
             the centred (reflect pad n/2), periodic-Hann, n^-½-normalised
             STFT at hop n/4, every row a signal (the bands fold into rows)
  loudness   mean over bins of log(|STFT| + 1e-7) + A(f), the STFT centred,
             periodic Hann, not normalised (n_fft 2048, hop 512 at the
             published size); A the IEC A-weighting in dB floored at −80
  loss       D(X, Y) + D(P⁻¹X, P⁻¹Y) + mean((ℓ(P⁻¹X) − ℓ(P⁻¹Y))²) + β·KL,
             X the crop's bands, Y the generator's
  adam       optax's order: m ← (1−b1)g + b1·m, v ← (1−b2)g² + b2·v, the
             update −lr·(m/c1)/(√(v/c2) + 1e-8), the bias corrections
             c = 1 − bⁿ computed in float32 (b and n float32, as optax
             computes them from its int32 count); b1 0.5 and b2 0.9 at the
             published recipe; the noise branch's leaves have no gradient
             and are not touched

Departures from RAVE v1, on purpose (those of the program's recipe): wc is
found by a grid of 2001 points over [0.5/M, 3/M] and golden-section
refinement between the best point's neighbours, not scipy's Nelder-Mead
`fmin` from 1/M (both land at wc ≈ 0.1075, N = 377 at M = 16); the bank
keeps its odd length (RAVE pads it to a power of two) and runs the classic
form, not the polyphase one; phase 1 only (no discriminator, the noise
branch not run); Adam in optax's order with its float32 bias corrections
(torch.optim.Adam's order and float64 corrections differ in rounding
only); the weights random (drawn by the benchmark), not trained.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
ATTENUATION = 100.0
SLOPE = 0.2
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
SIGMA_FLOOR = 1e-4
LOG_EPS = 1e-7
ADAM_EPS = 1e-8
NOISE_PREFIX = "decoder.noise."


@contextlib.contextmanager
def precision(allow_tf32: bool = False):
    """TF32 off in cuBLAS and cuDNN (on for a control), restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ------------------------------------------------------------------- pqmf
def _kaiser(n: int, beta: float) -> torch.Tensor:
    """The symmetric Kaiser window of n points, float64."""
    t = torch.arange(n, dtype=torch.float64)
    r = 2.0 * t / (n - 1) - 1.0
    arg = torch.tensor(beta, dtype=torch.float64) * torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    return torch.special.i0(arg) / torch.special.i0(torch.tensor(beta, dtype=torch.float64))


def lowpass(wc: float, taps: int = 0) -> torch.Tensor:
    """The Kaiser prototype of cutoff wc at ATTENUATION dB (taps from the
    order formula, made odd, unless given), float64."""
    a = ATTENUATION
    beta = 0.1102 * (a - 8.7)  # a > 50
    if taps == 0:
        taps = math.ceil((a - 7.95) / 2.285 / wc + 1)  # transition width wc/π in Nyquist units
        taps = 2 * (taps // 2) + 1
    m = torch.arange(taps, dtype=torch.float64) - (taps - 1) / 2
    c = wc / math.pi
    return c * torch.sinc(c * m) * _kaiser(taps, beta)


def _aliasing(wc: float, m: int, taps: int = 0) -> float:
    h = lowpass(wc, taps)
    g = F.conv1d(h.view(1, 1, -1), h.view(1, 1, -1), padding=h.shape[0] - 1).view(-1)
    return float(g[g.shape[0] // 2::2 * m][1:].abs().max())


def design(m: int, taps: int = 0):
    """(h, wc): the prototype minimising the aliasing term, by a grid then
    a golden-section search."""
    grid = torch.linspace(0.5 / m, 3.0 / m, 2001, dtype=torch.float64).tolist()
    costs = [_aliasing(w, m, taps) for w in grid]
    i = min(range(len(grid)), key=lambda j: costs[j])
    lo, hi = grid[max(i - 1, 0)], grid[min(i + 1, len(grid) - 1)]
    gold = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = hi - gold * (hi - lo), lo + gold * (hi - lo)
    fc, fd = _aliasing(c, m, taps), _aliasing(d, m, taps)
    for _ in range(80):
        if fc <= fd:
            hi, d, fd = d, c, fc
            c = hi - gold * (hi - lo)
            fc = _aliasing(c, m, taps)
        else:
            lo, c, fc = c, d, fd
            d = lo + gold * (hi - lo)
            fd = _aliasing(d, m, taps)
    wc = min((costs[i], grid[i]), (fc, c), (fd, d))[1]
    return lowpass(wc, taps), wc


def bank(m: int, h: torch.Tensor) -> torch.Tensor:
    n = h.shape[0]
    k = torch.arange(m, dtype=torch.float64)[:, None]
    t = torch.arange(n, dtype=torch.float64)[None, :] - (n - 1) / 2
    return 2.0 * h[None] * torch.cos((2 * k + 1) * math.pi / (2 * m) * t + (-1.0) ** k * math.pi / 4)


def _sign(x: torch.Tensor) -> torch.Tensor:
    s = torch.ones(x.shape[-2:], dtype=x.dtype, device=x.device)
    s[1::2, ::2] = -1.0
    return x * s


def analysis(x: torch.Tensor, hk: torch.Tensor) -> torch.Tensor:
    """(B, T) → (B, M, T/M)."""
    m, n = hk.shape
    return _sign(F.conv1d(x[:, None], hk[:, None], stride=m, padding=n // 2))


def synthesis(y: torch.Tensor, hk: torch.Tensor) -> torch.Tensor:
    """(B, M, L) → (B, L·M), the zero-stuffed definition."""
    m, n = hk.shape
    up = torch.zeros((y.shape[0], m, m * y.shape[-1]), dtype=y.dtype, device=y.device)
    up[..., ::m] = _sign(y) * m
    return F.conv1d(up, hk.flip(-1)[None], padding=n // 2)[:, 0]


# ------------------------------------------------------------------ model
def lrelu(x):
    return F.leaky_relu(x, SLOPE)


def _wn(p: Params, name: str) -> torch.Tensor:
    v = p[name + ".weight_v"]
    return p[name + ".weight_g"] * v / torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True))


def _conv(p: Params, name: str, x, stride=1, dilation=1, groups=1, wn=True):
    w = _wn(p, name) if wn else p[name + ".weight"]
    pad = (w.shape[-1] - 1) * dilation // 2
    return F.conv1d(x, w, p[name + ".bias"], stride, pad, dilation, groups)


def _batch_norm(p: Params, name: str, x, stats: Params):
    mean = x.mean(dim=(0, 2))
    var = ((x - mean[None, :, None]) ** 2).mean(dim=(0, 2))
    n = x.shape[0] * x.shape[2]
    stats[name + ".running_mean"] = (1 - BN_MOMENTUM) * p[name + ".running_mean"] + BN_MOMENTUM * mean.detach()
    stats[name + ".running_var"] = ((1 - BN_MOMENTUM) * p[name + ".running_var"]
                                    + BN_MOMENTUM * var.detach() * n / (n - 1))
    stats[name + ".num_batches_tracked"] = p[name + ".num_batches_tracked"] + 1
    y = (x - mean[None, :, None]) / torch.sqrt(var[None, :, None] + BN_EPS)
    return y * p[name + ".weight"][None, :, None] + p[name + ".bias"][None, :, None]


def encode(p: Params, model: dict, bands):
    """(μ, s, the running statistics after the batch)."""
    stats: Params = {}
    h = _conv(p, "encoder.conv_in", bands, wn=False)
    for i, r in enumerate(model["ratios"]):
        h = _batch_norm(p, f"encoder.norms.{i}", h, stats)
        h = _conv(p, f"encoder.convs.{i}", lrelu(h), stride=r, wn=False)
    out = _conv(p, "encoder.conv_out", lrelu(h), groups=2, wn=False)
    mean, scale = out[:, :model["latent_size"]], out[:, model["latent_size"]:]
    return mean, scale, stats


def decode(p: Params, model: dict, z):
    h = _conv(p, "decoder.conv_in", z)
    for i, r in enumerate(model["ratios"]):
        w = _wn(p, f"decoder.ups.{i}")
        h = F.conv_transpose1d(lrelu(h), w, p[f"decoder.ups.{i}.bias"], stride=r, padding=r // 2)
        for j in range(3):
            name = f"decoder.stacks.{i}.{j}"
            h = h + _conv(p, name + ".conv2", lrelu(_conv(p, name + ".conv1", lrelu(h), dilation=3**j)))
    loud = _conv(p, "decoder.loud", h, stride=model["loud_stride"])
    loud = loud.repeat_interleave(model["loud_stride"], dim=-1)
    return torch.tanh(_conv(p, "decoder.wave", h)) * (2.0 * torch.sigmoid(loud) ** 2.3 + 1e-7)


# ------------------------------------------------------------------- loss
def magnitude(x, n: int, hop: int, normalized: bool):
    """|STFT| (rows, bins, frames) of (rows, T): centred reflect pad n/2,
    periodic Hann."""
    xp = F.pad(x[:, None], (n // 2, n // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n, hop)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n, dtype=x.dtype, device=x.device) / n)
    spec = torch.fft.rfft(frames * win, dim=-1)
    if normalized:
        spec = spec / math.sqrt(n)
    return spec.abs().transpose(-1, -2)


def distance(a, b, scales, overlap: float):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    total = 0.0
    for n in scales:
        hop = int(n * (1 - overlap))
        sa, sb = magnitude(a, n, hop, True), magnitude(b, n, hop, True)
        total = total + torch.sqrt(((sa - sb) ** 2).sum()) / torch.sqrt((sa * sa).sum())
        total = total + (torch.log(sa + LOG_EPS) - torch.log(sb + LOG_EPS)).abs().mean()
    return total


def a_weighting(n_fft: int, sample_rate: int, dtype, device):
    f = torch.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1, dtype=torch.float64)
    f2 = f * f
    c = [12194.217 ** 2, 20.598997 ** 2, 107.65265 ** 2, 737.86223 ** 2]
    db = 2.0 + 20.0 * (math.log10(c[0]) + 2.0 * torch.log10(f2) - torch.log10(f2 + c[0]) - torch.log10(f2 + c[1])
                       - 0.5 * torch.log10(f2 + c[2]) - 0.5 * torch.log10(f2 + c[3]))
    return torch.clamp(torch.nan_to_num(db, nan=-80.0, neginf=-80.0), min=-80.0).to(device, dtype)


def loudness(x, model: dict):
    n, hop = model["loudness_n_fft"], model["loudness_hop"]
    s = magnitude(x, n, hop, False)
    w = a_weighting(n, model["sample_rate"], x.dtype, x.device)
    return (torch.log(s + LOG_EPS) + w[:, None]).mean(dim=-2)


def step_loss(p: Params, cfg: dict, hk, crops, eps):
    """(loss, its terms, μ, σ, z, the bands Y, the running statistics)."""
    model, tc = cfg["model"], cfg["train"]
    bands = analysis(crops, hk)
    mean, scale, stats = encode(p, model, bands)
    std = F.softplus(scale) + SIGMA_FLOOR
    var = std * std
    z = eps * std + mean
    kl = (mean * mean + var - torch.log(var) - 1.0).sum(1).mean()
    y = decode(p, model, z)
    x_full, y_full = synthesis(bands, hk), synthesis(y, hk)
    terms = {"multiband": distance(bands, y, tc["scales"], tc["overlap"]),
             "fullband": distance(x_full, y_full, tc["scales"], tc["overlap"]),
             "loudness": ((loudness(x_full, model) - loudness(y_full, model)) ** 2).mean(), "kl": kl}
    loss = terms["multiband"] + terms["fullband"] + terms["loudness"] + model["kl_beta"] * kl
    return loss, terms, {"mean": mean, "std": std, "z": z, "bands": y}, stats


def train_steps(state: Params, cfg: dict, crops: List[torch.Tensor], eps: List[torch.Tensor],
                dtype: torch.dtype = torch.float64, allow_tf32: bool = False, hk=None) -> dict:
    """len(crops) Adam steps from `state` (parameters and running
    statistics; not changed) on the batches `crops` (B, T) with the draws
    `eps` (B, latent, frames).  `hk`: the bank (default: designed here).
    Returns {"losses", "terms": the first step's, "out": its μ, σ, z and
    bands, "grads": its gradients, "states": the parameters and statistics
    after each step}."""
    model, tc = cfg["model"], cfg["train"]
    device = crops[0].device
    if hk is None:
        hk = bank(model["n_band"], design(model["n_band"])[0])
    hk = hk.to(device, dtype)
    names = [k for k, v in state.items() if v.is_floating_point() and ".running_" not in k
             and not k.startswith(NOISE_PREFIX)]
    p = {k: (v.detach().to(dtype) if v.is_floating_point() else v.detach().clone()) for k, v in state.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    b1, b2 = tc["betas"]
    out = {"losses": [], "states": []}
    with precision(allow_tf32):
        for n, (x, e) in enumerate(zip(crops, eps), start=1):
            leaves = {k: p[k].clone().requires_grad_(True) for k in names}
            loss, terms, fwd, stats = step_loss({**p, **leaves}, cfg, hk, x.to(dtype), e.to(dtype))
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            if n == 1:
                out["terms"] = {k: float(t.detach()) for k, t in terms.items()}
                out["out"] = {k: t.detach() for k, t in fwd.items()}
                out["grads"] = dict(zip(names, grads))
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                count = torch.tensor(float(n), device=device)  # float32, as optax casts its int32 count
                c1, c2 = (1 - torch.pow(b1, count)).to(dtype), (1 - torch.pow(b2, count)).to(dtype)
                for k, g in zip(names, grads):
                    m[k] = (1 - b1) * g + b1 * m[k]
                    v[k] = (1 - b2) * g * g + b2 * v[k]
                    p[k] = p[k] - tc["lr"] * (m[k] / c1) / (torch.sqrt(v[k] / c2) + ADAM_EPS)
                p.update(stats)
            out["states"].append(dict(p))
    return out
