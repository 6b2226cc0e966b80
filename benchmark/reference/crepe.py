"""Plain PyTorch reference of CREPE's training step, for the benchmark's
`crepe-*` configurations.

Written from the published description (Kim, Salamon, Li, Bello, "CREPE: A
Convolutional Representation for Pitch Estimation", ICASSP 2018,
arXiv:1802.06182; marl/crepe `crepe/core.py` `build_and_load_model`), not
from the program under test, whose package this module never imports.
Parameters and running statistics come as a dict of tensors under the
names conv1..conv6, bn1..bn6 and classifier (`<layer>.weight`, `.bias`,
`bn<i>.running_mean`, `.running_var`; convolution kernels (out, in, width),
the classifier (360, in) as in torch), and everything after the random
draws is computed in the dtype of those tensors: float64 for the judge,
float32 for a control.

  draws      the batch's random draws, made from `generator` exactly as
             the training recipe makes them, in its order and in float32
             (uniforms mapped to their ranges, f0 log-uniform over 40–1800
             Hz, a normal noise frame, the robust set's delays, signs,
             gains and switches), then one uniform mask a block for
             dropout, in forward order
  synth      16 harmonics k·f0 of a vibrato (5 Hz) phase, amplitudes
             k^−α under a formant bump, above-Nyquist harmonics dropped,
             normalised; coherent or random starting phases; robust: a
             sparse room IR by circular convolution, pink or white noise at
             the drawn SNR, tanh soft clipping; then the drawn gain
  network    each frame less its mean over its population std (floored at
             1e-6); six blocks of conv ("SAME" padding: ceil(L/stride)
             outputs, the odd padding sample on the right) → ReLU →
             BatchNorm → max-pool 2 → dropout; the (C, 4) map flattened
             time-major; a dense layer to 360 logits
  batchnorm  train mode: the batch's mean and biased variance E[x²] −
             E[x]² (floored at 0) over batch and time, ε 1e-5; running
             statistics ← 0.99 · running + 0.01 · batch (the variance
             biased too)
  dropout    rate 0.25: an activation kept where its uniform is below
             0.75, and scaled by 1/0.75
  target     a Gaussian of σ = 25 cents around the f0's cents on the 360
             bins 20 cents apart from 32.70 Hz
  loss       mean(pw · y · softplus(−z) + (1 − y) · softplus(z)), pw 20
  adam       optax's: m ← 0.9m + 0.1g, v ← 0.999v + 0.001g², the bias
             corrections c = 1 − bⁿ computed in float32 (b and n float32,
             as optax computes them from its int32 count), the update
             −lr · (m/c1) / (√(v/c2) + 1e-8)

Departures from the paper, on purpose (those of the program's recipe): the
frames are synthesized harmonic tones, not the paper's recorded datasets;
Adam at lr 2e-3 (the paper 2e-4); the positive bins' weight of 20 in the
binary cross-entropy (the paper weights none); batch 256 (the paper 32);
BatchNorm's momentum 0.99 and ε 1e-5 (flax's, where Keras has 0.99 and
1e-3); the bias corrections in float32 (optax's).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
FRAME_LENGTH = 1024
SAMPLE_RATE = 16000
N_HARMONICS = 16
N_REFLECTIONS = 4
F0_RANGE = (40.0, 1800.0)
N_BINS = 360
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1200.0 * math.log2(32.70319566257483 / 10.0)
TARGET_SIGMA = 25.0
BN_EPS = 1e-5
BN_MOMENTUM = 0.99
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
N_LAYERS = 6


@contextlib.contextmanager
def precision(allow_tf32: bool = False):
    """TF32 off in cuBLAS and cuDNN (on for a control), restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ------------------------------------------------------------------ draws
def draws(batch: int, generator: torch.Generator, robust: bool) -> dict:
    """One batch's draws, in the recipe's order, in float32 as drawn."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    def bernoulli(p, shape):
        return torch.rand(shape, generator=generator, device=dev) < p

    d = {"f0": torch.exp(uniform((batch,), math.log(F0_RANGE[0]), math.log(F0_RANGE[1])))}
    d["alpha"] = uniform((batch, 1), 0.5, 2.5)
    d["formant_pos"] = uniform((batch, 1), 2.0, 8.0)
    d["formant_gain_exp"] = uniform((batch, 1), 0.0, 1.1)
    d["formant_width"] = uniform((batch, 1), 0.8, 2.5)
    d["phases"] = uniform((batch, N_HARMONICS), 0.0, 2.0 * math.pi)
    d["coherent"] = bernoulli(0.5, (batch, 1))
    d["vib_depth"] = uniform((batch, 1), 0.0, 0.01)
    d["vib_phase"] = uniform((batch, 1), 0.0, 2.0 * math.pi)
    d["noise"] = torch.randn((batch, FRAME_LENGTH), generator=generator, device=dev)
    d["snr_db"] = uniform((batch, 1), -2.0, 40.0) if robust else uniform((batch, 1), 5.0, 40.0)
    d["gain_exp"] = uniform((batch, 1), -2.0, 0.0)
    if robust:
        d["delays"] = torch.randint(16, 500, (batch, N_REFLECTIONS), generator=generator, device=dev)
        d["signs"] = torch.where(bernoulli(0.5, (batch, N_REFLECTIONS)), 1.0, -1.0)
        d["tap_gains"] = uniform((batch, N_REFLECTIONS), 0.15, 0.5)
        d["use_rev"] = bernoulli(0.5, (batch, 1))
        d["use_pink"] = bernoulli(0.5, (batch, 1))
        d["drive"] = uniform((batch, 1), 1.5, 4.0)
        d["use_clip"] = bernoulli(0.3, (batch, 1))
    return d


def dropout_masks(shapes, generator: torch.Generator, rate: float) -> List[torch.Tensor]:
    """One keep mask a block, (B, C, T) each, in forward order."""
    return [torch.rand(s, generator=generator, device=generator.device) < 1.0 - rate for s in shapes]


# ------------------------------------------------------------------ synth
def synth(d: dict, robust: bool, dtype: torch.dtype):
    """(frames (B, 1024), f0 (B,)) in `dtype` from the draws `d`."""
    d = {k: v.to(dtype) if v.is_floating_point() else v for k, v in d.items()}
    f0 = d["f0"]
    dev = f0.device
    t = torch.arange(FRAME_LENGTH, device=dev, dtype=dtype) / SAMPLE_RATE
    k = torch.arange(1, N_HARMONICS + 1, device=dev, dtype=dtype)
    amps = k ** -d["alpha"]
    bump = torch.exp(-0.5 * ((k - d["formant_pos"]) / d["formant_width"]) ** 2)
    amps = amps * (1.0 + 10.0 ** d["formant_gain_exp"] * bump)
    amps = amps * (k * f0[:, None] < SAMPLE_RATE / 2)
    amps = amps / amps.sum(-1, keepdim=True)
    start = torch.where(d["coherent"], 0.0, d["phases"])
    freq = f0[:, None] * (1.0 + d["vib_depth"] * torch.sin(2.0 * math.pi * 5.0 * t + d["vib_phase"]))
    theta = 2.0 * math.pi * torch.cumsum(freq, -1) / SAMPLE_RATE  # (B, T)
    sig = (amps[:, None, :] * torch.sin(theta[:, :, None] * k + start[:, None, :])).sum(-1)
    white = d["noise"]
    if robust:
        ir = torch.zeros_like(sig)
        ir.scatter_add_(1, d["delays"], d["signs"] * d["tap_gains"])
        ir[:, 0] = 1.0
        room = torch.fft.irfft(torch.fft.rfft(sig) * torch.fft.rfft(ir), FRAME_LENGTH)
        sig = torch.where(d["use_rev"], room, sig)
        bins = torch.arange(FRAME_LENGTH // 2 + 1, device=dev, dtype=dtype).clamp(min=1.0)
        pink = torch.fft.irfft(torch.fft.rfft(white) / bins.sqrt(), FRAME_LENGTH)
        pink = pink / (pink.std(-1, keepdim=True, correction=0) + 1e-9)
        unit = torch.where(d["use_pink"], pink, white)
    else:
        unit = white
    out = sig + unit * sig.pow(2).mean(-1, keepdim=True).sqrt() * 10.0 ** (-d["snr_db"] / 20.0)
    if robust:
        peak = out.abs().amax(-1, keepdim=True) + 1e-9
        clipped = torch.tanh(d["drive"] * out / peak) * peak / torch.tanh(d["drive"])
        out = torch.where(d["use_clip"], clipped, out)
    return out * 10.0 ** d["gain_exp"], f0


# ---------------------------------------------------------------- network
def same_padding(length: int, width: int, stride: int):
    out = -(-length // stride)
    total = max((out - 1) * stride + width - length, 0)
    return total // 2, total - total // 2


def block_shapes(model: dict, batch: int) -> list:
    """(B, C, T) of each block's output (the dropout masks' shapes)."""
    shapes, length = [], FRAME_LENGTH
    for c, s in zip(model["filters"], model["strides"]):
        length = -(-length // s) // 2
        shapes.append((batch, c, length))
    return shapes


def batch_norm_train(x, weight, bias, running_mean, running_var):
    """(normalized x, new running mean, new running variance)."""
    mean = x.mean((0, 2))
    var = torch.clamp((x * x).mean((0, 2)) - mean * mean, min=0.0)
    y = (x - mean[:, None]) / torch.sqrt(var[:, None] + BN_EPS) * weight[:, None] + bias[:, None]
    m = BN_MOMENTUM
    return y, m * running_mean + (1 - m) * mean.detach(), m * running_var + (1 - m) * var.detach()


def dropout(x, keep_mask, rate: float):
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def forward(p: Params, model: dict, frames: torch.Tensor, masks):
    """Train-mode logits (B, 360) and the new running statistics."""
    x = frames - frames.mean(-1, keepdim=True)
    x = (x / torch.clamp(frames.std(-1, keepdim=True, correction=0), min=1e-6))[:, None, :]
    stats, length = {}, FRAME_LENGTH
    for i in range(N_LAYERS):
        n = i + 1
        width, stride = model["widths"][i], model["strides"][i]
        x = F.conv1d(F.pad(x, same_padding(length, width, stride)), p[f"conv{n}.weight"],
                     p[f"conv{n}.bias"], stride)
        length = x.shape[-1] // 2
        x, stats[f"bn{n}.running_mean"], stats[f"bn{n}.running_var"] = batch_norm_train(
            torch.relu(x), p[f"bn{n}.weight"], p[f"bn{n}.bias"], p[f"bn{n}.running_mean"],
            p[f"bn{n}.running_var"])
        x = dropout(F.max_pool1d(x, 2, 2), masks[i], model["dropout"])
    x = x.transpose(1, 2).reshape(x.shape[0], -1)
    return x @ p["classifier.weight"].T + p["classifier.bias"], stats


def target(f0: torch.Tensor) -> torch.Tensor:
    grid = CENTS_OFFSET + CENTS_PER_BIN * torch.arange(N_BINS, device=f0.device, dtype=f0.dtype)
    cents = 1200.0 * torch.log2(torch.clamp(f0, min=1e-6) / 10.0)
    return torch.exp(-0.5 * ((grid - cents[:, None]) / TARGET_SIGMA) ** 2)


def loss_fn(logits, y, pos_weight: float):
    return torch.mean(pos_weight * y * F.softplus(-logits) + (1.0 - y) * F.softplus(logits))


# ------------------------------------------------------------------- adam
def adam(p, g, m, v, count: int, lr: float):
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    n = torch.tensor(float(count), device=p.device)  # float32, as optax's int32 count is cast
    c1, c2 = (1 - torch.pow(B1, n)).to(p.dtype), (1 - torch.pow(B2, n)).to(p.dtype)
    return p - lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS), m, v


def train_steps(state: Params, generator: torch.Generator, cfg: dict, steps: int,
                dtype: torch.dtype = torch.float64, allow_tf32: bool = False) -> dict:
    """`steps` Adam steps of configuration `cfg` from `state` (parameters and
    running statistics; not changed), drawing from `generator` (advanced).
    Returns {"frames": the first step's frames, "f0": its f0, "grads": its
    gradients, "losses": each step's loss, "states": the parameters and
    statistics after each step}."""
    model, tc = cfg["model"], cfg["train"]
    names = [k for k in state if not k.split(".")[1].startswith("running_")]
    p = {k: v.detach().to(dtype) for k, v in state.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    out = {"losses": [], "states": []}
    with precision(allow_tf32):
        for n in range(1, steps + 1):
            frames, f0 = synth(draws(tc["batch"], generator, tc["robust"]), tc["robust"], dtype)
            masks = dropout_masks(block_shapes(model, tc["batch"]), generator, model["dropout"])
            leaves = {k: p[k].clone().requires_grad_(True) for k in names}
            logits, stats = forward({**p, **leaves}, model, frames, masks)
            loss = loss_fn(logits, target(f0), tc["pos_weight"])
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            if n == 1:
                out["frames"], out["f0"], out["grads"] = frames, f0, dict(zip(names, grads))
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                for k, g in zip(names, grads):
                    p[k], m[k], v[k] = adam(p[k], g, m[k], v[k], n, tc["lr"])
                p.update({k: s.detach() for k, s in stats.items()})
            out["states"].append(dict(p))
    return out
