"""RAVE's training corpus, made on the device from the seed: raw crops of
`preprocess.signal_length` samples at the configuration's sample rate,
wide-band so that every PQMF band holds signal.

Each crop is a harmonic tone, f0 log-uniform over 55-1760 Hz with a 5 Hz
vibrato of up to 1 %, every partial below 20 kHz at an amplitude k^-α (α
over 0.3-1.2) times a random weight in 0.5-1 and a random phase, under a
level swelling around −30 to −10 dB of full scale; four noisy transients
(white noise decaying with a time constant of 5-50 ms from a peak of 0.1-
0.4 of the tone's) at random times; and the white floor of lib/corpus.py,
at −85 dB of full scale.  The partials fill the bands up to 20 kHz, the
transients and the floor the rest, so no band's log term is rounding.
Every seed makes the same number of crops of the same length.
"""

from __future__ import annotations

import math

import torch

from benchmark.lib.corpus import NOISE_FLOOR, Corpus
from benchmark.lib.weights import sub_seed

TOP_HZ = 20000.0
N_TRANSIENTS = 4


def make_corpus(cfg: dict, n_items: int, seed: int, device) -> Corpus:
    """`n_items` crops (Corpus.signals (N, T) float32, no features)."""
    sr, t = cfg["model"]["sample_rate"], cfg["preprocess"]["signal_length"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    f64 = dict(device=device, dtype=torch.float64)
    u = torch.rand((n_items, 6), generator=gen, **f64)
    f0 = torch.exp(math.log(55.0) + (math.log(1760.0) - math.log(55.0)) * u[:, 0:1])
    alpha = 0.3 + 0.9 * u[:, 1:2]
    vib = 0.01 * u[:, 2:3]
    level = -30.0 + 20.0 * u[:, 3:4]
    swell = 6.0 * u[:, 4:5]
    ts = torch.arange(t, **f64)[None] / sr
    phase = 2 * math.pi * f0 * (ts - vib / (2 * math.pi * 5.0) * torch.cos(2 * math.pi * 5.0 * ts))
    k_max = int(TOP_HZ / 55.0)
    weights = 0.5 + 0.5 * torch.rand((n_items, k_max), generator=gen, **f64)
    phases = 2 * math.pi * torch.rand((n_items, k_max), generator=gen, **f64)
    tone = torch.zeros((n_items, t), **f64)
    for k in range(1, k_max + 1):
        amp = torch.where(k * f0 * (1 + vib) < TOP_HZ, weights[:, k - 1:k] * k ** -alpha, 0.0)
        tone += amp * torch.sin(k * phase + phases[:, k - 1:k])
    tone = tone / tone.abs().amax(dim=1, keepdim=True)
    gain = 10.0 ** ((level + swell * torch.sin(2 * math.pi * ts * sr / t + 2 * math.pi * u[:, 5:6])) / 20.0)
    x = gain * tone
    starts = torch.rand((n_items, N_TRANSIENTS), generator=gen, **f64) * t / sr
    taus = 0.005 + 0.045 * torch.rand((n_items, N_TRANSIENTS), generator=gen, **f64)
    peaks = 0.1 + 0.3 * torch.rand((n_items, N_TRANSIENTS), generator=gen, **f64)
    noise = torch.rand((n_items, t), generator=gen, **f64) * 2.0 - 1.0
    env = torch.zeros_like(x)
    for j in range(N_TRANSIENTS):
        age = ts - starts[:, j:j + 1]
        env += torch.where(age >= 0, peaks[:, j:j + 1] * torch.exp(-age.clamp(min=0) / taus[:, j:j + 1]), 0.0)
    x = x + gain * env * noise
    floor = NOISE_FLOOR * (torch.rand((n_items, t), generator=gen, **f64) * 2.0 - 1.0)
    return Corpus((x + floor).float().cpu().numpy(), None, None)
