"""The training corpus, made on the device from the seed.

Each item is a glide: an exponential f0 path between two pitches in
80–1000 Hz over the excerpt, a loudness that swells around its own level,
and the excerpt itself, three harmonics of the glide under that loudness
over a white noise floor at -85 dB of full scale (RMS), as a recording
has; the autoencoder's items carry the excerpt's MFCC frames too.  Every
seed makes the same number of items of the same length.

The floor keeps every bin of the loss's spectra above float32's rounding:
over digital silence, the bins above the third harmonic would be rounding
(~1e-7, the size of the loss's log floor), and their logs would set the
loss's gap between float32 and float64 by themselves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.lib.weights import sub_seed
from benchmark.reference.ddsp import mfcc_frames

NOISE_FLOOR = 1e-4  # peak of the uniform floor: RMS 5.8e-5, -85 dB of full scale


class Corpus:
    """Numpy arrays shaped as the program's feature cache keeps them:
    signals (N, T), pitchs (N, F), loudness (N, F) and, for the
    autoencoder, mfccs (N, F + 1, n_mfcc)."""

    def __init__(self, signals, pitchs, loudness, mfccs=None):
        self.signals = signals
        self.pitchs = pitchs
        self.loudness = loudness
        self.mfccs = mfccs

    def __len__(self) -> int:
        return self.signals.shape[0]


def make_corpus(cfg: dict, n_items: int, seed: int, device) -> Corpus:
    pre, m = cfg["preprocess"], cfg["model"]
    sr, block, t = m["sample_rate"], m["block_size"], pre["signal_length"]
    frames = t // block
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    u = torch.rand((n_items, 6), generator=gen, device=device, dtype=torch.float64)
    log_lo, log_hi = math.log(80.0), math.log(1000.0)
    f_a = torch.exp(log_lo + (log_hi - log_lo) * u[:, 0:1])
    log_r = (0.2 + 1.5 * u[:, 1:2]) * torch.where(u[:, 2:3] < 0.5, -1.0, 1.0)
    level = -45.0 + 25.0 * u[:, 3:4]
    swell = 3.0 + 12.0 * u[:, 4:5]
    phase0 = 2 * math.pi * u[:, 5:6]
    dur = t / sr
    ts = torch.arange(t, device=device, dtype=torch.float64)[None] / sr
    growth = torch.exp(log_r * ts / dur)
    loud_s = level + swell * torch.sin(2 * math.pi * ts / dur + phase0)
    phase = torch.remainder(2 * math.pi * f_a * dur / log_r * (growth - 1.0), 2 * math.pi)
    tone = (torch.sin(phase) + 0.5 * torch.sin(2 * phase) + 0.25 * torch.sin(3 * phase)) / 1.75
    floor = NOISE_FLOOR * (torch.rand((n_items, t), generator=gen, device=device,
                                      dtype=torch.float64) * 2.0 - 1.0)
    signals = (10.0 ** (loud_s / 20.0) * tone + floor).float()
    at_frames = torch.arange(frames, device=device) * block
    pitchs = (f_a * growth[:, at_frames]).float()
    loudness = loud_s[:, at_frames].float()
    mfccs = None
    if m["name"] == "mfcc-autoencoder":
        mf = mfcc_frames(signals.double(), pre, frames).float()
        # the cache keeps F + 1 frames; the program drops the last at upload
        mfccs = torch.cat([mf, mf[:, -1:]], dim=1).cpu().numpy()
    return Corpus(signals.cpu().numpy(), pitchs.cpu().numpy(), loudness.cpu().numpy(), mfccs)


def loudness_stats(corpus: Corpus):
    """(mean, std) of the corpus loudness, the normalisation both sides use."""
    x = corpus.loudness.astype(np.float64)
    return float(x.mean()), float(x.std())
