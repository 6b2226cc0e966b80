"""Synthetic harmonic-tone corpus with known controls.

Port of ddsp_pytorch_tpu/data/synthetic.py:1-184 (`INSTRUMENTS`,
`_instrument_item`, `make_synthetic_dataset`): the same numpy draws in the
same order from `default_rng(seed)`, so f0, the amplitudes and the breath
noise are bitwise those of the JAX package; the audio of every item of a
partition is rendered in one call of `harmonic_synth_frames` (on the card,
the hand-written forward kernel over items × frames rows; on the CPU its
plain version), then the breath noise added, loudness and MFCCs extracted
on the same device.  Writes the same `.npy` cache: signals (N, T), pitchs
(N, F), loudness (N, F) and mfccs (N, F + 1, n_mfcc) per partition.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.ops.loudness import extract_loudness
from ddsp_pytorch_tpu_torch.ops.oscillator import harmonic_synth_frames
from ddsp_pytorch_tpu_torch.ops.spectral import mfcc as mfcc_op

# Instrument presets (synthetic.py:24-45).  Fields: f0 range (Hz), spectral
# rolloff α range (amp_k ∝ k^-α, slowly time-varying), vibrato rate (Hz) /
# depth (fractional), breath-noise level, attack/release fraction of the
# note envelope.  "tone" is the random-tone corpus.
INSTRUMENTS = {
    "tone": None,
    "violin": dict(
        f0=(196.0, 880.0), rolloff=(0.8, 1.6), vib_hz=(5.0, 7.0),
        vib_depth=(0.004, 0.012), breath=0.0008, attack=0.10, release=0.15,
    ),
    "sax": dict(
        f0=(116.0, 500.0), rolloff=(0.5, 1.1), vib_hz=(4.0, 6.0),
        vib_depth=(0.002, 0.006), breath=0.003, attack=0.05, release=0.10,
    ),
    "flute": dict(
        f0=(262.0, 1568.0), rolloff=(2.0, 3.2), vib_hz=(4.5, 6.5),
        vib_depth=(0.003, 0.009), breath=0.008, attack=0.08, release=0.12,
    ),
}


def _instrument_item(rng, preset, f, block_size, sample_rate, n_harmonic):
    """One note: (f0 (F,), amps (F, K), breath_level) from a preset
    (synthetic.py:48-82), the draws in the JAX function's order."""
    tf = np.arange(f) * block_size / sample_rate  # frame times, s
    base = np.exp(rng.uniform(np.log(preset["f0"][0]), np.log(preset["f0"][1])))
    vib_hz = rng.uniform(*preset["vib_hz"])
    vib_depth = rng.uniform(*preset["vib_depth"])
    # vibrato fades in over the first third of the note
    vib_env = np.clip(tf / max(tf[-1] / 3.0, 1e-6), 0.0, 1.0)
    f0 = (
        base * (1.0 + vib_depth * vib_env * np.sin(2 * np.pi * vib_hz * tf))
    ).astype(np.float32)

    # slowly time-varying spectral rolloff (bow pressure / embouchure drift)
    a0, a1 = rng.uniform(*preset["rolloff"]), rng.uniform(*preset["rolloff"])
    alpha = np.linspace(a0, a1, f, dtype=np.float32)[:, None]
    k = np.arange(1, n_harmonic + 1, dtype=np.float32)[None, :]
    dist = k ** (-alpha)
    # one soft formant bump at a random harmonic region
    center = rng.uniform(2.0, min(12.0, n_harmonic))
    width = rng.uniform(1.0, 3.0)
    dist = dist * (1.0 + 1.5 * np.exp(-0.5 * ((k - center) / width) ** 2))
    dist /= dist.sum(axis=-1, keepdims=True)

    # attack / sustain / release envelope with gentle amplitude drift
    att = max(int(preset["attack"] * f), 1)
    rel = max(int(preset["release"] * f), 1)
    env = np.ones(f, dtype=np.float32)
    env[:att] = np.linspace(0.0, 1.0, att, dtype=np.float32)
    env[f - rel:] = np.linspace(1.0, 0.0, rel, dtype=np.float32)
    drift = 1.0 + 0.1 * np.sin(
        2 * np.pi * rng.uniform(0.2, 0.8) * tf + rng.uniform(0, 2 * np.pi)
    )
    level = 0.3 + 0.4 * rng.random()
    amps = (level * env * drift).astype(np.float32)[:, None] * dist
    return f0, amps.astype(np.float32), preset["breath"]


def _item_controls(rng, preset, f, block_size, sample_rate, n_harmonic):
    """(f0, amps, breath) of one item before its render, the draws in the JAX
    loop's order (synthetic.py:129-149)."""
    if preset is not None:
        f0, amps, breath = _instrument_item(rng, preset, f, block_size, sample_rate, n_harmonic)
        # drop partials above Nyquist at the note's highest f0
        k = np.arange(1, n_harmonic + 1)
        amps = amps * (k[None, :] * f0[:, None] < sample_rate / 2)
        return f0, amps, breath
    base = rng.uniform(150.0, 400.0)
    wobble = rng.uniform(0.0, 0.03)
    f0 = base * (
        1.0 + wobble * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) *
                              np.arange(f) * block_size / sample_rate)
    ).astype(np.float32)
    env = 0.5 * (0.4 + 0.6 * rng.random()) * np.hanning(f).astype(np.float32)
    dist = rng.random(n_harmonic).astype(np.float32)
    dist /= dist.sum()
    return f0, env[:, None] * dist[None, :], 0.0


def make_synthetic_dataset(
    out_dir: str,
    *,
    n_items: int = 8,
    sample_rate: int = 16000,
    signal_length: int = 16384,
    block_size: int = 256,
    n_harmonic: int = 8,
    n_mfcc: int = 30,
    mfcc_n_fft: int = 1024,
    n_mels: int = 128,
    mfcc_ref_db: float | None = None,
    seed: int = 0,
    partitions=("train", "validation"),
    instrument: str = "tone",
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Write a preprocess-compatible .npy cache of synthetic notes
    (synthetic.py:85-184); returns the last partition's arrays.

    "tone" items are harmonic tones with a random slowly-varying f0 in
    [150, 400] Hz and a Hann envelope; the presets of INSTRUMENTS render
    instrument-like notes (vibrato, time-varying rolloff and formant,
    attack/release, breath noise).  Rendering, loudness and MFCCs run on
    `device`, so the default needs a card."""
    device = resolve_device(device)
    f = signal_length // block_size
    rng = np.random.default_rng(seed)
    preset = INSTRUMENTS[instrument]
    out = {}
    for partition in partitions:
        pitches, amps, noises = [], [], []
        for _ in range(n_items):
            f0, amp, breath = _item_controls(rng, preset, f, block_size, sample_rate, n_harmonic)
            noise = None
            if breath:
                # the breath noise follows the item's render in the JAX loop;
                # it depends on the amplitudes only, so it is drawn here, in
                # the same order, and added after the batched render
                level = breath * np.interp(
                    np.arange(f * block_size),
                    np.arange(f) * block_size,
                    amp.sum(-1) / max(np.max(amp.sum(-1)), 1e-6),
                )
                noise = (level * rng.standard_normal(f * block_size)).astype(np.float32)
            pitches.append(f0)
            amps.append(amp)
            noises.append(noise)
        with torch.no_grad():
            audio = harmonic_synth_frames(
                torch.tensor(np.stack(pitches), dtype=torch.float32, device=device),
                torch.tensor(np.stack(amps), dtype=torch.float32, device=device),
                block_size,
                sample_rate,
            )
        sigs = audio.cpu().numpy().astype(np.float32)
        for i, noise in enumerate(noises):
            if noise is not None:
                sigs[i] = sigs[i] + noise
        x = torch.tensor(sigs, device=device)
        louds = extract_loudness(x, sample_rate, block_size, device=device).cpu().numpy()
        mfccs = mfcc_op(x, sample_rate, n_mfcc=n_mfcc, n_fft=mfcc_n_fft, hop_length=block_size,
                        n_mels=n_mels, ref_db=mfcc_ref_db).cpu().numpy()

        pdir = os.path.join(out_dir, partition)
        os.makedirs(pdir, exist_ok=True)
        arrays = {
            "signals": sigs,
            "pitchs": np.stack(pitches),
            "loudness": louds.astype(np.float32),
            "mfccs": mfccs.astype(np.float32),
        }
        for name, arr in arrays.items():
            np.save(os.path.join(pdir, f"{name}.npy"), arr)
        out = arrays
    return out
