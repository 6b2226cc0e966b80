"""Offline inference: timbre transfer of a recording.

Port of ddsp_pytorch_tpu/inference.py:19-137 (`extract_controls`,
`timbre_transfer`, the latter split into `transfer_controls` and
`render`; the CLI is ddsp_pytorch_tpu_torch/transfer.py): f0 and
A-weighted loudness are extracted from any monophonic input, with the
bundle's own pitch tracker (preprocess.pitch_tracker of its frozen
config: hybrid, crepe or yin), shifted, and rendered through the
bundle's model over the whole clip in one StreamingSynth step (one launch
of the oscillator kernel on the card), then through its trained reverb.
An mfcc-autoencoder bundle takes its latent from the input's MFCCs, with
the bundle's frozen MFCC geometry.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device, streaming
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data.preprocess import make_pitch_fn
from ddsp_pytorch_tpu_torch.export import load_bundle
from ddsp_pytorch_tpu_torch.ops import extract_loudness, extract_pitch, fft_convolve, mfcc


def extract_controls(audio, sample_rate: int, block_size: int, *, pitch_fmin: float = 50.0,
                     pitch_fmax: float = 2000.0, pitch_fn=None, device="cuda") -> tuple:
    """(T,) audio → (f0 (F,), loudness (F,)) float32 numpy frame-rate
    controls, F = T // block_size, extracted on `device`.

    pitch_fn (make_pitch_fn's contract, (row, sample_rate, block_size) →
    (F,)) overrides the default YIN tracker between pitch_fmin and
    pitch_fmax; timbre_transfer passes the bundle's own tracker."""
    device = resolve_device(device)
    f = len(audio) // block_size
    x = torch.as_tensor(np.asarray(audio, np.float32)[: f * block_size]).to(device)
    if pitch_fn is None:
        f0 = extract_pitch(x, sample_rate, block_size, fmin=pitch_fmin, fmax=pitch_fmax, device=device)
    else:
        f0 = pitch_fn(x, sample_rate, block_size)
    loud = extract_loudness(x[None], sample_rate, block_size, device=device)[0]
    f0 = f0.cpu().numpy() if isinstance(f0, torch.Tensor) else np.asarray(f0)
    return f0[:f].astype(np.float32), loud[:f].cpu().numpy()


def transfer_controls(config: Config, audio, *, octave_shift: float = 0.0, loudness_shift: float = 0.0,
                      device="cuda") -> tuple:
    """What timbre_transfer renders from `audio` (T,) at a bundle's config:
    (f0 (F,), loudness (F,), MFCC frames (1, F, n_mfcc) or None), f0 from
    the config's pitch tracker, shifted by `octave_shift` octaves,
    loudness offset by `loudness_shift`; the MFCCs, for an
    mfcc-autoencoder, with the config's frozen geometry and dB reference,
    as the model saw them in training."""
    device = resolve_device(device)
    pc = config.preprocess
    block = pc.block_size
    f0, loud = extract_controls(audio, pc.sample_rate, block, pitch_fmin=pc.pitch_fmin,
                                pitch_fmax=pc.pitch_fmax, pitch_fn=make_pitch_fn(config, device),
                                device=device)
    mfcc_frames = None
    if config.model.name == "mfcc-autoencoder":
        x = torch.as_tensor(np.asarray(audio, np.float32)[: len(f0) * block]).to(device)
        mfcc_frames = mfcc(x[None], pc.sample_rate, n_mfcc=pc.n_mfcc, n_fft=pc.mfcc_n_fft,
                           hop_length=block, fmin=pc.mfcc_fmin, fmax=pc.mfcc_fmax, n_mels=pc.n_mels,
                           ref_db=pc.mfcc_ref_db)[:, : len(f0)]
    return f0 * (2.0 ** octave_shift), loud + loudness_shift, mfcc_frames


def render(model, config: Config, f0, loudness, mfcc_frames=None, *, include_reverb: bool = True,
           seed: int = 0, noise_deterministic: bool = False, device="cuda") -> np.ndarray:
    """Frame-rate controls (F,) (and MFCC frames (1, F, n_mfcc) for an
    autoencoder) → float32 numpy audio (F · block,) through `model`: one
    StreamingSynth step over all F frames from `seed` (noise drawn from
    torch.Generator, not jax.random; noise_deterministic=True renders
    without the noise branch), then, if include_reverb and the model has
    one, its trained impulse, cut or zero-padded to the clip, by FFT
    convolution.  Loudness is normalized with the config's stats."""
    device = resolve_device(device)
    synth = streaming.StreamingSynth(model, mean_loudness=config.data.mean_loudness or 0.0,
                                     std_loudness=config.data.std_loudness or 1.0, batch=1, seed=seed,
                                     noise_deterministic=noise_deterministic, device=device)
    f0 = np.asarray(f0, np.float32)[None, :, None]
    loudness = np.asarray(loudness, np.float32)[None, :, None]
    out = synth.step(f0, loudness, mfcc_frames)[0]
    reverb = getattr(synth.model, "reverb", None)
    if include_reverb and reverb is not None:
        with torch.inference_mode():
            ir = reverb.build_impulse()
            t = out.shape[-1]
            ir = ir[:t] if t < ir.shape[-1] else torch.nn.functional.pad(ir, (0, t - ir.shape[-1]))
            out = fft_convolve(out[None], ir[None])[0]
    return out.cpu().numpy()


def timbre_transfer(bundle_dir: str, audio, sample_rate: int, *, octave_shift: float = 0.0,
                    loudness_shift: float = 0.0, include_reverb: bool = True, seed: int = 0,
                    noise_deterministic: bool = False, device="cuda") -> np.ndarray:
    """Re-render `audio` (T,), at the bundle's sample rate (resample it
    first, e.g. utils.load_wav(path, sr)), through a trained bundle on
    `device` → float32 numpy (T // block · block,): `transfer_controls`
    (the bundle's own tracker, loudness, the shifts, the autoencoder's
    MFCCs), then `render` (one StreamingSynth step, the trained reverb)."""
    device = resolve_device(device)
    model, _ = load_bundle(bundle_dir, device=device)
    config = Config.from_yaml(os.path.join(bundle_dir, "config.yaml"))
    if sample_rate != config.preprocess.sample_rate:
        raise ValueError(f"resample the input to {config.preprocess.sample_rate} Hz first (got {sample_rate})")
    f0, loud, mfcc_frames = transfer_controls(config, audio, octave_shift=octave_shift,
                                              loudness_shift=loudness_shift, device=device)
    return render(model, config, f0, loud, mfcc_frames, include_reverb=include_reverb, seed=seed,
                  noise_deterministic=noise_deterministic, device=device)
