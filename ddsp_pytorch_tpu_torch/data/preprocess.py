"""Offline preprocessing: wav files → the `.npy` feature cache.

Port of ddsp_pytorch_tpu/data/preprocess.py:31-218 (`get_files`,
`preprocess`, `default_crepe_params`, `make_pitch_fn`,
`preprocess_folder`; its `main` is the preprocess CLI,
ddsp_pytorch_tpu_torch/preprocess.py): each file is loaded at the config's
sample rate (utils/audio_io.load_wav), zero-padded to a multiple of
signal_length (or cut to one chunk if oneshot) and chunked; pitch,
A-weighted loudness and the MFCCs (F + 1 frames a chunk) are extracted for
all of a file's chunks at once on `device`; each partition's rows are
saved as {signals,pitchs,loudness,mfccs}.npy under
preprocess.out_dir/<partition>.  With `features=False` (a model that
trains on raw crops, RAVE v1) signals.npy is written alone: the same
chunks, no feature extracted.

Pitch trackers (preprocess.pitch_tracker): "hybrid", the default (CREPE ×
YIN, models/crepe.py), "crepe" (the CREPE network alone) and "yin"
(ops/pitch.py).  The CREPE trackers read preprocess.crepe_params, or the
shipped pretrained/crepe_tiny.msgpack.
"""

from __future__ import annotations

import functools
import os
import pathlib
from typing import List

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models.crepe import extract_pitch_crepe, extract_pitch_hybrid, load_crepe
from ddsp_pytorch_tpu_torch.ops.loudness import extract_loudness
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch
from ddsp_pytorch_tpu_torch.ops.spectral import mfcc as mfcc_op
from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav

CACHE_NAMES = ("signals", "pitchs", "loudness", "mfccs")


def get_files(data_location, extension: str = "wav") -> List[pathlib.Path]:
    """Recursive glob of audio files by extension, sorted."""
    return sorted(pathlib.Path(data_location).rglob(f"*.{extension}"))


def preprocess(
    f,
    sample_rate: int,
    block_size: int,
    signal_length: int,
    oneshot: bool = False,
    pitch_fmin: float = 50.0,
    pitch_fmax: float = 2000.0,
    n_mfcc: int = 30,
    mfcc_n_fft: int = 1024,
    mfcc_fmin: float = 20.0,
    mfcc_fmax: float = 8000.0,
    n_mels: int = 128,
    mfcc_ref_db: float | None = None,
    loudness_n_fft: int = 2048,
    pitch_fn=None,
    *,
    device="cuda",
):
    """One file → float32 numpy (signals (N, L), pitch (N, F), loudness
    (N, F), mfcc (N, F + 1, n_mfcc)) chunk rows, the features extracted on
    `device` for all N chunks at once.  pitch_fn: (chunks (N, L) tensor,
    sample_rate, block_size) → (N, F) f0; default the YIN tracker between
    pitch_fmin and pitch_fmax."""
    device = resolve_device(device)
    chunks = crop_chunks(f, sample_rate, signal_length, oneshot)
    xt = torch.tensor(chunks, dtype=torch.float32, device=device)
    if pitch_fn is None:
        pitch_fn = functools.partial(extract_pitch, fmin=pitch_fmin, fmax=pitch_fmax, device=device)
    pitch = pitch_fn(xt, sample_rate, block_size)
    loudness = extract_loudness(xt, sample_rate, block_size, loudness_n_fft, device=device)
    mfcc = mfcc_op(xt, sample_rate, n_mfcc=n_mfcc, n_fft=mfcc_n_fft, hop_length=block_size,
                   fmin=mfcc_fmin, fmax=mfcc_fmax, n_mels=n_mels, ref_db=mfcc_ref_db)
    return (
        chunks.astype(np.float32),
        pitch.cpu().numpy().astype(np.float32),
        loudness.cpu().numpy().astype(np.float32),
        mfcc.cpu().numpy().astype(np.float32),
    )


def default_crepe_params():
    """Path of the shipped CREPE weights (pretrained/crepe_tiny.msgpack), or
    None where the checkout has no pretrained/ tree."""
    shipped = pathlib.Path(__file__).resolve().parents[2] / "pretrained" / "crepe_tiny.msgpack"
    return str(shipped) if shipped.exists() else None


def make_pitch_fn(config: Config, device="cuda"):
    """The pitch tracker of config.preprocess.pitch_tracker, as preprocess's
    pitch_fn (chunks (N, L) or a row (L,), sample_rate, block_size) →
    (…, F) f0 on `device`, searching between pitch_fmin and pitch_fmax:
    "hybrid" (the CREPE × YIN fused decode), "crepe" (the CREPE network
    alone, its salience masked to the range) or "yin".  Any other name
    raises ValueError.

    The CREPE trackers load preprocess.crepe_params (capacity
    crepe_capacity) once, onto `device`; a path that is unset or does not
    exist (a bundle's config may record a relative or another host's path)
    falls back to the shipped pretrained/crepe_tiny.msgpack."""
    pc = config.preprocess
    tracker = pc.pitch_tracker
    if tracker not in ("hybrid", "crepe", "yin"):
        raise ValueError(f"unknown pitch_tracker: {tracker!r} (hybrid|yin|crepe)")
    device = resolve_device(device)
    if tracker == "yin":
        return functools.partial(extract_pitch, fmin=pc.pitch_fmin, fmax=pc.pitch_fmax, device=device)
    crepe_params = pc.crepe_params or default_crepe_params()
    if crepe_params and not pathlib.Path(crepe_params).exists():
        crepe_params = default_crepe_params()
    if not crepe_params:
        raise ValueError(f"pitch_tracker: {tracker} needs preprocess.crepe_params: the shipped "
                         "pretrained/crepe_tiny.msgpack was not found")
    model = load_crepe(crepe_params, pc.crepe_capacity, device=device)
    extract = extract_pitch_hybrid if tracker == "hybrid" else extract_pitch_crepe
    return functools.partial(extract, model=model, fmin=pc.pitch_fmin, fmax=pc.pitch_fmax, device=device)


def crop_chunks(f, sample_rate: int, signal_length: int, oneshot: bool = False) -> np.ndarray:
    """One file → its (N, L) float32 chunks, as `preprocess` cuts them."""
    x, _ = load_wav(str(f), sample_rate)
    x = np.pad(x, (0, (signal_length - len(x) % signal_length) % signal_length))
    if oneshot:
        x = x[:signal_length]
    return x.reshape(-1, signal_length).astype(np.float32)


def preprocess_folder(root_dir, partition: str, config: Config, device="cuda", features: bool = True) -> None:
    """Process every file under root_dir/partition into the .npy cache at
    preprocess.out_dir/partition (signals.npy alone without `features`)."""
    src = pathlib.Path(root_dir) / partition
    if not src.exists():
        raise FileNotFoundError(f"{src} does not exist")
    files = get_files(src, config.data.extension)
    if not files:
        raise FileNotFoundError(f"no *.{config.data.extension} files under {src}")
    pc = config.preprocess
    out_dir = os.path.join(pc.out_dir, partition)
    if not features:
        chunks = [crop_chunks(f, pc.sample_rate, pc.signal_length, pc.oneshot) for f in files]
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "signals.npy"), np.concatenate(chunks, 0))
        return
    pitch_fn = make_pitch_fn(config, device)
    rows = {name: [] for name in CACHE_NAMES}
    for i, f in enumerate(files):
        print(f"[{i + 1}/{len(files)}] {f}")
        out = preprocess(
            f,
            sample_rate=pc.sample_rate,
            block_size=pc.block_size,
            signal_length=pc.signal_length,
            oneshot=pc.oneshot,
            n_mfcc=pc.n_mfcc,
            mfcc_n_fft=pc.mfcc_n_fft,
            mfcc_fmin=pc.mfcc_fmin,
            mfcc_fmax=pc.mfcc_fmax,
            n_mels=pc.n_mels,
            mfcc_ref_db=pc.mfcc_ref_db,
            loudness_n_fft=pc.loudness_n_fft,
            pitch_fn=pitch_fn,
            device=device,
        )
        for name, arr in zip(CACHE_NAMES, out):
            rows[name].append(arr)
    os.makedirs(out_dir, exist_ok=True)
    for name, arrs in rows.items():
        np.save(os.path.join(out_dir, f"{name}.npy"), np.concatenate(arrs, 0))
