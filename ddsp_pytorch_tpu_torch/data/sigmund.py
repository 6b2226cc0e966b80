"""Ingest Pd/sigmund~-preprocessed 3-channel wavs.

Port of ddsp_pytorch_tpu/data/sigmund.py:21-46.  A Pure Data patch
(patches/preprocess.pd) records a 3-channel wav: channel 0 the audio,
channel 1 the pitch in Hz (sigmund~ → mtof), channel 2 the loudness.  The
file is chunked to signal_length and the pitch and loudness channels are
decimated by block_size into the .npy cache.

The wav is read by utils/audio_io.read_wav, which returns the types
scipy.io.wavfile gives, PCM and IEEE float alike; they are scaled as the
JAX function scales them.  The pitch channel holds Hz, so only a float
wav (as Pd and scripts/train_sigmund.py write) carries it unclipped.
"""

from __future__ import annotations

import os

import numpy as np

from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.utils.audio_io import read_wav


def preprocess_from_sigmund(wav_path: str, config: Config, partition: str | None = None) -> None:
    """One 3-channel sigmund wav → {signals,pitchs,loudness}.npy under
    preprocess.out_dir (/partition, if given)."""
    x, sr = read_wav(wav_path)
    pc = config.preprocess
    if sr != pc.sample_rate:
        raise ValueError(f"wav rate {sr} != config {pc.sample_rate}")
    if x.ndim != 2 or x.shape[1] < 3:
        raise ValueError("need a 3-channel sigmund wav")
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2147483648.0
    else:
        x = x.astype(np.float32)

    n_signal = pc.signal_length
    pad = (n_signal - (x.shape[0] % n_signal)) % n_signal
    x = np.pad(x, ((0, pad), (0, 0)))
    chans = x.T.reshape(x.shape[1], -1, n_signal)  # (T, C) → (C, n_chunks, n_signal)

    out_dir = pc.out_dir if partition is None else os.path.join(pc.out_dir, partition)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "signals.npy"), chans[0])
    np.save(os.path.join(out_dir, "pitchs.npy"), chans[1, :, :: pc.block_size])
    np.save(os.path.join(out_dir, "loudness.npy"), chans[2, :, :: pc.block_size])
