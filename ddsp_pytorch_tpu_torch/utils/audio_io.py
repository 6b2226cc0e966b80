"""Wav writing through the standard library's `wave` module.

Port of `save_wav` (ddsp_pytorch_tpu/utils/audio_io.py:38-42), which
writes through scipy.io.wavfile: the same 16-bit PCM samples, mono.
"""

from __future__ import annotations

import wave

import numpy as np


def pcm16(audio) -> np.ndarray:
    """float audio in [-1, 1] → int16 samples: clipped, × 32767, truncated
    toward zero (numpy's float → int16 cast)."""
    clipped = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype(np.int16)


def save_wav(path: str, audio, sample_rate: int) -> None:
    """Write mono float32 audio in [-1, 1] as 16-bit PCM."""
    samples = pcm16(audio).reshape(-1)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(samples.astype("<i2").tobytes())
