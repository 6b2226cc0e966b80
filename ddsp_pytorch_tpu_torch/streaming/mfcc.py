"""Causal block-streaming MFCC extraction, on the host in numpy.

Port of ddsp_pytorch_tpu/streaming/mfcc.py:19-156, reading this package's
own constants (ops/spectral.py `mel_filterbank`, `dct_matrix`,
`hann_window`).  It runs on the host, as the JAX one does and for the same
reason (`:70-74`): a session pushes one block at a time on its serving
thread, where a device version would cost a dozen tiny launches and a
device→host pull per block for 30 numbers a frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ddsp_pytorch_tpu_torch.ops.spectral import dct_matrix, hann_window, mel_filterbank


class StreamingMFCC:
    """Causal block-streaming MFCC giving exactly the offline `mfcc` frames.

    Offline, frame j of `mfcc(signal, hop_length=hop)` windows samples
    [j·hop − n_fft/2, j·hop + n_fft/2) of the center-reflect-padded signal.
    This class buffers pushed audio and emits each frame as soon as its last
    sample has arrived: frame j needs j·hop + n_fft/2 samples, except frame
    0, whose left reflect pad mirrors x[1..n_fft/2] and so needs n_fft/2 + 1.
    With n_fft = 2·hop that is one frame a block from block 1 on (block 1
    releases frames 0 and 1).

    The offline dB floor clips against the whole spectrogram's maximum,
    which depends on future frames; a stream floors against a fixed
    `ref_db` (None: no floor).  Offline `mfcc` with the same ref_db gives
    the same frames.
    """

    def __init__(
        self,
        sample_rate: int,
        *,
        batch: int = 1,
        n_mfcc: int = 30,
        n_fft: int = 1024,
        hop_length: int = 512,
        fmin: float = 20.0,
        fmax: float = 8000.0,
        n_mels: int = 128,
        ref_db: Optional[float] = None,
    ):
        if n_fft > 2 * hop_length:
            raise ValueError(
                "StreamingMFCC needs n_fft <= 2*hop_length (frame j must be computable "
                f"from blocks 0..j); got n_fft={n_fft}, hop={hop_length}"
            )
        self.sample_rate = int(sample_rate)
        self.batch = int(batch)
        self.n_mfcc = int(n_mfcc)
        self.n_fft = int(n_fft)
        self.hop = int(hop_length)
        self.ref_db = ref_db
        self._fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
        self._dct = dct_matrix(n_mfcc, n_mels)
        self._win = hann_window(self.n_fft).numpy()
        self.reset()

    def reset(self) -> None:
        self._raw = np.zeros((self.batch, 0), np.float32)  # samples before the pad exists
        self._buf = None  # the padded stream from the next frame's window on
        self._next = 0  # index of the next frame to emit

    def push(self, samples) -> np.ndarray:
        """Append (B, n) samples; return every newly computable MFCC frame,
        (B, k, n_mfcc) with k ≥ 0 (k varies at the stream's start)."""
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 2 or samples.shape[0] != self.batch:
            raise ValueError(f"expected (batch={self.batch}, n) samples")
        pad = self.n_fft // 2
        if self._buf is None:
            self._raw = np.concatenate([self._raw, samples], axis=1)
            if self._raw.shape[1] < pad + 1:
                return np.zeros((self.batch, 0, self.n_mfcc), np.float32)
            # the left reflect pad, as the offline STFT's: x[pad], ..., x[1]
            left = self._raw[:, 1 : pad + 1][:, ::-1]
            self._buf = np.concatenate([left, self._raw], axis=1)
            self._raw = np.zeros((self.batch, 0), np.float32)
        else:
            self._buf = np.concatenate([self._buf, samples], axis=1)

        n_avail = (self._buf.shape[1] - self.n_fft) // self.hop + 1 if self._buf.shape[1] >= self.n_fft else 0
        if n_avail <= 0:
            return np.zeros((self.batch, 0, self.n_mfcc), np.float32)

        # offline mfcc's steps per frame: window → rfft → power → mel → dB
        # floor → DCT
        seg = self._buf[:, : (n_avail - 1) * self.hop + self.n_fft]
        idx = np.arange(n_avail)[:, None] * self.hop + np.arange(self.n_fft)[None, :]
        frames = seg[:, idx] * self._win  # (B, k, n_fft)
        power = np.square(np.abs(np.fft.rfft(frames, axis=-1))).astype(np.float32)
        mel = np.einsum("mf,bkf->bkm", self._fb, power)
        log_spec = 10.0 * np.log10(np.maximum(1e-10, mel))
        if self.ref_db is not None:
            log_spec = np.maximum(log_spec, np.float32(self.ref_db) - 80.0)
        out = np.einsum("cm,bkm->bkc", self._dct, log_spec)  # (B, k, n_mfcc)

        self._buf = self._buf[:, n_avail * self.hop :]
        self._next += n_avail
        return out
