"""VoicePool — slot-based batched streaming for multi-session serving.

Port of ddsp_pytorch_tpu/streaming/pool.py:58-149.  One StreamingSynth at
batch = V; every concurrent session owns a row ("slot") of one batched
StreamState:

  * each dispatch advances every requesting slot in lockstep
    (StreamingSynth.step_stateless_masked); the other slots keep their
    state bit for bit, so a slot streams what an independent batch-1
    stream would (tests/test_torch_voice_pool.py);
  * acquire()/release() manage slots and zero the slot's carries (GRU,
    phase, reverb delay line, encoder GRU) in place on the device;
  * the noise generator is the pool's: it advances on every dispatch and
    draws (V, F, S) noise for all rows (pool.py:18-19, serve.py:91-95).

serve.py's multi-voice mode is built on this: a dispatcher thread batches
the sessions' pending requests into single dispatches.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.streaming import StreamingSynth


class VoicePool:
    """Up to `synth.batch` concurrent streams through one batched step.

    Thread-safe: acquire, release and step serialize on an internal lock.
    """

    def __init__(self, synth: StreamingSynth):
        self.synth = synth
        self.voices = synth.batch
        self.block_size = synth.block_size
        self.sample_rate = synth.sample_rate
        self._state = synth.fresh_state()
        self._free = list(range(self.voices - 1, -1, -1))
        self._lock = threading.Lock()

    def _reset(self, slot: int) -> None:
        """Zero one voice's carries in place; the noise generator is left
        alone.  (Steps return inference tensors, which only change inside
        inference mode.)"""
        state = self._state
        with torch.inference_mode():
            carries = [state.gru, state.phase, state.enc_gru]
            if state.reverb is not None:
                carries += list(state.reverb)
            for t in carries:
                if t is not None:
                    t[slot].zero_()

    # ------------------------------------------------------------ slots
    def acquire(self) -> Optional[int]:
        """Claim a slot with fresh state; None when the pool is full."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._reset(slot)
            return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._free:
                return
            self._reset(slot)
            self._free.append(slot)

    @property
    def active_count(self) -> int:
        with self._lock:
            return self.voices - len(self._free)

    # ------------------------------------------------------------- step
    def step(self, requests: Dict[int, Tuple[np.ndarray, ...]]) -> Dict[int, np.ndarray]:
        """One batched dispatch serving every requesting slot.

        requests: slot → (f0_frames (F, 1), loudness_frames (F, 1)), plus
        mfcc_frames (F, n_mfcc) as a third element on an autoencoder pool;
        every request of one call has the same F.  Returns slot → (F·block,)
        host audio.  Slots without a request keep their state.

        The requesting rows come back in one device gather and one host
        pull, not a copy per slot.
        """
        if not requests:
            return {}
        autoencoder = self.synth.autoencoder
        frames = {np.asarray(r[0]).shape[0] for r in requests.values()}
        if len(frames) != 1:
            raise ValueError(
                f"all requests in one dispatch must share a frame count, got {sorted(frames)}"
            )
        (f,) = frames
        v = self.voices
        f0 = np.zeros((v, f, 1), np.float32)
        loud = np.zeros((v, f, 1), np.float32)
        mfcc = None
        active = np.zeros((v,), bool)
        for slot, req in requests.items():
            if not 0 <= slot < v:
                raise ValueError(f"slot {slot} is not in 0..{v - 1}")
            if autoencoder and len(req) != 3:
                raise ValueError("mfcc-autoencoder pool: requests are (f0, loudness, mfcc_frames)")
            f0[slot] = np.asarray(req[0], np.float32).reshape(f, 1)
            loud[slot] = np.asarray(req[1], np.float32).reshape(f, 1)
            if autoencoder:
                mf = np.asarray(req[2], np.float32)
                if mfcc is None:
                    mfcc = np.zeros((v, f, mf.shape[-1]), np.float32)
                mfcc[slot] = mf.reshape(f, -1)
            active[slot] = True
        order = sorted(requests)
        with self._lock:
            audio, self._state = self.synth.step_stateless_masked(
                self._state, f0, loud, active, mfcc_frames=mfcc
            )
            index = torch.tensor(order, dtype=torch.long, device=audio.device)
            rows = audio.index_select(0, index).cpu().numpy()
        return {s: rows[i] for i, s in enumerate(order)}
