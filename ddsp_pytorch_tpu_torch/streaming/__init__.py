"""L6a — stateful block-streaming inference.

Port of ddsp_pytorch_tpu/streaming/__init__.py:29-303 for the decoder
family.  A StreamState carries the GRU hidden state, the oscillator phase
and the noise generator; each `step` renders one or more blocks and
streamed output equals offline output (tests/test_torch_streaming.py).

Differences from the JAX version, by design:
  * the noise generator is a torch.Generator on the synth's device; a step
    advances it in place (jax.random keys are split instead), so the state
    returned by `step_stateless` shares the generator object with the state
    passed in;
  * steps run under torch.inference_mode();
  * in-stream reverb and the masked VoicePool step are not ported yet
    (ROADMAP.md §1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device


@dataclass
class StreamState:
    gru: torch.Tensor  # (B, hidden) decoder GRU carry
    phase: torch.Tensor  # (B,) oscillator phase carry, radians in [0, 2π)
    generator: torch.Generator  # noise source, on the synth's device


class StreamingSynth:
    """Block-streaming synthesizer around a DDSPDecoder with loaded weights.

    `step(f0_frames, loudness_frames)` takes frame-rate controls (B, F, 1)
    and returns (B, F·block_size) audio on the synth's device;
    `step_samples(pitch, loudness)` takes sample-rate controls (B, n) and
    decimates them by block_size.  Loudness is normalized with the bundle's
    stats (streaming/__init__.py:127).
    """

    def __init__(
        self,
        model,
        mean_loudness: float = 0.0,
        std_loudness: float = 1.0,
        batch: int = 1,
        seed: int = 0,
        noise_deterministic: bool = False,  # zero noise: harmonic-only output
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.block_size = int(model.block_size)
        self.sample_rate = int(model.sample_rate)
        self.mean_loudness = float(mean_loudness)
        self.std_loudness = float(std_loudness)
        self.noise_deterministic = bool(noise_deterministic)
        self._batch = int(batch)
        self.state = self.fresh_state(seed)

    def fresh_state(self, seed: int = 0) -> StreamState:
        """A new independent stream state (per-session state for servers
        that share this synth)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return StreamState(
            gru=torch.zeros((self._batch, self.model.hidden_size), device=self.device),
            phase=torch.zeros((self._batch,), device=self.device),
            generator=gen,
        )

    def reset(self, seed: int = 0) -> None:
        self.state = self.fresh_state(seed)

    def _as_f32(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        # a copy: numpy inputs may be read-only views (np.frombuffer)
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def step_stateless(self, state: StreamState, f0_frames, loudness_frames):
        """(state, controls (B, F, 1)) → (audio (B, F·S), new state)."""
        f0 = self._as_f32(f0_frames)
        loudness = self._as_f32(loudness_frames)
        with torch.inference_mode():
            loudness = (loudness - self.mean_loudness) / self.std_loudness
            b, f = f0.shape[0], f0.shape[1]
            if self.noise_deterministic:
                noise = torch.zeros((b, f, self.block_size), device=self.device)
            else:
                noise = (
                    torch.rand(
                        (b, f, self.block_size),
                        generator=state.generator,
                        device=self.device,
                    )
                    * 2.0
                    - 1.0
                )
            audio, gru, phase = self.model.streaming_step(
                f0, loudness, state.gru, state.phase, noise
            )
        return audio, StreamState(gru=gru, phase=phase, generator=state.generator)

    def step(self, f0_frames, loudness_frames) -> torch.Tensor:
        """Frame-rate controls (B, F, 1) → (B, F·block_size) audio."""
        audio, self.state = self.step_stateless(self.state, f0_frames, loudness_frames)
        return audio

    def step_samples(self, pitch, loudness) -> torch.Tensor:
        """Sample-rate controls (B, n) → (B, n) audio; n % block_size == 0.

        Stride-decimates the controls to frame rate (streaming/__init__.py:
        291-303)."""
        pitch = np.asarray(pitch, np.float32)
        loudness = np.asarray(loudness, np.float32)
        if pitch.shape[-1] % self.block_size or loudness.shape != pitch.shape:
            raise ValueError(
                f"need equal-shape (B, n) controls, n % {self.block_size} == 0"
            )
        return self.step(
            pitch[:, :: self.block_size, None], loudness[:, :: self.block_size, None]
        )
