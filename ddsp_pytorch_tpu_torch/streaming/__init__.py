"""L6a — stateful block-streaming inference.

Port of ddsp_pytorch_tpu/streaming/__init__.py:29-386 for both model
families.  A StreamState carries the GRU hidden state, the oscillator phase
and the noise generator's state, plus the in-stream reverb's delay line
and the encoder GRU's carry where those exist; each `step` renders one or
more blocks and streamed output equals offline output
(tests/test_torch_streaming.py, tests/test_torch_autoencoder.py).

`step_stateless` is pure, as the JAX step is (it splits a key,
streaming/__init__.py:125-128): the noise generator's state travels by
value in the StreamState (the bytes of `torch.Generator.get_state()`); a
step builds a generator from it, draws, and returns the advanced bytes in
the new state.  The state passed in is never mutated, so replaying a state
repeats its audio and two holders of one state draw the same noise.

`step_stateless_masked` is the VoicePool's step (`:170-188`, `:245-259`):
every row renders, but a row whose `active` is False keeps its GRU, phase,
reverb and encoder carries bit for bit.  The noise generator is the
batch's: it advances on every dispatch and draws (B, F, S) for all rows.

Differences from the JAX version, by design: the noise is
torch.Generator's stream, not jax.random's; steps run under
torch.inference_mode().
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.models.encoder import DDSPAutoencoder
from ddsp_pytorch_tpu_torch.ops import partitioned_conv as pconv
from ddsp_pytorch_tpu_torch.streaming.mfcc import StreamingMFCC  # noqa: F401


@dataclass
class StreamState:
    gru: torch.Tensor  # (B, hidden) decoder GRU carry
    phase: torch.Tensor  # (B,) oscillator phase carry, radians in [0, 2π)
    noise_state: torch.Tensor  # uint8 state of the noise torch.Generator
    reverb: Optional[pconv.ConvState] = None  # in-stream reverb's delay line
    enc_gru: Optional[torch.Tensor] = None  # (B, hidden) encoder GRU carry (autoencoder)


def init_stream_state(
    hidden_size: int,
    batch: int = 1,
    seed: int = 0,
    reverb_state: Optional[pconv.ConvState] = None,
    enc_hidden_size: Optional[int] = None,
    device="cuda",
) -> StreamState:
    """A stream's initial state (streaming/__init__.py:38-55): zero GRU and
    phase carries, the noise generator on `device` seeded with `seed`, the
    reverb's delay line as given, and a zero encoder carry where
    enc_hidden_size is set (the autoencoder)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return StreamState(
        gru=torch.zeros((batch, hidden_size), device=device),
        phase=torch.zeros((batch,), device=device),
        noise_state=gen.get_state(),
        reverb=reverb_state,
        enc_gru=None if enc_hidden_size is None else torch.zeros((batch, enc_hidden_size), device=device),
    )


def _keep(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Rows of `new` where `active`, rows of `old` elsewhere."""
    return torch.where(active.reshape(active.shape + (1,) * (new.dim() - 1)), new, old)


class StreamingSynth:
    """Block-streaming synthesizer around a DDSPDecoder or DDSPAutoencoder
    with loaded weights.

    `step(f0_frames, loudness_frames[, mfcc_frames])` takes frame-rate
    controls (B, F, 1) (and, for the autoencoder, MFCC frames (B, F,
    n_mfcc)) and returns (B, F·block_size) audio on the synth's device;
    `step_samples(pitch, loudness)` takes sample-rate controls (B, n) and
    decimates them by block_size.  Loudness is normalized with the bundle's
    stats (streaming/__init__.py:127).

    include_reverb=True applies the model's trained reverb in the stream:
    its 1 s impulse (`Reverb.build_impulse`) as a partitioned convolution
    (ops/partitioned_conv.py), whose delay line travels in the state.
    """

    needs_audio = False  # AutoencoderStreamSession's is True

    def __init__(
        self,
        model,
        mean_loudness: float = 0.0,
        std_loudness: float = 1.0,
        batch: int = 1,
        seed: int = 0,
        noise_deterministic: bool = False,  # zero noise: harmonic-only output
        include_reverb: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.block_size = int(model.block_size)
        self.sample_rate = int(model.sample_rate)
        self.mean_loudness = float(mean_loudness)
        self.std_loudness = float(std_loudness)
        self.noise_deterministic = bool(noise_deterministic)
        self.autoencoder = isinstance(model, DDSPAutoencoder)
        self._batch = int(batch)
        self._pir = None
        if include_reverb:
            reverb = getattr(self.model, "reverb", None)
            if reverb is None:
                raise ValueError("include_reverb=True but the model has no reverb")
            with torch.no_grad():
                self._pir = pconv.partition_ir(reverb.build_impulse(), self.block_size)
        self.state = self.fresh_state(seed)

    @property
    def batch(self) -> int:
        return self._batch

    def fresh_state(self, seed: int = 0) -> StreamState:
        """A new independent stream state (per-session state for servers
        that share this synth)."""
        return init_stream_state(
            self.model.hidden_size,
            self._batch,
            seed,
            None if self._pir is None else pconv.init_state(self._pir, (self._batch,)),
            enc_hidden_size=self.model.hidden_size if self.autoencoder else None,
            device=self.device,
        )

    def reset(self, seed: int = 0) -> None:
        self.state = self.fresh_state(seed)

    def _as_f32(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        # a copy: numpy inputs may be read-only views (np.frombuffer)
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def _step(self, state: StreamState, f0_frames, loudness_frames, active=None, mfcc_frames=None):
        if self.autoencoder and mfcc_frames is None:
            raise ValueError("mfcc-autoencoder stream: pass mfcc frames (B, F, n_mfcc), "
                             "e.g. from streaming/mfcc.py StreamingMFCC")
        f0 = self._as_f32(f0_frames)
        loudness = self._as_f32(loudness_frames)
        with torch.inference_mode():
            # times the reciprocal: what XLA compiles the JAX step's division
            # by a constant to, bit for bit (a bf16 model would turn one
            # float32 ulp here into a bf16 rounding of its first layer)
            loudness = (loudness - self.mean_loudness) * (1.0 / self.std_loudness)
            b, f = f0.shape[0], f0.shape[1]
            noise_state = state.noise_state
            if self.noise_deterministic:
                noise = torch.zeros((b, f, self.block_size), device=self.device)
            else:
                gen = torch.Generator(device=self.device)
                gen.set_state(noise_state)
                noise = (
                    torch.rand((b, f, self.block_size), generator=gen, device=self.device)
                    * 2.0
                    - 1.0
                )
                noise_state = gen.get_state()
            enc_gru = state.enc_gru
            if self.autoencoder:
                audio, enc_gru, gru, phase = self.model.streaming_step(
                    f0, loudness, self._as_f32(mfcc_frames), state.enc_gru, state.gru, state.phase,
                    noise,
                )
            else:
                audio, gru, phase = self.model.streaming_step(
                    f0, loudness, state.gru, state.phase, noise
                )
            # a bf16 model returns its carries in bf16; the state keeps
            # float32, which holds them exactly (the JAX pool's jnp.where
            # promotes them so, streaming/__init__.py:175-184)
            gru = gru.to(state.gru.dtype)
            if enc_gru is not None:
                enc_gru = enc_gru.to(state.enc_gru.dtype)
            reverb = state.reverb
            if self._pir is not None:
                audio, reverb = pconv.streaming_convolve(self._pir, state.reverb, audio)
            if active is not None:
                gru = _keep(active, gru, state.gru)
                phase = _keep(active, phase, state.phase)
                if enc_gru is not None:
                    enc_gru = _keep(active, enc_gru, state.enc_gru)
                if reverb is not None:
                    reverb = pconv.ConvState(*(_keep(active, n, o) for n, o in zip(reverb, state.reverb)))
        return audio, StreamState(gru=gru, phase=phase, noise_state=noise_state, reverb=reverb,
                                  enc_gru=enc_gru)

    def step_stateless(self, state: StreamState, f0_frames, loudness_frames, mfcc_frames=None):
        """(state, controls (B, F, 1)[, mfcc frames]) → (audio (B, F·S), new
        state).  Pure: `state` is left as it was."""
        return self._step(state, f0_frames, loudness_frames, mfcc_frames=mfcc_frames)

    def step_stateless_masked(self, state: StreamState, f0_frames, loudness_frames, active,
                              mfcc_frames=None):
        """As step_stateless, but only the rows whose `active` (B,) is True
        advance: the others keep their carries bit for bit, and their output
        rows mean nothing.  The noise generator advances regardless."""
        active = torch.as_tensor(np.asarray(active, bool), device=self.device)
        if active.shape != (self._batch,):
            raise ValueError(f"active must be ({self._batch},), got {tuple(active.shape)}")
        return self._step(state, f0_frames, loudness_frames, active, mfcc_frames)

    def step(self, f0_frames, loudness_frames, mfcc_frames=None) -> torch.Tensor:
        """Frame-rate controls (B, F, 1) → (B, F·block_size) audio."""
        audio, self.state = self.step_stateless(self.state, f0_frames, loudness_frames, mfcc_frames)
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


class AutoencoderStreamSession:
    """Sample-rate streaming session for mfcc-autoencoder bundles
    (streaming/__init__.py:306-386).

    A (shared) StreamingSynth and a per-session causal MFCC extractor behind
    the decoder's sample-rate contract, with exactly ONE block of output
    latency: MFCC frame 0's reflect pad needs one sample beyond block 0, so
    the output FIFO starts with a silent block and every response is the
    previous block's render.

    The render is pluggable: `step_fn(f0 (r, 1), loudness (r, 1), mfcc
    (r, n_mfcc)) → (r·block,) host audio`.  The default owns a private
    StreamState and calls `synth.step_stateless`; the server passes a
    lock-scoped dispatch (voices = 1) or a VoicePool dispatch (voices > 1),
    so the FIFOs and their one-block alignment live here only.  Not
    thread-safe; callers serialize.
    """

    needs_audio = True

    def __init__(self, synth: StreamingSynth, extractor, seed: int = 0, step_fn=None):
        self.synth = synth
        self.block_size = synth.block_size
        self.sample_rate = synth.sample_rate
        self._sm = extractor
        if step_fn is None:
            self.state = synth.fresh_state(seed=seed)
            step_fn = self._default_step
        self._step_fn = step_fn
        self._frames = np.zeros((0, extractor.n_mfcc), np.float32)
        self._ctrl = np.zeros((0, 2), np.float32)  # (f0, loudness) frames
        self._out = np.zeros(self.block_size, np.float32)

    def _default_step(self, f0, loud, mfcc) -> np.ndarray:
        audio, self.state = self.synth.step_stateless(
            self.state, f0[None], loud[None], mfcc_frames=mfcc[None]
        )
        return audio[0].cpu().numpy()

    def step_samples(self, pitch, loudness, audio) -> np.ndarray:
        """(n,) sample-rate pitch, loudness and input audio → (n,) output
        audio, one block late; n must be a multiple of block_size."""
        pitch = np.asarray(pitch, np.float32).reshape(-1)
        loudness = np.asarray(loudness, np.float32).reshape(-1)
        audio = np.asarray(audio, np.float32).reshape(-1)
        n = len(pitch)
        if n % self.block_size or len(loudness) != n or len(audio) != n:
            raise ValueError(f"need equal-length inputs, n % block_size({self.block_size}) == 0")
        self._frames = np.concatenate([self._frames, self._sm.push(audio[None])[0]])
        ctrl = np.stack([pitch[:: self.block_size], loudness[:: self.block_size]], axis=1)
        self._ctrl = np.concatenate([self._ctrl, ctrl])
        r = min(len(self._frames), len(self._ctrl))
        if r:
            rendered = self._step_fn(self._ctrl[:r, :1], self._ctrl[:r, 1:], self._frames[:r])
            self._frames = self._frames[r:]
            self._ctrl = self._ctrl[r:]
            self._out = np.concatenate([self._out, np.asarray(rendered, np.float32).reshape(-1)])
        out, self._out = self._out[:n], self._out[n:]
        return out
