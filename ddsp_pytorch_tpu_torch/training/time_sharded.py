"""The time-sharded train step: gradients through the distributed DSP.

Port of ddsp_pytorch_tpu/training/time_sharded.py:66-299.  The frame-rate
control network (the GRU decoder, and the encoder of the autoencoder) runs
data-parallel with its frames whole — a GRU is sequential in time — while
the sample-rate DSP and the multi-scale STFT loss run on the mesh's time
shards (parallel/ops.py):

  * the oscillator's phase sum → the distributed float64 scan;
  * the reverb → the halo'd causal convolution;
  * the loss → halo'd STFT frames and one psum.

Gradients flow through the collectives (parallel/mesh.py), and the step's
loss and gradients equal the unsharded step's (training/train.py
loss_and_grads) on the same noise.

Pad-and-mask (plan_time_padding): a frame count that does not shard is
padded to the smallest one that does; padded frames synthesize silence,
both signals' pad regions are rewritten with the reflection about the true
end and the frames centred past it are masked out of the loss, so the
reference's 192 000-sample, 375-frame chunk (configs/config_timesharded.
yaml) shards at time = 4 as 384 frames with the unsharded step's loss and
gradients.

Noise: torch.Generator is not partitionable the way JAX's threefry is, so
the step draws the whole global (B, F, S) noise with the state's generator
— exactly the unsharded step's draw — and each process slices its rows and
frames (12 MB at the reference size; JAX draws shard-local).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models.decoder import matmul_precision
from ddsp_pytorch_tpu_torch.models.encoder import DDSPAutoencoder
from ddsp_pytorch_tpu_torch.ops.filters import filtered_noise
from ddsp_pytorch_tpu_torch.parallel.mesh import Mesh
from ddsp_pytorch_tpu_torch.parallel.ops import (
    reflect_tail_into_pad,
    sharded_fft_convolve_causal,
    sharded_harmonic_synth,
    sharded_multiscale_spec_loss,
    to_time_shards,
)
from ddsp_pytorch_tpu_torch.parallel.sharding import GradientReducer


@dataclasses.dataclass(frozen=True)
class TimePaddingPlan:
    """Pad-and-mask geometry (time_sharded.py:66-104): the frame count padded
    from `frames` to `frames_pad` so that each shard's chunk is a multiple
    of every STFT hop and longer than n_fft/2; `t_valid` and `t_pad` in
    samples."""

    n_time: int
    frames: int
    frames_pad: int
    t_valid: int
    t_pad: int

    @property
    def pad_frames(self) -> int:
        return self.frames_pad - self.frames

    @property
    def pad_samples(self) -> int:
        return self.t_pad - self.t_valid

    @property
    def chunk(self) -> int:
        return self.t_pad // max(self.n_time, 1)


def plan_time_padding(config: Config, mesh: Mesh) -> TimePaddingPlan:
    """The least frame padding that lets this workload shard over the
    mesh's time axis (time_sharded.py:107-168).  Constraints: the chunk a
    multiple of every hop, n_fft/2 < chunk, and where padding occurs, at
    least max n_fft/2 padded samples with the pad and its reflection
    sources on the last shard.  Raises when that would take more padding
    than the signal itself."""
    n_time = mesh.time
    block = config.preprocess.block_size
    t = config.preprocess.signal_length
    if t % block:
        raise ValueError(f"time sharding: signal_length ({t}) must be a multiple of "
                         f"block_size ({block})")
    frames = t // block
    if n_time <= 1:
        return TimePaddingPlan(1, frames, frames, t, t)
    scales = list(config.train.scales)
    hops = [int(s * (1.0 - config.train.overlap)) for s in scales]
    if any(h <= 0 for h in hops):
        raise ValueError(f"time sharding: non-positive STFT hop in {hops}")
    hop_lcm = math.lcm(*hops) if hops else 1
    f_quantum = hop_lcm // math.gcd(hop_lcm, block)
    max_half = max((s // 2 for s in scales), default=0)
    f_loc = -(-frames // n_time)
    f_loc = -(-f_loc // f_quantum) * f_quantum
    while True:
        chunk = f_loc * block
        frames_pad = f_loc * n_time
        t_pad = frames_pad * block
        pad_samples = t_pad - t
        ok = chunk > max_half
        if pad_samples > 0:
            ok = ok and pad_samples >= max_half and 2 * t - t_pad - 1 >= (n_time - 1) * chunk
        if ok:
            return TimePaddingPlan(n_time, frames, frames_pad, t, t_pad)
        if pad_samples > t:
            raise ValueError(
                f"time sharding: cannot shard signal_length={t} ({frames} frames) over "
                f"time={n_time} with scales={scales}: satisfying chunk % lcm(hops)={hop_lcm} == 0, "
                f"chunk > n_fft/2={max_half}, and a last-shard-local reflected pad would need "
                f"more padding than the signal itself; use fewer time shards or smaller scales"
            )
        f_loc += f_quantum


def validate_time_sharding(config: Config, mesh: Mesh) -> None:
    """Raise, with the reason, when the workload cannot shard over the
    mesh's time axis even padded (time_sharded.py:171-174)."""
    plan_time_padding(config, mesh)


def frame_controls(model, batch):
    """The NN stage: (harmonic controls, noise controls) of a normalized
    batch, through the encoder too for the autoencoder."""
    if isinstance(model, DDSPAutoencoder):
        return model.frame_controls(batch["pitch"], batch["loudness"], batch["mfcc"])
    return model.frame_controls(batch["pitch"], batch["loudness"])


def _pad_frames(x: torch.Tensor, n: int, edge: bool = False) -> torch.Tensor:
    """(B, F, ...) → (B, F + n, ...): zeros, or the last frame repeated."""
    if n == 0:
        return x
    if edge:
        return torch.cat([x, x[:, -1:].expand(x.shape[0], n, *x.shape[2:])], dim=1)
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, n))


def make_time_sharded_loss_and_grads(model, config: Config, mesh: Mesh) -> Callable:
    """fn(state, batch, noise) → (loss, grads in model.named_parameters()
    order): the loss and gradients of make_time_sharded_train_step
    (time_sharded.py:177-299), to be followed by the optimizer update.

    batch: this process's rows (B, T) sig and (B, F, 1) pitch and loudness
    (and (B, F, n_mfcc) mfcc), sig whole in time; noise: the global
    (B · mesh.data_procs, F, S) draw.  Across processes the gradients are
    summed over the ranks (the loss is already the global batch's)."""
    plan = plan_time_padding(config, mesh)
    scales = tuple(config.train.scales)
    overlap = config.train.overlap
    block, sr = int(model.block_size), int(model.sample_rate)
    axis = mesh.time_axis
    reducer = None if mesh.in_process else GradientReducer(mesh, mean=False)

    def fn(state, batch, noise):
        noise = mesh.data_rows(noise)
        model_batch = dict(batch)
        model_batch["loudness"] = (batch["loudness"] - state.mean_loudness) / state.std_loudness
        harmonic_ctrls, noise_ctrls = frame_controls(model, model_batch)
        amp = harmonic_ctrls["harmonic_distribution"] * harmonic_ctrls["amplitudes"]
        f0 = harmonic_ctrls["f0"][..., 0]
        mags = noise_ctrls["magnitudes"]
        # padded frames: zero amplitudes, magnitudes and noise (silence); f0
        # repeats its last frame only to keep the phase scan defined
        pad = plan.pad_frames
        amp, mags, noise = _pad_frames(amp, pad), _pad_frames(mags, pad), _pad_frames(noise, pad)
        f0 = _pad_frames(f0, pad, edge=True)
        s_mags = to_time_shards(mags, axis)
        s_noise = to_time_shards(noise.to(mags.dtype), axis)
        audio = sharded_harmonic_synth(to_time_shards(f0, axis), to_time_shards(amp, axis),
                                       block, sr, axis)
        audio = audio + filtered_noise(s_mags.flatten(0, 1), block,
                                       noise=s_noise.flatten(0, 1)).view_as(audio)
        if model.has_reverb:
            ir = model.reverb_impulse()
            # the reverb truncates its IR to a shorter signal
            # (models/modules.Reverb): at the true length, not the padded one
            audio = sharded_fft_convolve_causal(audio, ir[: plan.t_valid], axis)
        target = to_time_shards(F.pad(batch["sig"], (0, plan.pad_samples)), axis)
        if pad:
            audio = reflect_tail_into_pad(audio, plan.t_valid, axis)
            target = reflect_tail_into_pad(target, plan.t_valid, axis)
        loss = sharded_multiscale_spec_loss(target, audio, scales, overlap, mesh, plan.t_valid)
        with matmul_precision():  # the NN stage's backward, as its forward
            grads = list(torch.autograd.grad(loss, [p for _, p in model.named_parameters()]))
        if reducer is not None:
            grads, _ = reducer(grads)
        return loss.detach(), grads

    fn.plan = plan
    return fn
