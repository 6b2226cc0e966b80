"""GRU control decoder + the single-instrument DDSP decoder model.

Port of ddsp_pytorch_tpu/models/decoder.py:32-277.  Submodules keep the
flax names (`Dense_0`, `LayerNorm_0`, `f0_mlp`, `gru`, ...) so a bundle's
parameter tree maps onto the state_dict by renaming leaves only
(weights.py).  The GRU is written as matmuls plus gates, like the JAX one
(`:86-94`), rather than nn.GRU: the same arithmetic, and no cuDNN path
whose TF32 default would change the numbers on the GPU.

The NN may compute in bfloat16 (`compute_dtype`, the JAX models' `dtype`;
decoder.py:15-16) while the parameters stay float32, as flax's
`param_dtype` keeps them.  The rounding points are those of the compiled
JAX model, which the CPU tests hold bit for bit:
  * each Dense casts its input, kernel and bias to bf16 and adds the bias
    to the rounded product (flax's `nn.Dense(dtype=bf16)`); where only a
    cast to float32 reads the sum (LayerNorm, the controls) XLA keeps it
    unrounded, and so does `dense(upcast=True)`;
  * LayerNorm takes its statistics in float32 (E[x²] − E[x]², clamped at
    0) and returns bf16 (flax 0.12's `_compute_stats`/`_normalize`);
  * the leaky ReLU's slope is rounded to bf16, as JAX's weakly typed 0.01;
  * the GRU's projections, carry and gates are bf16, the carry rounded
    every frame, σ as XLA expands it, 1 / (1 + exp(−x)) rounded at each
    operation (`_Logistic`);
  * the projections' outputs are cast back to the parameters' type before
    the synths, and everything after them (oscillator, noise, reverb,
    loss) is as in float32.
The gradients reach the float32 parameters through the casts.  Without a
compute dtype the modules compute in their parameters' type (float32, or
float64 after `.double()`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddsp_pytorch_tpu_torch import ops
from ddsp_pytorch_tpu_torch.models.modules import FilteredNoise, HarmonicSynth, Reverb
from ddsp_pytorch_tpu_torch.ops import gru

N_LAYERS = 3
LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default; F.layer_norm's is 1e-5
LEAKY_RELU_SLOPE = 0.01  # flax.linen.leaky_relu's default


@contextlib.contextmanager
def matmul_precision():
    """The scope the models' products run in, forward and backward: cuBLAS
    reduces bf16 GEMMs in float32, as XLA does, whatever
    `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`
    says outside it (its default lets split-K reduce in bf16)."""
    matmul = torch.backends.cuda.matmul
    previous = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = previous


def controls_marked(harmonic_ctrls: Dict[str, torch.Tensor], noise_ctrls: Dict[str, torch.Tensor]) -> None:
    """Step marks 1 (the NN's controls ready) and 5 (their gradients ready)
    inside a MultiStep's step (training/profiling.py); nothing elsewhere."""
    from ddsp_pytorch_tpu_torch.training import profiling  # here: training imports the models

    profiling.mark(1)
    profiling.mark_on_grad(5, harmonic_ctrls["harmonic_distribution"], harmonic_ctrls["amplitudes"],
                           noise_ctrls["magnitudes"])


def signal_marked(signal: torch.Tensor) -> None:
    """Step marks 2 (the signal ready, after the reverb) and 4 (its
    gradient ready) inside a MultiStep's step; nothing elsewhere."""
    from ddsp_pytorch_tpu_torch.training import profiling

    profiling.mark(2)
    profiling.mark_on_grad(4, signal)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype],
          upcast: bool = False) -> torch.Tensor:
    """flax's nn.Dense(dtype=dtype) with the layer's parameters: input,
    kernel and bias cast to `dtype`, the bias added after the product.

    `upcast`: the caller casts the result up at once (LayerNorm's float32
    statistics, the controls' cast).  Compiled, the JAX model then keeps
    that sum unrounded (XLA drops a bf16 rounding that only a cast to
    float32 reads), so the bias is added in float32 to the bf16 product."""
    if dtype is None:
        return layer(x)
    y = x.to(dtype) @ layer.weight.to(dtype).T
    if upcast:
        return y.float() + layer.bias.to(dtype).float()
    return y + layer.bias.to(dtype)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax's nn.LayerNorm(dtype=dtype) over the last axis: statistics in
    at least float32 with the fast variance E[x²] − E[x]² clamped at 0,
    (x − mean) · (rsqrt(var + ε) · scale) + bias in that type, the result
    cast to `dtype`."""
    if dtype is None:
        return layer(x)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + layer.eps) * layer.weight
    return ((x - mean) * mul + layer.bias).to(dtype)


class _Logistic(torch.autograd.Function):
    """σ(x) as XLA computes a bf16 `lax.logistic`: 1 / (1 + exp(−x)), each
    operation rounded to x's type; the backward is JAX's rule for it,
    g · (σ · (1 − σ)), in that type."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(torch.exp(-x) + 1.0)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * (y * (1.0 - y))


class MLP(nn.Module):
    """n_layers × [Dense → LayerNorm(ε=1e-6) → LeakyReLU] (decoder.py:32-45).
    With a compute dtype the leaky ReLU's slope is rounded to it, as JAX's
    weakly typed 0.01 is."""

    def __init__(self, in_size: int, hidden_size: int, n_layers: int = N_LAYERS,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers = n_layers
        self.compute_dtype = compute_dtype
        self.slope = LEAKY_RELU_SLOPE
        if compute_dtype is not None:
            self.slope = float(torch.tensor(LEAKY_RELU_SLOPE, dtype=compute_dtype))
        for i in range(n_layers):
            self.add_module(f"Dense_{i}", nn.Linear(in_size if i == 0 else hidden_size, hidden_size))
            self.add_module(f"LayerNorm_{i}", nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        for i in range(self.n_layers):
            x = dense(getattr(self, f"Dense_{i}"), x, dt, upcast=True)
            x = layer_norm(getattr(self, f"LayerNorm_{i}"), x, dt)
            x = F.leaky_relu(x, self.slope)
        return x


class GRU(nn.Module):
    """Single-layer GRU over (B, F, in), gate order [r, z, n] (decoder.py:48-98):

      r = σ(x·W_r + b_ir + h·U_r + b_hr)
      z = σ(x·W_z + b_iz + h·U_z + b_hz)
      n = tanh(x·W_n + b_in + r ⊙ (h·U_n + b_hn))
      h' = (1 − z) ⊙ n + z ⊙ h

    The input projection of all frames is one matmul before the loop, split
    into frames once (`unbind`), so the backward stacks the F frame
    gradients into one tensor; slicing `x_proj[:, t]` inside the loop would
    give each frame a zero-filled gradient of the whole (B, F, 3H) tensor
    and sum F of them, O(F²) work.  The JAX GRU scans over the same split
    (decoder.py:97).  With a compute dtype the projections, the carry
    (the initial state cast to it, as `h0.astype(dt)`) and every gate are
    in that type (decoder.py:72-94), σ as XLA expands it (`_Logistic`).

    Without a compute dtype the recurrence after the input projection is
    `ops.gru.gru_recurrence`, which chooses between the hand-written
    kernels (float32 on a CUDA card, H ≤ 512 and the batch not too wide
    for its frames: one launch for all frames forward, one backward) and
    the float loop `ops.gru.gru_fwd_plain` (the CPU, float64, a larger H,
    a wide batch of few frames).  The loop below is the bf16 compute
    dtype's, whose rounding points are its own."""

    def __init__(self, input_size: int, hidden_size: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.compute_dtype = compute_dtype
        self.weight_ih = nn.Parameter(torch.zeros(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.zeros(3 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
        self.bias_hh = nn.Parameter(torch.zeros(3 * hidden_size))

    def forward(self, x: torch.Tensor, initial_state: Optional[torch.Tensor] = None):
        """x (B, F, in) → (outputs (B, F, H), final_state (B, H))."""
        w_ih, w_hh, b_ih, b_hh = self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh
        dt = self.compute_dtype
        if dt is None:
            return gru.gru_recurrence(x @ w_ih.T + b_ih, w_hh, b_hh, initial_state)
        # cast inside the call: a captured step reads the updated parameters
        x, w_ih, w_hh, b_ih, b_hh = (t.to(dt) for t in (x, w_ih, w_hh, b_ih, b_hh))
        x_proj = x @ w_ih.T + b_ih
        if initial_state is None:
            h = torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype, device=x.device)
        else:
            h = initial_state.to(x.dtype)
        w_hh_t = w_hh.T
        outputs = []
        rz_n = (2 * self.hidden_size, self.hidden_size)
        for x_t in x_proj.unbind(1):
            h_proj = h @ w_hh_t + b_hh
            # both gates in one call of XLA's logistic
            (xrz, xn), (hrz, hn) = x_t.split(rz_n, dim=-1), h_proj.split(rz_n, dim=-1)
            r, z = _Logistic.apply(xrz + hrz).chunk(2, dim=-1)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            outputs.append(h)
        return torch.stack(outputs, dim=1), h


class GRUDecoder(nn.Module):
    """f0 and loudness MLPs (and a z MLP when z_dim is set) → GRU →
    skip-concat of raw f0/loudness → output MLP (decoder.py:101-143).  The
    skip inputs take the GRU output's type (bf16 rounds f0 near 440 Hz to
    2 Hz steps, as the JAX decoder does, `:137`)."""

    def __init__(self, hidden_size: int, z_dim: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.z_dim = z_dim
        self.f0_mlp = MLP(1, hidden_size, compute_dtype=compute_dtype)
        self.loudness_mlp = MLP(1, hidden_size, compute_dtype=compute_dtype)
        if z_dim is not None:
            self.z_mlp = MLP(z_dim, hidden_size, compute_dtype=compute_dtype)
        n_parts = 2 if z_dim is None else 3
        self.gru = GRU(n_parts * hidden_size, hidden_size, compute_dtype)
        self.out_mlp = MLP(hidden_size + 2, hidden_size, compute_dtype=compute_dtype)

    def forward(
        self,
        f0: torch.Tensor,
        loudness: torch.Tensor,
        gru_state: Optional[torch.Tensor] = None,
        z: Optional[torch.Tensor] = None,
    ):
        """f0, loudness (B, F, 1) [and z (B, F, z_dim)] → (hidden (B, F, H),
        GRU state (B, H))."""
        parts = [self.f0_mlp(f0), self.loudness_mlp(loudness)]
        if self.z_dim is not None:
            if z is None:
                raise ValueError("z_dim is set but no z was given")
            parts.append(self.z_mlp(z))
        hidden = torch.cat(parts, dim=-1)
        gru_out, state = self.gru(hidden, gru_state)
        hidden = torch.cat([gru_out, f0.to(gru_out.dtype), loudness.to(gru_out.dtype)], dim=-1)
        return self.out_mlp(hidden), state


class DDSPTraining:
    """What training/train.py's Trainer and MultiStep ask of a model, as
    DDSP's two models answer it (models/rave.py answers for RAVE v1): the
    feature cache as data, the step marks' `PHASES`, flax's initializers,
    each step's (B, F, block) uniform noise drawn from the state's
    generator, and training/train.py's `loss_and_grads` and eval outputs."""

    needs_features = True  # batches carry pitch and loudness (and mfcc)

    @property
    def phases(self):
        from ddsp_pytorch_tpu_torch.training import profiling  # here: training imports the models

        return profiling.PHASES

    def init_weights(self, generator: torch.Generator):
        return init_params(self, generator)

    def draw_shape(self, rows: int, data) -> tuple:
        """The noise's shape for `rows` items of `data` (a batch, or a stack
        or cache of them: only its frame axis is read)."""
        return (rows, data["pitch"].shape[-2], self.block_size)

    def draw(self, shape, generator: torch.Generator) -> torch.Tensor:
        return ops.uniform_noise(shape, generator, self.dtype, generator.device)

    def loss_and_grads(self, state, batch, noise, scales, overlap):
        from ddsp_pytorch_tpu_torch.training import train  # here: training imports the models

        return train.loss_and_grads(self, batch, state.mean_loudness, state.std_loudness, scales, overlap,
                                    noise=noise)

    def eval_outputs(self, state, batch, scales, overlap, noise=None, generator=None) -> dict:
        """The outputs plus the loss, both multiscale spectrograms
        (`sig_stft`, `rec_stft`), `sig` and the reconstruction `rec`
        (train.py:198-217)."""
        from ddsp_pytorch_tpu_torch.training.loss import spectral_loss_from_signals

        model_batch = dict(batch, loudness=(batch["loudness"] - state.mean_loudness) / state.std_loudness)
        out = self(model_batch, noise=noise, generator=generator)
        loss, ori, rec = spectral_loss_from_signals(batch["sig"], out["signal"], scales, overlap)
        out.update({"loss": loss, "sig_stft": ori, "rec_stft": rec, "sig": batch["sig"], "rec": out["signal"]})
        return out


class DDSPDecoder(DDSPTraining, nn.Module):
    """The "single-inst-decoder" model (decoder.py:182-277).  `compute_dtype`
    (None or torch.bfloat16) is the NN's type; the parameters, the synths
    and the outputs keep the parameters' type (`dtype`)."""

    def __init__(
        self,
        hidden_size: int,
        n_harmonic: int,
        n_bands: int,
        sample_rate: int,
        block_size: int,
        has_reverb: bool,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.n_harmonic = int(n_harmonic)
        self.n_bands = int(n_bands)
        self.sample_rate = int(sample_rate)
        self.block_size = int(block_size)
        self.has_reverb = bool(has_reverb)
        self.compute_dtype = compute_dtype
        self.decoder = GRUDecoder(self.hidden_size, compute_dtype=compute_dtype)
        # column 0 of harmonic_proj = global amplitude, rest = distribution
        self.harmonic_proj = nn.Linear(self.hidden_size, self.n_harmonic + 1)
        self.noise_proj = nn.Linear(self.hidden_size, self.n_bands)
        self.harmonic_synth = HarmonicSynth(self.block_size, self.sample_rate)
        self.noise_synth = FilteredNoise(self.block_size, self.n_bands)
        if self.has_reverb:
            self.reverb = Reverb(self.sample_rate, self.sample_rate)

    @property
    def dtype(self) -> torch.dtype:
        """float32, or float64 after `.double()` (the CPU reference of a
        float32 run); f0 enters the synths in this type."""
        return self.harmonic_proj.weight.dtype

    def _controls(self, hidden: torch.Tensor, f0: torch.Tensor):
        """Decoder hidden state → (harmonic controls, noise controls)
        (decoder.py:156-168); the projections in the compute dtype, cast
        back to the parameters' type before the synths."""
        dt = self.compute_dtype
        param = dense(self.harmonic_proj, hidden, dt, upcast=True).to(self.dtype)
        harmonic_ctrls = self.harmonic_synth.get_controls(
            param[..., :1], param[..., 1:], f0
        )
        magnitudes = dense(self.noise_proj, hidden, dt, upcast=True).to(self.dtype)
        noise_ctrls = self.noise_synth.get_controls(magnitudes)
        return harmonic_ctrls, noise_ctrls

    def frame_controls(self, f0: torch.Tensor, loudness: torch.Tensor):
        """Decoder + projections, no synthesis (decoder.py:214-223): f0,
        loudness (B, F, 1) → (harmonic controls, noise controls).  The NN
        stage of the time-sharded step and of long-form synthesis."""
        f0 = f0.to(self.dtype)
        with matmul_precision():
            hidden, _ = self.decoder(f0, loudness)
            return self._controls(hidden, f0)

    def sample_noise(self, f0: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, F, block_size) uniform noise in [-1, 1): the draw `forward`
        makes from `generator` when no noise is injected (decoder.py:168-172)."""
        return ops.uniform_noise((f0.shape[0], f0.shape[1], self.block_size), generator,
                                 self.dtype, f0.device)

    def reverb_impulse(self) -> torch.Tensor:
        """(sample_rate,) reverb impulse response (decoder.py:174-179); the
        time-sharded step convolves with it shard by shard."""
        return self.reverb.build_impulse()

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Offline forward (decoder.py:225-249): batch {'pitch', 'loudness'}
        (B, F, 1) → dict with f0, loudness, signal, noise, harmonic_audio,
        noise_ctrls, harmonic_ctrls.  noise (B, F, S) is injected, or drawn
        from `generator`."""
        f0, loudness = batch["pitch"].to(self.dtype), batch["loudness"]
        harmonic_ctrls, noise_ctrls = self.frame_controls(f0, loudness)
        controls_marked(harmonic_ctrls, noise_ctrls)
        harmonic = self.harmonic_synth(**harmonic_ctrls)
        noise_audio = self.noise_synth(**noise_ctrls, noise=noise, generator=generator)
        signal = harmonic + noise_audio
        if self.has_reverb:
            signal = self.reverb(signal)
        signal_marked(signal)
        return {
            "f0": f0,
            "loudness": loudness,
            "signal": signal,
            "noise": noise_audio,
            "harmonic_audio": harmonic,
            "noise_ctrls": noise_ctrls,
            "harmonic_ctrls": harmonic_ctrls,
        }

    def streaming_step(
        self,
        f0: torch.Tensor,
        loudness: torch.Tensor,
        gru_state: torch.Tensor,
        phase: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """One streaming block (decoder.py:251-277): frame-rate controls
        (B, F, 1), GRU carry (B, H) and phase carry (B,) → (audio (B, F·S),
        new GRU carry, new phase).  No reverb (applied externally in the
        realtime contract)."""
        f0 = f0.to(self.dtype)
        with matmul_precision():
            hidden, new_gru_state = self.decoder(f0, loudness, gru_state)
            harmonic_ctrls, noise_ctrls = self._controls(hidden, f0)
        harmonic, new_phase = self.harmonic_synth(
            **harmonic_ctrls, phase0=phase, return_phase=True
        )
        noise_audio = self.noise_synth(**noise_ctrls, noise=noise, generator=generator)
        return harmonic + noise_audio, new_gru_state, new_phase


# flax's truncated normal draws from N(0, 1) cut at ±2, whose std is
# 0.8796…; variance_scaling divides the target std by it
_TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw fresh weights with flax's initializers, in distribution (the
    bits of jax.random cannot be reproduced): what `model.init` gives the
    JAX model (models/decoder.py:32-98, models/modules.py:157-167).

      Dense      kernel lecun_normal (truncated normal, std 1/√fan_in,
                 cut at ±2σ), bias zeros
      LayerNorm  scale ones, bias zeros
      GRU        w_ih glorot_uniform, w_hh orthogonal over the flax (H, 3H)
                 layout, biases zeros
      Reverb     noise U(−1, 1), decay its initial_decay (5), wet its
                 initial_wet (0)

    `generator` must live on the parameters' device.  Returns the model.
    """
    for module in model.modules():
        if isinstance(module, nn.Linear):
            std = (1.0 / module.in_features) ** 0.5 / _TRUNC_NORMAL_STD
            nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, GRU):
            # weight_ih (3H, in) has flax's fans: fan_in = in, fan_out = 3H
            nn.init.xavier_uniform_(module.weight_ih, generator=generator)
            # weight_hh (3H, H) is flax's w_hh (H, 3H) transposed: orthonormal
            # rows there are orthonormal columns here
            nn.init.orthogonal_(module.weight_hh, generator=generator)
            nn.init.zeros_(module.bias_ih)
            nn.init.zeros_(module.bias_hh)
        elif isinstance(module, Reverb):
            module.noise.copy_(
                torch.rand(module.noise.shape, generator=generator, device=module.noise.device) * 2.0 - 1.0
            )
            module.decay.fill_(module.initial_decay)
            module.wet.fill_(module.initial_wet)
    return model
