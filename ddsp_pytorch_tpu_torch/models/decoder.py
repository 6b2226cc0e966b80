"""GRU control decoder + the single-instrument DDSP decoder model.

Port of ddsp_pytorch_tpu/models/decoder.py:32-277.  Submodules keep the
flax names (`Dense_0`, `LayerNorm_0`, `f0_mlp`, `gru`, ...) so a bundle's
parameter tree maps onto the state_dict by renaming leaves only
(weights.py).  The GRU is written as matmuls plus gates, like the JAX one
(`:86-94`), rather than nn.GRU: the same arithmetic, and no cuDNN path
whose TF32 default would change the numbers on the GPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddsp_pytorch_tpu_torch.models.modules import FilteredNoise, HarmonicSynth, Reverb

N_LAYERS = 3
LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default; F.layer_norm's is 1e-5
LEAKY_RELU_SLOPE = 0.01  # flax.linen.leaky_relu's default


class MLP(nn.Module):
    """n_layers × [Dense → LayerNorm(ε=1e-6) → LeakyReLU] (decoder.py:32-45)."""

    def __init__(self, in_size: int, hidden_size: int, n_layers: int = N_LAYERS):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"Dense_{i}", nn.Linear(in_size if i == 0 else hidden_size, hidden_size))
            self.add_module(f"LayerNorm_{i}", nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = getattr(self, f"LayerNorm_{i}")(x)
            x = F.leaky_relu(x, LEAKY_RELU_SLOPE)
        return x


class GRU(nn.Module):
    """Single-layer GRU over (B, F, in), gate order [r, z, n] (decoder.py:48-98):

      r = σ(x·W_r + b_ir + h·U_r + b_hr)
      z = σ(x·W_z + b_iz + h·U_z + b_hz)
      n = tanh(x·W_n + b_in + r ⊙ (h·U_n + b_hn))
      h' = (1 − z) ⊙ n + z ⊙ h

    The input projection of all frames is one matmul before the loop."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.zeros(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.zeros(3 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
        self.bias_hh = nn.Parameter(torch.zeros(3 * hidden_size))

    def forward(self, x: torch.Tensor, initial_state: Optional[torch.Tensor] = None):
        """x (B, F, in) → (outputs (B, F, H), final_state (B, H))."""
        b, n_frames = x.shape[0], x.shape[1]
        x_proj = x @ self.weight_ih.T + self.bias_ih
        if initial_state is None:
            h = torch.zeros((b, self.hidden_size), dtype=x.dtype, device=x.device)
        else:
            h = initial_state
        w_hh_t = self.weight_hh.T
        outputs = []
        for t in range(n_frames):
            h_proj = h @ w_hh_t + self.bias_hh
            xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
            hr, hz, hn = h_proj.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            outputs.append(h)
        return torch.stack(outputs, dim=1), h


class GRUDecoder(nn.Module):
    """f0 and loudness MLPs → GRU → skip-concat of raw f0/loudness → output
    MLP (decoder.py:101-143)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.f0_mlp = MLP(1, hidden_size)
        self.loudness_mlp = MLP(1, hidden_size)
        self.gru = GRU(2 * hidden_size, hidden_size)
        self.out_mlp = MLP(hidden_size + 2, hidden_size)

    def forward(
        self,
        f0: torch.Tensor,
        loudness: torch.Tensor,
        gru_state: Optional[torch.Tensor] = None,
    ):
        """f0, loudness (B, F, 1) → (hidden (B, F, H), GRU state (B, H))."""
        hidden = torch.cat([self.f0_mlp(f0), self.loudness_mlp(loudness)], dim=-1)
        gru_out, state = self.gru(hidden, gru_state)
        hidden = torch.cat([gru_out, f0, loudness], dim=-1)
        return self.out_mlp(hidden), state


class DDSPDecoder(nn.Module):
    """The "single-inst-decoder" model (decoder.py:182-277)."""

    def __init__(
        self,
        hidden_size: int,
        n_harmonic: int,
        n_bands: int,
        sample_rate: int,
        block_size: int,
        has_reverb: bool,
    ):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.n_harmonic = int(n_harmonic)
        self.n_bands = int(n_bands)
        self.sample_rate = int(sample_rate)
        self.block_size = int(block_size)
        self.has_reverb = bool(has_reverb)
        self.decoder = GRUDecoder(self.hidden_size)
        # column 0 of harmonic_proj = global amplitude, rest = distribution
        self.harmonic_proj = nn.Linear(self.hidden_size, self.n_harmonic + 1)
        self.noise_proj = nn.Linear(self.hidden_size, self.n_bands)
        self.harmonic_synth = HarmonicSynth(self.block_size, self.sample_rate)
        self.noise_synth = FilteredNoise(self.block_size, self.n_bands)
        if self.has_reverb:
            self.reverb = Reverb(self.sample_rate, self.sample_rate)

    def _controls(self, hidden: torch.Tensor, f0: torch.Tensor):
        """Decoder hidden state → (harmonic controls, noise controls)
        (decoder.py:156-168)."""
        param = self.harmonic_proj(hidden)
        harmonic_ctrls = self.harmonic_synth.get_controls(
            param[..., :1], param[..., 1:], f0
        )
        noise_ctrls = self.noise_synth.get_controls(self.noise_proj(hidden))
        return harmonic_ctrls, noise_ctrls

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
        f0, loudness = batch["pitch"].float(), batch["loudness"]
        hidden, _ = self.decoder(f0, loudness)
        harmonic_ctrls, noise_ctrls = self._controls(hidden, f0)
        harmonic = self.harmonic_synth(**harmonic_ctrls)
        noise_audio = self.noise_synth(**noise_ctrls, noise=noise, generator=generator)
        signal = harmonic + noise_audio
        if self.has_reverb:
            signal = self.reverb(signal)
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
        f0 = f0.float()
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
