"""MFCC encoder and the DDSP autoencoder ("mfcc-autoencoder").

Port of ddsp_pytorch_tpu/models/encoder.py:27-159.  Submodules keep the
flax names (`encoder.LayerNorm_0`, `encoder.GRU_0`, `encoder.Dense_0`,
`decoder.z_mlp`, ...), so a bundle's tree maps onto the state_dict by
renaming leaves only (weights.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ddsp_pytorch_tpu_torch.models.decoder import (
    GRU,
    LAYER_NORM_EPS,
    DDSPDecoder,
    DDSPTraining,
    GRUDecoder,
    controls_marked,
    dense,
    layer_norm,
    matmul_precision,
    signal_marked,
)
from ddsp_pytorch_tpu_torch.models.modules import FilteredNoise, HarmonicSynth, Reverb

N_MFCCS = 30  # encoder.py:23
Z_DIM = 16  # encoder.py:24


class MFCCEncoder(nn.Module):
    """(B, F, n_mfccs) MFCC frames → LayerNorm(ε=1e-6) → GRU → Dense →
    (B, F, z_dim) latent (encoder.py:27-57), each in `compute_dtype` as
    the decoder's modules are (models/decoder.py)."""

    def __init__(self, hidden_size: int, n_mfccs: int = N_MFCCS, z_dim: int = Z_DIM,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.LayerNorm_0 = nn.LayerNorm(n_mfccs, eps=LAYER_NORM_EPS)
        self.GRU_0 = GRU(n_mfccs, hidden_size, compute_dtype)
        self.Dense_0 = nn.Linear(hidden_size, z_dim)

    def forward(self, mfccs: torch.Tensor, gru_state: Optional[torch.Tensor] = None):
        """→ (z (B, F, z_dim), encoder GRU state (B, H))."""
        dt = self.compute_dtype
        x, state = self.GRU_0(layer_norm(self.LayerNorm_0, mfccs, dt), gru_state)
        return dense(self.Dense_0, x, dt), state


class DDSPAutoencoder(DDSPTraining, nn.Module):
    """The "mfcc-autoencoder" model (encoder.py:60-159): the decoder model
    with the MFCC encoder's z fed to the GRU decoder through a z MLP.  The
    controls and the synths are DDSPDecoder's."""

    dtype = DDSPDecoder.dtype
    _controls = DDSPDecoder._controls
    sample_noise = DDSPDecoder.sample_noise
    reverb_impulse = DDSPDecoder.reverb_impulse

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
        self.n_mfccs = N_MFCCS
        self.compute_dtype = compute_dtype
        self.encoder = MFCCEncoder(self.hidden_size, compute_dtype=compute_dtype)
        self.decoder = GRUDecoder(self.hidden_size, z_dim=Z_DIM, compute_dtype=compute_dtype)
        self.harmonic_proj = nn.Linear(self.hidden_size, self.n_harmonic + 1)
        self.noise_proj = nn.Linear(self.hidden_size, self.n_bands)
        self.harmonic_synth = HarmonicSynth(self.block_size, self.sample_rate)
        self.noise_synth = FilteredNoise(self.block_size, self.n_bands)
        if self.has_reverb:
            self.reverb = Reverb(self.sample_rate, self.sample_rate)

    def frame_controls(self, f0: torch.Tensor, loudness: torch.Tensor, mfcc: torch.Tensor):
        """Encoder + decoder + projections, no synthesis (encoder.py:98-107):
        → (harmonic controls, noise controls)."""
        f0 = f0.to(self.dtype)
        with matmul_precision():
            z, _ = self.encoder(mfcc)
            hidden, _ = self.decoder(f0, loudness, z=z)
            return self._controls(hidden, f0)

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """batch {'pitch', 'loudness' (B, F, 1), 'mfcc' (B, F, n_mfccs)} →
        DDSPDecoder.forward's dict plus 'z' (encoder.py:109-132).  noise
        (B, F, S) is injected, or drawn from `generator`."""
        f0, loudness, mfcc = batch["pitch"].to(self.dtype), batch["loudness"], batch["mfcc"]
        with matmul_precision():
            z, _ = self.encoder(mfcc)
            hidden, _ = self.decoder(f0, loudness, z=z)
            harmonic_ctrls, noise_ctrls = self._controls(hidden, f0)
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
            "z": z,
        }

    def streaming_step(
        self,
        f0: torch.Tensor,
        loudness: torch.Tensor,
        mfcc: torch.Tensor,
        enc_gru_state: torch.Tensor,
        gru_state: torch.Tensor,
        phase: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """One streaming block (encoder.py:134-159): frame-rate controls
        (B, F, 1), MFCC frames (B, F, n_mfccs) and the encoder GRU, decoder
        GRU and phase carries → (audio (B, F·S), new encoder carry, new
        decoder carry, new phase).  No reverb (StreamingSynth applies it
        in-stream when asked)."""
        f0 = f0.to(self.dtype)
        with matmul_precision():
            z, new_enc_state = self.encoder(mfcc, enc_gru_state)
            hidden, new_gru_state = self.decoder(f0, loudness, gru_state, z=z)
            harmonic_ctrls, noise_ctrls = self._controls(hidden, f0)
        harmonic, new_phase = self.harmonic_synth(**harmonic_ctrls, phase0=phase, return_phase=True)
        noise_audio = self.noise_synth(**noise_ctrls, noise=noise, generator=generator)
        return harmonic + noise_audio, new_enc_state, new_gru_state, new_phase
