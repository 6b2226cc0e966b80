"""Long-form synthesis over a ('data', 'time') mesh.

Port of ddsp_pytorch_tpu/parallel/longform.py:32-188: many voices × minutes
of audio through a trained model.  The control network (the GRU decoder,
and the encoder of the autoencoder) runs data-parallel, its frames whole (a
GRU is sequential in time); the sample-rate DSP — the oscillator bank, the
filtered noise and the reverb — runs on the mesh's time shards
(parallel/ops.py), so across processes each rank holds only its span of
the audio.
"""

from __future__ import annotations

from typing import Optional

import torch

from ddsp_pytorch_tpu_torch.models.encoder import DDSPAutoencoder
from ddsp_pytorch_tpu_torch.ops import filtered_noise, uniform_noise
from ddsp_pytorch_tpu_torch.parallel.mesh import Mesh
from ddsp_pytorch_tpu_torch.parallel.ops import (
    from_time_shards,
    sharded_fft_convolve_causal,
    sharded_harmonic_synth,
    to_time_shards,
)


class LongFormSynthesizer:
    """Render frame-rate controls into time-sharded audio through a model
    (DDSPDecoder or DDSPAutoencoder, weights loaded, on its device)."""

    def __init__(self, model, mesh: Mesh, *, include_reverb: bool = True,
                 mean_loudness: float = 0.0, std_loudness: float = 1.0):
        self.model = model
        self.mesh = mesh
        self.block_size = int(model.block_size)
        self.sample_rate = int(model.sample_rate)
        self.include_reverb = include_reverb and model.has_reverb
        self.mean_loudness = mean_loudness
        self.std_loudness = std_loudness
        self._autoencoder = isinstance(model, DDSPAutoencoder)

    @torch.no_grad()
    def synthesize(self, f0: torch.Tensor, loudness: torch.Tensor,
                   mfcc: Optional[torch.Tensor] = None, *, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f0, loudness (B, F, 1) of every voice (and mfcc (B, F, n_mfcc) for
        an autoencoder), F a multiple of the mesh's time axis → this
        process's audio (B_local, s·F/n·block): its voices' span of the
        time shards it holds — on an in-process mesh every voice's whole
        (B, F·block) signal.

        The noise is `noise` (B, F, block), if given, cut to this process's
        shards; else it is drawn from `generator` (on the model's device)
        for this process's voices and shards.  On an in-process mesh that
        draw equals the unsharded model's; across processes each rank draws
        its own slice, so the noise depends on the layout (torch.Generator
        cannot be split the way JAX's threefry is)."""
        mesh, axis = self.mesh, self.mesh.time_axis
        if self._autoencoder and mfcc is None:
            raise ValueError("mfcc-autoencoder long-form: pass mfcc")
        f0, loudness = mesh.data_rows(f0), mesh.data_rows(loudness)
        loudness = (loudness - self.mean_loudness) / self.std_loudness
        if self._autoencoder:
            harmonic_ctrls, noise_ctrls = self.model.frame_controls(f0, loudness, mesh.data_rows(mfcc))
        else:
            harmonic_ctrls, noise_ctrls = self.model.frame_controls(f0, loudness)
        amp = harmonic_ctrls["harmonic_distribution"] * harmonic_ctrls["amplitudes"]
        mags = to_time_shards(noise_ctrls["magnitudes"], axis)
        if noise is not None:
            noise = to_time_shards(mesh.data_rows(noise), axis)
        else:
            b, f = f0.shape[:2]
            local = uniform_noise((b, f // axis.n * axis.count, self.block_size), generator,
                                  mags.dtype, mags.device)
            noise = local.unflatten(1, (axis.count, f // axis.n)).movedim(1, 0)
        audio = sharded_harmonic_synth(to_time_shards(harmonic_ctrls["f0"][..., 0], axis),
                                       to_time_shards(amp, axis), self.block_size,
                                       self.sample_rate, axis)
        audio = audio + filtered_noise(mags.flatten(0, 1), self.block_size,
                                       noise=noise.to(mags.dtype).flatten(0, 1)).view_as(audio)
        if self.include_reverb:
            audio = sharded_fft_convolve_causal(audio, self.model.reverb_impulse(), axis)
        return from_time_shards(audio)
