"""RAVE v1, the Realtime Audio Variational autoEncoder (Caillon & Esling,
arXiv:2111.05011; acids-ircam/RAVE v1, rave/model.py, rave/core.py, the
defaults of train_rave.py): a 16-band PQMF (ops/pqmf.py), a convolutional
encoder to a 128-channel Gaussian latent at 1/128 of the band rate, and a
weight-normalised generator back to the bands.

All convolutions are 1-D, zero-padded centred (RAVE's `get_padding`, mode
`centered`), with bias; LReLU is LeakyReLU(0.2).  M bands, capacity C,
ratios r:

  encoder    Conv(M → C, 7); for each rᵢ: BatchNorm → LReLU → Conv(C·2ⁱ →
             C·2ⁱ⁺¹, 2rᵢ+1, stride rᵢ); LReLU → Conv(→ 2·latent, 5, groups
             2) → [μ; s].  No weight norm; BatchNorm at PyTorch's defaults
             (ε 1e-5, momentum 0.1), in train mode while training
  latent     σ = softplus(s) + 1e-4, z = μ + σ·ε, KL = mean over (b, t) of
             Σ_c (μ² + σ² − log σ² − 1)
  generator  every convolution but the noise branch's weight-normalised,
             w = g·v/‖v‖ over each slice of the weight's first axis;
             Conv(latent → C·2ⁿ, 7); for each rᵢ: LReLU → ConvTranspose(c →
             c/2, 2rᵢ, stride rᵢ, pad rᵢ/2), then three residuals h + Conv(3)
             (LReLU(Conv(3, dilation d)(LReLU(h)))) for d in 1, 3, 9;
             wave = Conv(C → M, 7), loud = Conv(C → 1, 2·stride+1, stride);
             Y = tanh(wave)·mod_sigmoid(loud)
  noise      Conv(3, stride r) → LReLU → … → Conv(→ M·bands, 3, stride r),
             amp = mod_sigmoid(· − 5) → (B, frames, M, bands), filtered
             uniform noise in [−1, 1) (ops/filters.py) added to Y where
             `add_noise`

Phase 1 (RAVE's warm-up, `warmed_up = False`) runs the generator without
the noise branch: no loss reads it, so its leaves' gradients are zero and
Adam leaves them, and their zero moments, as they were.  `RAVE` answers
what training/train.py's Trainer and MultiStep ask of a model (as
models/decoder.py `DDSPTraining` does for DDSP): raw crops as data,
`RAVE_PHASES`, PyTorch's initialisation, each step's draw ε, the phase-1
`loss_and_grads` and the eval outputs.  `kl_beta`, `optimizer_betas` and the loudness
term's STFT (`loudness_n_fft`, `loudness_hop`) are the recipe's
(train_rave.py's MIN_KL = MAX_KL, Adam's betas, rave/core.py's Loudness),
kept on the model so that a config's `model.kwargs` carries them
(config.py's sections are the JAX package's, field for field).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddsp_pytorch_tpu_torch.ops.filters import amp_to_impulse_response, fft_convolve, uniform_noise
from ddsp_pytorch_tpu_torch.ops.pqmf import PQMF

SLOPE = 0.2  # LeakyReLU's
SIGMA_FLOOR = 1e-4
# mod_sigmoid's exponent: RAVE's 2.3 (ops/core.py scale_function, DDSP's
# version of the same squashing, takes log 10 ≈ 2.303 instead)
MOD_SIGMOID_EXPONENT = 2.3
NOISE_OFFSET = 5.0


def mod_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """RAVE's 2·sigmoid(x)^2.3 + 1e-7."""
    return 2.0 * torch.sigmoid(x) ** MOD_SIGMOID_EXPONENT + 1e-7


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


class WNConv1d(nn.Module):
    """A weight-normalised Conv1d: weight = g·v/‖v‖, the norm over each
    slice of the weight's first axis (torch's `weight_norm` at dim 0),
    zero-padded centred."""

    transposed = False

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, dilation: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        shape = (c_in, c_out, k) if self.transposed else (c_out, c_in, k)
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.empty(shape[0], 1, 1))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.stride, self.dilation = stride, dilation
        self.padding = (k - 1) * dilation // 2 if padding is None else padding

    def weight(self) -> torch.Tensor:
        return self.weight_v * (self.weight_g / torch.linalg.vector_norm(self.weight_v, dim=(1, 2), keepdim=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight(), self.bias, self.stride, self.padding, self.dilation)


class WNConvTranspose1d(WNConv1d):
    """RAVE's upsampling convolution, weight-normalised: ConvTranspose1d of
    kernel 2r, stride r, pad r/2; weight (c_in, c_out, 2r), so the norm is
    over each input channel's slice."""

    transposed = True

    def __init__(self, c_in: int, c_out: int, ratio: int):
        super().__init__(c_in, c_out, 2 * ratio, stride=ratio, padding=ratio // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight(), self.bias, self.stride, self.padding)


class Encoder(nn.Module):
    def __init__(self, n_band: int, capacity: int, latent_size: int, ratios: Sequence[int]):
        super().__init__()
        self.conv_in = nn.Conv1d(n_band, capacity, 7, padding=3)
        dims = [capacity * 2**i for i in range(len(ratios) + 1)]
        self.norms = nn.ModuleList(nn.BatchNorm1d(d) for d in dims[:-1])
        self.convs = nn.ModuleList(nn.Conv1d(a, b, 2 * r + 1, stride=r, padding=r)
                                   for a, b, r in zip(dims, dims[1:], ratios))
        self.conv_out = nn.Conv1d(dims[-1], 2 * latent_size, 5, padding=2, groups=2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, M, T/M) bands → (μ, s), each (B, latent, frames)."""
        h = self.conv_in(x)
        for norm, conv in zip(self.norms, self.convs):
            h = conv(lrelu(norm(h)))
        return self.conv_out(lrelu(h)).chunk(2, dim=1)


class Residual(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.conv1 = WNConv1d(dim, dim, 3, dilation=dilation)
        self.conv2 = WNConv1d(dim, dim, 3)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.conv2(lrelu(self.conv1(lrelu(h))))


class NoiseGenerator(nn.Module):
    """RAVE's filtered-noise branch: plain strided convolutions to M ×
    `bands` magnitudes a frame, then ops/filters.py's FIR of uniform
    noise."""

    def __init__(self, dim: int, n_band: int, ratios: Sequence[int], bands: int):
        super().__init__()
        chans = [dim] * len(ratios) + [n_band * bands]
        self.convs = nn.ModuleList(nn.Conv1d(a, b, 3, stride=r, padding=1)
                                   for a, b, r in zip(chans, chans[1:], ratios))
        self.n_band, self.target = n_band, math.prod(ratios)

    def forward(self, h: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            h = conv(h if i == 0 else lrelu(h))
        amp = mod_sigmoid(h - NOISE_OFFSET).permute(0, 2, 1)
        amp = amp.reshape(amp.shape[0], amp.shape[1], self.n_band, -1)  # (B, frames, M, bands)
        ir = amp_to_impulse_response(amp, self.target)
        noise = uniform_noise(ir.shape, generator, ir.dtype, ir.device)
        out = fft_convolve(noise, ir).permute(0, 2, 1, 3)  # (B, M, frames, target)
        return out.reshape(out.shape[0], out.shape[1], -1)


class Generator(nn.Module):
    def __init__(self, n_band: int, capacity: int, latent_size: int, ratios: Sequence[int],
                 loud_stride: int, noise_ratios: Sequence[int], noise_bands: int):
        super().__init__()
        n = len(ratios)
        self.conv_in = WNConv1d(latent_size, capacity * 2**n, 7)
        dims = [capacity * 2**(n - i) for i in range(n + 1)]
        self.ups = nn.ModuleList(WNConvTranspose1d(a, b, r) for a, b, r in zip(dims, dims[1:], ratios))
        self.stacks = nn.ModuleList(nn.ModuleList(Residual(b, 3**j) for j in range(3)) for b in dims[1:])
        self.wave = WNConv1d(capacity, n_band, 7)
        self.loud = WNConv1d(capacity, 1, 2 * loud_stride + 1, stride=loud_stride)
        self.noise = NoiseGenerator(capacity, n_band, noise_ratios, noise_bands)
        self.loud_stride = loud_stride

    def forward(self, z: torch.Tensor, add_noise: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z (B, latent, frames) → the bands Y (B, M, T/M)."""
        h = self.conv_in(z)
        for up, stack in zip(self.ups, self.stacks):
            h = up(lrelu(h))
            for res in stack:
                h = res(h)
        loud = self.loud(h)
        if self.loud_stride != 1:
            loud = loud.repeat_interleave(self.loud_stride, dim=-1)
        y = torch.tanh(self.wave(h)) * mod_sigmoid(loud)
        if add_noise:
            y = y + self.noise(h, generator)
        return y


class RAVE(nn.Module):
    """RAVE v1.  `forward(batch)` reconstructs batch["sig"] (B, T) through
    the bands, the encoder, a draw of the latent and the generator;
    `encode`, `reparametrize` and `decoder` are the pieces the phase-1
    train step (`loss_and_grads`) runs with its step marks between them."""

    needs_features = False  # batches are the crops alone, {sig}

    def __init__(self, n_band: int = 16, capacity: int = 64, latent_size: int = 128,
                 ratios: Sequence[int] = (4, 4, 4, 2), loud_stride: int = 1,
                 noise_ratios: Sequence[int] = (4, 4, 4), noise_bands: int = 5, sample_rate: int = 48000,
                 loudness_n_fft: int = 2048, loudness_hop: int = 512, kl_beta: float = 0.1,
                 optimizer_betas: Sequence[float] = (0.5, 0.9), compute_dtype=None):
        super().__init__()
        if compute_dtype is not None:
            raise ValueError("RAVE computes in its parameters' dtype (model.kwargs.dtype float32 or none)")
        self.pqmf = PQMF(n_band)
        self.encoder = Encoder(n_band, capacity, latent_size, ratios)
        self.decoder = Generator(n_band, capacity, latent_size, ratios, loud_stride, noise_ratios, noise_bands)
        self.latent_size, self.sample_rate = latent_size, sample_rate
        self.loudness_n_fft, self.loudness_hop = loudness_n_fft, loudness_hop  # rave/core.py Loudness(sr, 512)
        self.hop = n_band * math.prod(ratios)  # samples a latent frame
        self.kl_beta = float(kl_beta)
        self.optimizer_betas = tuple(float(b) for b in optimizer_betas)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.conv_in.weight.dtype

    @property
    def phases(self):
        from ddsp_pytorch_tpu_torch.training import profiling  # here: training imports the models

        return profiling.RAVE_PHASES

    def latent_shape(self, batch: int, samples: int) -> Tuple[int, int, int]:
        """(B, latent, frames) of the latent of B crops of `samples`."""
        if samples % self.hop:
            raise ValueError(f"a crop of {samples} samples is not a whole number of {self.hop}-sample frames")
        return (batch, self.latent_size, samples // self.hop)

    def draw_shape(self, rows: int, data) -> Tuple[int, int, int]:
        """ε's shape for `rows` crops of `data` (a batch, or a stack or cache
        of them: only its sample axis is read)."""
        return self.latent_shape(rows, data["sig"].shape[-1])

    def draw(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The reparameterisation's standard normal ε of `shape`, from
        `generator`: the draw a step makes (the captured train step draws
        it ahead, with these arguments)."""
        device = generator.device if generator is not None else self.encoder.conv_in.weight.device
        return torch.randn(shape, generator=generator, dtype=self.dtype, device=device)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, T) crops → (the bands X (B, M, T/M), μ, s)."""
        bands = self.pqmf.analysis(x)
        mean, scale = self.encoder(bands)
        return bands, mean, scale

    @staticmethod
    def reparametrize(mean: torch.Tensor, scale: torch.Tensor,
                      eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(z, σ, KL) of RAVE's `reparametrize` with the draw ε injected."""
        std = F.softplus(scale) + SIGMA_FLOOR
        var = std * std
        z = eps * std + mean
        kl = (mean * mean + var - torch.log(var) - 1.0).sum(1).mean()
        return z, std, kl

    def forward(self, batch, *, eps: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                add_noise: bool = False) -> dict:
        x = batch["sig"]
        bands, mean, scale = self.encode(x)
        if eps is None:
            eps = self.draw(mean.shape, generator)
        z, std, kl = self.reparametrize(mean, scale, eps)
        y = self.decoder(z, add_noise=add_noise, generator=generator)
        return {"bands": bands, "mean": mean, "std": std, "z": z, "kl": kl, "rec_bands": y,
                "signal": self.pqmf.synthesis(y)[:, 0]}

    def loss_and_grads(self, state, batch, eps: torch.Tensor, scales, overlap: float):
        """The phase-1 step's loss and the gradient of every parameter, in
        `named_parameters()` order: the bands of batch["sig"] (B, T), the
        encoder, z = μ + σ·ε with ε (B, latent, frames) injected, the
        generator without noise, and training/loss.py `rave_loss`.  The
        noise branch's leaves, which no loss reads, get zero gradients.
        The convolutions run in cuDNN with TF32 off, forward and backward
        (models/crepe.py `conv_precision`).  `state` is not read."""
        from ddsp_pytorch_tpu_torch.models.crepe import conv_precision
        from ddsp_pytorch_tpu_torch.training import loss as loss_mod, profiling  # here: training imports the models

        with conv_precision():
            bands, mean, scale = self.encode(batch["sig"])
            z, _, kl = self.reparametrize(mean, scale, eps)
            profiling.mark(1)
            rec = self.decoder(z)
            profiling.mark(2)
            loss, _ = loss_mod.rave_loss(self, bands, rec, kl, scales, overlap)
            profiling.mark(3)
            grads = torch.autograd.grad(loss, list(self.parameters()), allow_unused=True, materialize_grads=True)
            profiling.mark(4)
        return loss.detach(), list(grads)

    def eval_outputs(self, state, batch, scales, overlap: float, noise=None, generator=None) -> dict:
        """In eval mode (BatchNorm on its running statistics, as RAVE's
        validation), ε injected as `noise` or drawn from `generator`: the
        outputs plus the phase-1 loss and its terms (`loss/<term>`), `sig`
        and the reconstruction `rec`."""
        from ddsp_pytorch_tpu_torch.models.crepe import conv_precision
        from ddsp_pytorch_tpu_torch.training.loss import rave_loss

        training = self.training
        self.eval()
        try:
            with conv_precision():
                out = self(batch, eps=noise, generator=generator)
                loss, terms = rave_loss(self, out["bands"], out["rec_bands"], out["kl"], scales, overlap)
        finally:
            self.train(training)
        out.update({f"loss/{k}": v for k, v in terms.items()})
        out.update({"loss": loss, "sig": batch["sig"], "rec": out["signal"]})
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RAVE":
        """PyTorch's default initialisation drawn from `generator`:
        convolutions U(±1/√fan_in) (kaiming_uniform at a = √5) for weights
        and biases, the weight norms' g = ‖v‖, BatchNorm's scale 1 and
        offset 0 and its running statistics reset."""
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, WNConv1d)):
                w = module.weight if isinstance(module, nn.Conv1d) else module.weight_v
                nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
                fan_in = w.shape[1] * w.shape[2]
                nn.init.uniform_(module.bias, -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in), generator=generator)
                if isinstance(module, WNConv1d):
                    module.weight_g.copy_(torch.linalg.vector_norm(w, dim=(1, 2), keepdim=True))
            elif isinstance(module, nn.BatchNorm1d):
                module.reset_parameters()
        return self
