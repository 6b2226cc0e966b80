"""The CREPE-architecture pitch tracker and its fusion with YIN.

Port of ddsp_pytorch_tpu/models/crepe.py:32-508: the cents codec, the
`CREPE` network (eval and train mode), its decoders (local weighted average,
Viterbi), the 16 kHz polyphase resampler, the salience map on CREPE's
frame grid, `extract_pitch_crepe`, and the CREPE × YIN fusion
(`hybrid_evidence`, `decode_fused`, `extract_pitch_hybrid`) that
configs/config.yaml selects as its default tracker.

Differences from the JAX module, by design:
  * every function takes a mono signal (T,) or a batch of them (N, T); the
    frames of all rows go through the network together, and one Viterbi
    loop runs batched over rows (ops/pitch.py `viterbi`).  BatchNorm in
    eval mode mixes nothing across frames, so each row equals the JAX
    per-row call;
  * the trackers take the network as a `CREPE` module (`load_crepe` reads
    a `{params, batch_stats}` msgpack file, e.g. the shipped
    pretrained/crepe_tiny.msgpack), not a flax tree;
  * the forward runs its convolutions, the dense classifier among them (a
    width-1 convolution), in cuDNN with TF32 off, whatever the global
    flags say (`conv_precision` scopes it; cuBLAS, whose TF32 flag has no
    such scope, is not used).  A training step runs its backward inside
    `conv_precision` too (train_crepe.py).

The JAX module has no Pallas kernel: its convolutions, resampler, decode
and Viterbi are XLA.  Here the convolutions are cuDNN's (conv1d), the
resampler a gather and a product on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.models import COMPUTE_DTYPES
from ddsp_pytorch_tpu_torch.models.decoder import dense, matmul_precision
from ddsp_pytorch_tpu_torch.ops.pitch import first_argmin, pitch_grid, switch_cost, viterbi, yin_emission

MODEL_SRATE = 16000  # CREPE operates on 16 kHz frames
FRAME_LENGTH = 1024  # 64 ms input window
N_BINS = 360
CENTS_PER_BIN = 20.0
BINS_PER_OCTAVE = 1200.0 / CENTS_PER_BIN
# Bin 0 = 32.70 Hz (C1) on the cents-above-10Hz scale CREPE uses.
CENTS_OFFSET = 1200.0 * math.log2(32.70319566257483 / 10.0)

# capacity multiplier → per-layer filter counts × [32, 4, 4, 4, 8, 16]
CAPACITIES = {"micro": 1, "tiny": 4, "small": 8, "medium": 16, "large": 24, "full": 32}
_BASE_FILTERS = (32, 4, 4, 4, 8, 16)
_KERNELS = (512, 64, 64, 64, 64, 64)
_STRIDES = (4, 1, 1, 1, 1, 1)
# flax nn.BatchNorm's default epsilon and momentum
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.99
# the JAX CREPE's default dropout rate after every block
DROPOUT_RATE = 0.25
# the cost that keeps a bin out of the fused decode (crepe.py:494-497)
MASKED_COST = 1e6


def cents_grid() -> np.ndarray:
    """(360,) center of each salience bin, in cents above 10 Hz (float64)."""
    return CENTS_OFFSET + CENTS_PER_BIN * np.arange(N_BINS)


def cents_to_hz(cents):
    """Cents above 10 Hz → Hz (a tensor, an array or a number)."""
    return 10.0 * 2.0 ** (cents / 1200.0)


def hz_to_cents(f0):
    """Hz → cents above 10 Hz, f0 floored at 1e-6."""
    if isinstance(f0, torch.Tensor):
        return 1200.0 * torch.log2(torch.clamp(f0, min=1e-6) / 10.0)
    return 1200.0 * np.log2(np.maximum(f0, 1e-6) / 10.0)


def _same_padding(length: int, kernel: int, stride: int) -> tuple:
    """(left, right) zero padding of XLA's "SAME" convolution: ceil(length /
    stride) outputs, the odd sample of the padding on the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def conv_precision():
    """The scope CREPE's convolutions run in, forward and backward: cuDNN
    with TF32 off, whatever the global flags say."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _xla_cpu_mean(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """The mean of float32 (B, C, T) over B and T, summed in the order of
    XLA's CPU reduction (its tree-reduction rewrite): each reduced axis
    longer than `window` cut into windows of `window` (zero-padded), each
    window summed one element after another, b outer and t inner, the
    window sums reduced the same way, then times 1/(B·T) in float32.  Bit
    for bit jnp.mean's at CREPE's batch statistics (batch ≤ 32), where a
    float32 sum in another order flips bf16 roundings that the next
    layers' batch statistics spread over every element."""
    n = x.shape[0] * x.shape[2]
    x = x.transpose(1, 2)  # (B, T, C)
    while True:
        r0, r1, c = x.shape
        w0, w1 = (window if r0 > window else r0), (window if r1 > window else r1)
        n0, n1 = -(-r0 // w0), -(-r1 // w1)
        x = F.pad(x, (0, 0, 0, n1 * w1 - r1, 0, n0 * w0 - r0)).reshape(n0, w0, n1, w1, c)
        acc = torch.zeros(n0, n1, c, dtype=x.dtype)
        for i in range(w0):
            for j in range(w1):
                acc = acc + x[:, i, :, j]
        if n0 == n1 == 1:
            return acc[0, 0] * torch.tensor(1.0 / n, dtype=x.dtype)
        x = acc


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the channel axis of (B, C, T).

    Eval (use_running_average=True): (x − mean) / sqrt(var + ε) · scale +
    bias with the running statistics.  Train: the batch's mean and biased
    variance (flax's E[x²] − E[x]², floored at 0) normalize, and the
    running statistics move in place to momentum · running + (1 −
    momentum) · batch, the variance biased too (torch's own running update
    would take the unbiased one).

    A bf16 input is flax's nn.BatchNorm(dtype=bf16): the statistics (batch
    or running) in float32 (on the CPU the batch's summed in XLA's order,
    `_xla_cpu_mean`), (x − mean) · (rsqrt(var + ε) · scale) + bias in
    float32 on the input cast up, the result cast to bf16
    (flax.linen.normalization `_compute_stats` and `_normalize`)."""

    def __init__(self, channels: int, eps: float = BATCH_NORM_EPS,
                 momentum: float = BATCH_NORM_MOMENTUM):
        super().__init__()
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out_dtype = x.dtype
        if out_dtype == torch.bfloat16:
            x = x.float()
        elif not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        if not train:
            scale = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean[:, None]) * scale[:, None] + self.bias[:, None]).to(out_dtype)
        if out_dtype == torch.bfloat16 and x.device.type == "cpu":
            mean, mean_sq = _xla_cpu_mean(x), _xla_cpu_mean(torch.square(x))
        else:
            mean, mean_sq = x.mean(dim=(0, 2)), torch.square(x).mean(dim=(0, 2))
        var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(self.momentum * self.running_mean + (1.0 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var + (1.0 - self.momentum) * var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None]) * scale[:, None] + self.bias[:, None]).to(out_dtype)


def _conv_low(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's nn.Conv(dtype=dtype) with the layer's parameters: the product
    of the `dtype` input and kernel, accumulated in float32 and rounded to
    `dtype`, then the `dtype` bias added.  On the card cuDNN computes it in
    `dtype`; on the CPU the product is a float32 contraction of the
    rounded operands' windows (unfold, einsum), which sums in the order of
    XLA's CPU convolution (bit for bit the compiled JAX CREPE on the CPU
    tests' inputs), since torch's CPU bf16 conv1d is wrong at CREPE's
    narrow layers (errors as large as the outputs at 4 input and 4 output
    channels, torch 2.13)."""
    w = conv.weight.to(dtype)
    if x.device.type == "cpu":
        windows = x.float().unfold(-1, w.shape[-1], conv.stride[0])  # (B, C, T, K)
        y = torch.einsum("bctk,ock->bot", windows, w.float()).to(dtype)
    else:
        y = F.conv1d(x, w, None, conv.stride)
    return y + conv.bias.to(dtype)[:, None]


class CREPE(nn.Module):
    """(B, 1024) audio frames → (B, 360) pitch-salience logits
    (crepe.py:60-106): each frame normalized (population std, floored at
    1e-6), six blocks of conv ("SAME" padding) → ReLU → BatchNorm → max-pool
    2 → dropout, then a dense classifier over the (4, 16·mult) map
    flattened time-major, as flax flattens it.  The classifier is an
    nn.Linear applied as a width-1 convolution, so that every product runs
    in cuDNN under the TF32-off scope.

    In eval mode (the default) BatchNorm uses its running statistics and
    dropout is the identity.  With train=True BatchNorm normalizes by the
    batch and updates its running statistics in place (`BatchNorm`), and
    dropout keeps each activation with probability 1 − `dropout`, scaling
    the kept ones by 1 / (1 − `dropout`), as flax's nn.Dropout does (rate
    0: the identity; rate 1: zeros).  Its keep masks are `dropout_masks`
    (one bool tensor a block, in the block's (B, C, T) layout: flax's (B,
    T, C) mask transposed) where given, else drawn from `generator`.

    `dtype` is the JAX module's (crepe.py:70-103), "float32" or "bfloat16"
    (None: the parameters' own type, as for float64 checks).  In bf16 the
    frames are normalized in float32 and cast; each convolution takes bf16
    input, kernel and bias and adds the bias to the rounded product (flax's
    nn.Conv(dtype=bf16)); ReLU, max-pool and dropout run in bf16;
    BatchNorm as `BatchNorm` says; the classifier is decoder.py's `dense`
    with its float32 upcast (the logits are cast to float32 at once, so
    compiled JAX keeps that sum unrounded), its product reduced in float32
    (`matmul_precision`).  Parameters and running statistics stay float32.

    Submodules are named as in the flax tree (conv1..conv6, bn1..bn6,
    classifier); weights.crepe_state_dict_from_flax maps a tree onto them."""

    def __init__(self, capacity: str = "tiny", dropout: float = DROPOUT_RATE, dtype: Optional[str] = "float32"):
        super().__init__()
        if capacity not in CAPACITIES:
            raise ValueError(f"unknown CREPE capacity {capacity!r} ({'|'.join(CAPACITIES)})")
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"CREPE dtype {dtype!r} is not one of {sorted(k for k in COMPUTE_DTYPES if k)}")
        if not 0.0 <= dropout <= 1.0:
            raise ValueError(f"CREPE dropout {dropout} is not a rate in [0, 1]")
        self.capacity = capacity
        self.dropout = float(dropout)
        self.dtype = dtype
        self.compute_dtype = COMPUTE_DTYPES[dtype]
        mult = CAPACITIES[capacity]
        channels, length = 1, FRAME_LENGTH
        self._pads = []
        for i, (base, kernel, stride) in enumerate(zip(_BASE_FILTERS, _KERNELS, _STRIDES)):
            setattr(self, f"conv{i + 1}", nn.Conv1d(channels, base * mult, kernel, stride))
            setattr(self, f"bn{i + 1}", BatchNorm(base * mult))
            self._pads.append(_same_padding(length, kernel, stride))
            channels, length = base * mult, -(-length // stride) // 2
        self.classifier = nn.Linear(length * channels, N_BINS)

    def block_shapes(self, batch: int) -> list:
        """The (B, C, T) shape of each block's output: the dropout masks'."""
        shapes, length = [], FRAME_LENGTH
        for i, stride in enumerate(_STRIDES):
            length = -(-length // stride) // 2
            shapes.append((batch, getattr(self, f"conv{i + 1}").out_channels, length))
        return shapes

    def forward(self, frames: torch.Tensor, train: bool = False, dropout_masks=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train and dropout_masks is None and generator is None:
            raise ValueError("CREPE(train=True) needs dropout_masks or a generator to draw them")
        dt = self.compute_dtype
        mean = frames.mean(dim=-1, keepdim=True)
        std = frames.std(dim=-1, keepdim=True, correction=0)
        x = ((frames - mean) / torch.clamp(std, min=1e-6))[:, None, :]  # (B, 1, T)
        if dt is not None:
            x = x.to(dt)
        with conv_precision(), matmul_precision():
            for i, pad in enumerate(self._pads):
                conv = getattr(self, f"conv{i + 1}")
                x = conv(F.pad(x, pad)) if dt is None else _conv_low(conv, F.pad(x, pad), dt)
                x = getattr(self, f"bn{i + 1}")(F.relu(x), train)
                x = F.max_pool1d(x, 2, 2)
                if train:
                    x = self._dropout(x, i, dropout_masks, generator)
            x = x.transpose(1, 2).reshape(x.shape[0], -1)  # (B, 4 · C), time-major
            if dt is not None:
                return dense(self.classifier, x, dt, upcast=True)
            return F.conv1d(x[:, :, None], self.classifier.weight[:, :, None], self.classifier.bias)[:, :, 0]

    def _dropout(self, x: torch.Tensor, i: int, dropout_masks, generator) -> torch.Tensor:
        """flax's nn.Dropout(self.dropout) on block i's output, in x's type."""
        if self.dropout == 0.0:
            return x
        if self.dropout == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.dropout
        if dropout_masks is not None:
            mask = dropout_masks[i].to(x.device)
        else:
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def _capacity_of(tree: dict) -> str:
    """The capacity whose conv1 width a `{params, ...}` tree has."""
    width = np.asarray(tree["params"]["conv1"]["kernel"]).shape[-1]
    for name, mult in CAPACITIES.items():
        if _BASE_FILTERS[0] * mult == width:
            return name
    raise ValueError(f"no CREPE capacity has a conv1 of {width} filters")


def crepe_from_tree(tree: dict, capacity: Optional[str] = None, device="cuda") -> CREPE:
    """A `{params, batch_stats}` tree (numpy, as msgpack_restore gives it)
    → an eval-mode CREPE on `device`.  `capacity` defaults to the tree's;
    a capacity that does not fit the tree raises."""
    from ddsp_pytorch_tpu_torch.weights import crepe_state_dict_from_flax

    device = resolve_device(device)
    found = _capacity_of(tree)
    if capacity is not None and capacity != found:
        raise ValueError(f"CREPE weights of capacity {found!r}, asked for {capacity!r}")
    model = CREPE(found)
    model.load_state_dict(crepe_state_dict_from_flax(tree), strict=True)
    return model.to(device).eval()


def load_crepe(path: str, capacity: Optional[str] = None, device="cuda") -> CREPE:
    """The CREPE of a msgpack file of `{params, batch_stats}` (written by
    scripts/train_crepe.py; pretrained/crepe_tiny.msgpack is shipped), on
    `device`."""
    from ddsp_pytorch_tpu_torch.bundle import msgpack_restore

    device = resolve_device(device)
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return crepe_from_tree(tree, capacity, device)


# ---------------------------------------------------------------- decoding


def salience_to_cents(salience: torch.Tensor, window: int = 4) -> torch.Tensor:
    """(…, 360) salience → (…,) cents: the weighted average of the grid over
    ±`window` bins around the argmax (crepe.py:109-125), the bins clipped
    at the grid's edges counted once."""
    grid = torch.tensor(cents_grid().astype(np.float32), device=salience.device)
    offsets = torch.arange(-window, window + 1, device=salience.device)
    idx = first_argmin(-salience, dim=-1)[..., None] + offsets  # ties to the first, as jnp.argmax
    clipped = torch.clamp(idx, 0, N_BINS - 1)
    w = torch.gather(salience, -1, clipped)
    w = torch.where(idx == clipped, w, torch.zeros_like(w))
    return torch.sum(w * grid[clipped], dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1e-9)


def _near_path(values: torch.Tensor, path: np.ndarray) -> torch.Tensor:
    """`values` (…, F, 360) where the bin is within 4 of the path's (…, F)
    bin, 0 elsewhere (crepe.py:144-150)."""
    path = torch.as_tensor(path, device=values.device)
    near = torch.abs(torch.arange(N_BINS, device=values.device) - path[..., None]) <= 4
    return torch.where(near, values, torch.zeros_like(values))


def viterbi_path(cost: torch.Tensor, switch_per_octave: float) -> np.ndarray:
    """The min-sum Viterbi path (…, F) through (…, F, 360) costs with a jump
    cost of `switch_per_octave` an octave (crepe.py:137-142; ops/pitch.py
    `viterbi`, batched over rows)."""
    switch = torch.tensor(switch_cost(N_BINS, BINS_PER_OCTAVE, switch_per_octave), device=cost.device)
    return viterbi(cost, switch)


def viterbi_cents(salience: torch.Tensor, switch_per_octave: float = 3.0) -> torch.Tensor:
    """(…, F, 360) salience → (…, F) cents (crepe.py:128-151): the Viterbi
    path through −log(salience) (clipped at 1e-6) with the per-octave jump
    cost, then the local average of the salience masked to ±4 bins around
    the path.  The average re-takes the argmax of the masked salience,
    which need not be the path's bin, as the JAX function does."""
    emission = -torch.log(torch.clamp(salience, 1e-6, 1.0))
    path = viterbi_path(emission, switch_per_octave)
    return salience_to_cents(_near_path(salience, path))


# ------------------------------------------------------- full extract path


@functools.lru_cache(maxsize=None)
def _resample_kernel(up: int, down: int, taps_per_phase: int = 32) -> np.ndarray:
    """Windowed-sinc FIR for rational resampling (crepe.py:157-164)."""
    cutoff = 1.0 / max(up, down)  # in units of the upsampled Nyquist
    half = taps_per_phase * max(up, down) // 2
    n = np.arange(-half, half + 1)
    kernel = cutoff * np.sinc(cutoff * n) * np.hanning(2 * half + 1)
    return (kernel * up).astype(np.float32)


def resample_to_model_rate(signal: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """(…, T) at sample_rate → (…, ceil(T·16000/sr)) at 16 kHz, the JAX
    module's polyphase windowed sinc (crepe.py:167-201; not scipy's
    resample_poly): output q is Σ_w x[i_q + w] · k̃[(i_q + w)·up − q·down +
    P] over the window of inputs its taps touch (k̃ the flipped kernel, P
    its half length, taps outside the kernel or the input 0).  The index
    and tap matrices are built on the signal's device from the kernel, in
    integer arithmetic, so they equal the JAX function's numpy ones.  16
    kHz input is returned as is."""
    if int(sample_rate) == MODEL_SRATE:
        return signal
    t = int(signal.shape[-1])
    g = math.gcd(int(sample_rate), MODEL_SRATE)
    up, down = MODEL_SRATE // g, int(sample_rate) // g
    kernel = _resample_kernel(up, down)
    length = kernel.shape[0]
    dev = signal.device
    flipped = torch.tensor(kernel[::-1].copy(), device=dev)
    t_out = -(-t * up // down)  # ceil: len(zero-stuffed conv output) / down
    window = (length - 1) // up + 2  # inputs touching one output
    s = torch.arange(t_out, device=dev) * down - length // 2
    i_mat = -torch.div(-s, up, rounding_mode="floor")[:, None] + torch.arange(window, device=dev)
    j_mat = i_mat * up - s[:, None]  # tap index per (output, window slot)
    valid = (j_mat >= 0) & (j_mat < length) & (i_mat >= 0) & (i_mat < t)
    taps = torch.where(valid, flipped[torch.clamp(j_mat, 0, length - 1)], torch.zeros((), device=dev))
    return torch.sum(signal[..., torch.clamp(i_mat, 0, t - 1)] * taps, dim=-1)


def crepe_hop(sample_rate: int, block_size: int) -> int:
    """The 16 kHz hop of one block: int(16000 · block / sr), at least 1."""
    return max(1, int(MODEL_SRATE * block_size / sample_rate))


def crepe_salience(signal, sample_rate: int, block_size: int, model: CREPE,
                   batch_frames: int = 512, *, device="cuda") -> tuple:
    """(T,) or (N, T) signal at `sample_rate` → ((…, F16, 360) salience,
    hop) on `device` (crepe.py:218-259): resampled to 16 kHz, framed at
    F16 = 1 + T16 // hop zero-center-padded frames, the frames of every
    row through `model` (moved to `device`) in chunks of `batch_frames`."""
    device = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32).to(device)
    if signal.dim() not in (1, 2):
        raise ValueError(f"expects a mono (T,) signal or a batch (N, T), got {tuple(signal.shape)}")
    model = model.to(device)
    x16 = resample_to_model_rate(signal, int(sample_rate))
    hop = crepe_hop(sample_rate, block_size)
    pad = FRAME_LENGTH // 2
    padded = F.pad(x16, (pad, pad))
    n_frames = 1 + int(x16.shape[-1]) // hop
    idx = (torch.arange(n_frames, device=device)[:, None] * hop
           + torch.arange(FRAME_LENGTH, device=device)[None, :])
    frames = padded[..., idx].reshape(-1, FRAME_LENGTH)
    with torch.inference_mode():
        logits = torch.cat([model(frames[i : i + batch_frames])
                            for i in range(0, frames.shape[0], batch_frames)])
    salience = torch.sigmoid(logits)
    return salience.reshape(*signal.shape[:-1], n_frames, N_BINS), hop


@functools.lru_cache(maxsize=64)
def _block_grid_interp(n_src: int, hop: int, n_out: int, block_size: int, sample_rate: int):
    """jnp.interp's index and weight (crepe.py:262-268) from the 16 kHz hop
    grid (n_src frames) to the block grid (n_out frames), in float32 as
    the JAX function computes them: (i (n_out,) int64, ratio (n_out,)
    float32, below (n_out,) bool, above (n_out,) bool), read-only."""
    xp = (np.arange(n_src) * hop / MODEL_SRATE).astype(np.float32)
    x = (np.arange(n_out) * block_size / sample_rate).astype(np.float32)
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, max(n_src - 1, 1))
    dx = xp[i] - xp[i - 1]
    eps = np.spacing(np.finfo(np.float32).eps)
    dx0 = np.abs(dx) <= eps
    ratio = (x - xp[i - 1]) / np.where(dx0, np.float32(1.0), dx)
    ratio = np.where(dx0, np.float32(0.0), ratio).astype(np.float32)
    out = (i.astype(np.int64), ratio, x < xp[0], x > xp[-1])
    for arr in out:
        arr.flags.writeable = False
    return out


def interp_to_block_grid(f0: torch.Tensor, hop: int, n_out: int, block_size: int,
                         sample_rate: int) -> torch.Tensor:
    """(…, F16) track on the 16 kHz hop grid → (…, n_out) on the block grid,
    by linear interpolation in time, clamped at the edges (jnp.interp
    semantics, crepe.py:262-268)."""
    i, ratio, below, above = _block_grid_interp(int(f0.shape[-1]), int(hop), int(n_out),
                                                int(block_size), int(sample_rate))
    dev = f0.device
    i, ratio = torch.tensor(i, device=dev), torch.tensor(ratio, device=dev)
    lo, hi = f0[..., i - 1], f0[..., i]
    out = lo + ratio * (hi - lo)
    out = torch.where(torch.tensor(below, device=dev), f0[..., :1], out)
    return torch.where(torch.tensor(above, device=dev), f0[..., -1:], out)


def cents_keep(fmin: Optional[float], fmax: Optional[float]) -> np.ndarray:
    """(360,) bool: the bins whose center lies in [fmin, fmax] Hz (None
    leaves that side open)."""
    grid = cents_grid()
    lo = 1200.0 * math.log2(fmin / 10.0) if fmin is not None else -np.inf
    hi = 1200.0 * math.log2(fmax / 10.0) if fmax is not None else np.inf
    return (grid >= lo) & (grid <= hi)


def extract_pitch_crepe(signal, sample_rate: int, block_size: int, model: CREPE, viterbi: bool = True,
                        batch_frames: int = 512, fmin: Optional[float] = None,
                        fmax: Optional[float] = None, *, device="cuda") -> torch.Tensor:
    """Frame-rate f0 in Hz through the CREPE network (crepe.py:271-314):
    (T,) or (N, T) → (…, T // block_size) float32 on `device`.  The
    salience of bins outside [fmin, fmax] is zeroed before the decode
    (Viterbi by default, else the local average around the argmax); the
    16 kHz track is interpolated onto the block grid."""
    device = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32).to(device)
    n_out = int(signal.shape[-1]) // int(block_size)
    salience, hop = crepe_salience(signal, sample_rate, block_size, model, batch_frames, device=device)
    if fmin is not None or fmax is not None:
        keep = torch.tensor(cents_keep(fmin, fmax), device=device)
        salience = torch.where(keep, salience, torch.zeros_like(salience))
    cents = viterbi_cents(salience) if viterbi else salience_to_cents(salience)
    return interp_to_block_grid(cents_to_hz(cents), hop, n_out, block_size, sample_rate)


# ------------------------------------------------------- CREPE×YIN fusion


@functools.lru_cache(maxsize=None)
def _yin_to_crepe_grid(fmin: float, fmax: float, bins_per_octave: int) -> tuple:
    """(idx0 (360,) int64, frac (360,) float32): the linear interpolation
    from the YIN log grid onto the CREPE cents grid, clamped to the YIN
    grid's edges (crepe.py:317-328).  Read-only arrays."""
    yin_cents = 1200.0 * np.log2(pitch_grid(fmin, fmax, bins_per_octave) / 10.0)
    pos = np.interp(cents_grid(), yin_cents, np.arange(yin_cents.shape[0]))
    idx0 = np.clip(np.floor(pos).astype(np.int64), 0, yin_cents.shape[0] - 2)
    frac = (pos - idx0).astype(np.float32)
    idx0.flags.writeable = False
    frac.flags.writeable = False
    return idx0, frac


def hybrid_evidence(signal, sample_rate: int, block_size: int, model: CREPE, batch_frames: int = 512,
                    fmin: float = 32.0, fmax: float = 2100.0, *, device="cuda") -> tuple:
    """Both evidence maps on CREPE's (frame, cents) grid (crepe.py:403-449):
    ((…, F16, 360) salience, (…, F16, 360) YIN CMNDF, hop).  The YIN
    emission (ops/pitch.py, on the block hop between fmin and fmax) is
    interpolated onto the cents grid, then onto the CREPE frame times, the
    time position clamped to the YIN frame range before its floor/fraction
    split."""
    device = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32).to(device)
    if signal.dim() not in (1, 2):
        raise ValueError(f"expects a mono (T,) signal or a batch (N, T), got {tuple(signal.shape)}")
    salience, hop = crepe_salience(signal, sample_rate, block_size, model, batch_frames, device=device)
    n16 = salience.shape[-2]
    d = yin_emission(signal, int(sample_rate), int(block_size), fmin=fmin, fmax=fmax)  # (…, Fy, bins)
    idx0, frac = _yin_to_crepe_grid(float(fmin), float(fmax), 60)
    idx0 = torch.tensor(idx0, device=device)
    frac = torch.tensor(frac, device=device)
    d_c = d[..., idx0] * (1.0 - frac) + d[..., idx0 + 1] * frac  # (…, Fy, 360)
    n_yin = d.shape[-2]
    pos = (np.arange(n16) * hop / MODEL_SRATE) * sample_rate / block_size
    pos = np.clip(pos, 0.0, n_yin - 1)
    t0 = np.clip(np.floor(pos).astype(np.int64), 0, n_yin - 2)
    tfrac = torch.tensor((pos - t0).astype(np.float32), device=device)[:, None]
    t0 = torch.tensor(t0, device=device)
    d_16 = d_c[..., t0, :] * (1.0 - tfrac) + d_c[..., t0 + 1, :] * tfrac  # (…, F16, 360)
    return salience, d_16, hop


def fused_cost(salience: torch.Tensor, d_16: torch.Tensor, yin_weight: float = 4.0,
               crepe_weight: float = 1.0, salience_floor: float = 1e-6, confidence_gate: float = 0.0,
               keep=None) -> torch.Tensor:
    """The (…, F16, 360) cost that decode_fused's Viterbi runs on
    (crepe.py:484-497): crepe_weight · (−log clip(S, salience_floor, 1)) ·
    (max S of the frame)^confidence_gate (the gate off at 0) + yin_weight
    · d'; bins outside `keep` (an optional (360,) bool mask) cost 1e6."""
    crepe_cost = -torch.log(torch.clamp(salience, salience_floor, 1.0))
    gate_pow = float(confidence_gate)
    if gate_pow > 0.0:
        conf = salience.amax(dim=-1, keepdim=True)
        crepe_cost = crepe_cost * conf ** gate_pow
    cost = crepe_weight * crepe_cost + yin_weight * d_16
    if keep is not None:
        keep = torch.as_tensor(np.asarray(keep, bool), device=cost.device)
        cost = torch.where(keep, cost, torch.full_like(cost, MASKED_COST))
    return cost


def decode_fused(salience: torch.Tensor, d_16: torch.Tensor, yin_weight: float = 4.0,
                 crepe_weight: float = 1.0, switch_per_octave: float = 3.0,
                 salience_floor: float = 1e-6, confidence_gate: float = 0.0,
                 keep=None) -> torch.Tensor:
    """Fused evidence → (…, F16) f0 in Hz (crepe.py:452-508): the Viterbi
    path through `fused_cost`, then the local average of exp(−(cost − the
    frame's min)) masked to ±4 bins around the path (exactly 0 on masked
    bins: the exp underflows)."""
    cost = fused_cost(salience, d_16, yin_weight, crepe_weight, salience_floor, confidence_gate, keep)
    path = viterbi_path(cost, switch_per_octave)
    fused_salience = torch.exp(-(cost - cost.amin(dim=-1, keepdim=True)))
    return cents_to_hz(salience_to_cents(_near_path(fused_salience, path)))


def extract_pitch_hybrid(signal, sample_rate: int, block_size: int, model: CREPE,
                         batch_frames: int = 512, yin_weight: float = 8.0, crepe_weight: float = 1.0,
                         switch_per_octave: float = 60.0, salience_floor: float = 0.03,
                         confidence_gate: float = 2.0, fmin: float = 32.0, fmax: float = 2100.0, *,
                         device="cuda") -> torch.Tensor:
    """CREPE × YIN fused pitch (crepe.py:331-400): (T,) or (N, T) → (…,
    T // block_size) f0 in Hz on `device`, from one Viterbi pass over both
    evidence maps (`hybrid_evidence`, `decode_fused`), the bins outside
    [fmin, fmax] kept out of the decode.  The defaults are the JAX
    function's, tuned on the robustness conditions of
    pretrained/pitch_robustness.json."""
    device = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32).to(device)
    salience, d_16, hop = hybrid_evidence(signal, sample_rate, block_size, model, batch_frames,
                                          fmin=fmin, fmax=fmax, device=device)
    n_out = int(signal.shape[-1]) // int(block_size)
    f0 = decode_fused(salience, d_16, yin_weight=yin_weight, crepe_weight=crepe_weight,
                      switch_per_octave=switch_per_octave, salience_floor=salience_floor,
                      confidence_gate=confidence_gate, keep=cents_keep(fmin, fmax))
    return interp_to_block_grid(f0, hop, n_out, block_size, sample_rate)
