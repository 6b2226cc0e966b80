"""The multiscale spectral loss of a train step — hand-written kernels around
cuFFT, with the loss's gradient computed in its forward pass.

Per scale n (hop h = int(n·(1 − overlap)), centred reflect pad n/2, F = 1 +
(T + 2·(n/2) − n) // h frames), over target x and reconstruction y (B, T)
stacked as 2B rows:

  1. `stft_frame`: every frame through the reflect pad by index arithmetic,
     times c = Hann · n^-1/2 (`window_constant`) → (2B, F, n);
  2. torch.fft.rfft (cuFFT R2C) → (2B, F, n/2 + 1);
  3. `stft_loss_grad`: the scale's loss terms summed into per-block
     partials, and the gradient with respect to y's spectrum, weighted for
     an unnormalised C2R (see ops/kernels/stft_loss.cu);
  after all scales, `stft_loss_sum`: the partials in one fixed order → the
  loss, Σ_scales mean|S_x − S_y| + mean|log(S_x + ε) − log(S_y + ε)|;
  backward, per scale:
  4. torch.fft.irfft(norm="forward") (cuFFT C2R) → the frames' gradient;
  5. `stft_overlap_add`: each sample gathers its frames' gradients at its
     padded position and the reflect pad's mirrors, times c and the
     upstream gradient; the first scale writes, the others add.

RAVE v1's distance (`form="rave"`, models/rave.py) has the relative
Frobenius norm ‖S_x − S_y‖ / ‖S_x‖ of the scale in place of the mean L1
linear term; its gradient needs both norms first, so step 3 is two passes:

  3a. `stft_rave_norms`: Σ(|S_x| − |S_y|)² and Σ|S_x|² into per-block
      partials;
  3b. `stft_rave_loss_grad`: the partials summed in every block, then the
      terms and the gradient as in 3, the linear term's (|S_y| − |S_x|) /
      (‖S_x − S_y‖·‖S_x‖); block 0's partial carries ‖S_x − S_y‖ / ‖S_x‖.

DDSP's form (`form="ddsp"`, the default) is computed as before, pass for
pass.  The loss is the train step's last node, so step 3 needs no second
read of the spectra.  `MultiscaleSpectralLoss` joins the passes as one autograd
function.  Each of the four wrappers is a dispatch point: a CPU tensor runs
the plain PyTorch version (`*_plain`, the kernel's dataflow pass for pass,
in float64 too), a float32 CUDA tensor launches the kernel
(ops/kernels/stft_loss.cu).  Nothing falls back.  training/loss.py
`spectral_loss` sends a train step on the card here and keeps the plain
STFTs everywhere else.  The JAX package leaves its loss to XLA, so these
kernels replace no Pallas kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch

from ddsp_pytorch_tpu_torch.ops import kernels
from ddsp_pytorch_tpu_torch.ops.core import _EPS
from ddsp_pytorch_tpu_torch.ops.spectral import hann_window, hop_length

# stft_loss.cu's kLossThreads; the partials' blocks, at most LOSS_MAX_BLOCKS
# (8 resident blocks on each of an H100's 132 SMs), walk the bins grid-stride
LOSS_THREADS, LOSS_MAX_BLOCKS = 256, 1056
# the kernels index in 32 bits
MAX_ELEMENTS = 2**31 - 1


@functools.lru_cache(maxsize=None)
def window_constant(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The periodic Hann window times n^-1/2 (n,), computed in float64 and
    rounded once to `dtype`.  Read-only: callers share the cached tensor."""
    return (hann_window(n, torch.float64) / math.sqrt(n)).to(device, dtype)


def n_frames(t: int, n: int, hop: int) -> int:
    """Frames of a centred STFT of T samples: 1 + (T + 2·(n/2) − n) // hop."""
    return 1 + (t + 2 * (n // 2) - n) // hop


def loss_blocks(count: int) -> int:
    """The partials (blocks) of `stft_loss_grad` over `count` bins."""
    return max(1, min(-(-count // LOSS_THREADS), LOSS_MAX_BLOCKS))


def _reflect_index(t: int, n: int, hop: int, frames: int, device) -> torch.Tensor:
    """(F, n) index into the signal of each frame's samples through the
    centred reflect pad."""
    i = (torch.arange(frames, device=device)[:, None] * hop + torch.arange(n, device=device)[None, :]
         - n // 2)
    return torch.where(i < 0, -i, torch.where(i >= t, 2 * (t - 1) - i, i))


def stft_frame_plain(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor, hop: int) -> torch.Tensor:
    """Plain version of the framing kernel: x, y (B, T), c (n,) → the
    windowed frames of x's rows then y's (2B, F, n)."""
    t, n = x.shape[-1], c.shape[0]
    rows = torch.cat([x, y])
    return rows[:, _reflect_index(t, n, hop, n_frames(t, n, hop), x.device)] * c


def stft_loss_grad_plain(spec: torch.Tensor, n: int, partials: torch.Tensor) -> torch.Tensor:
    """Plain version of the loss-and-gradient kernel: spec (2B, F, bins),
    the target's rows first → the gradient with respect to the
    reconstruction's spectrum, weighted for the unnormalised C2R (B, F,
    bins); writes the scale's partial sums, divided by M = B·F·bins, into
    `partials` (blocks,), bin i into block (i // LOSS_THREADS) % blocks as
    the kernel's grid-stride loop takes it."""
    b = spec.shape[0] // 2
    sx, sy = spec[:b], spec[b:]
    ax, ay = sx.abs(), sy.abs()
    lx, ly = torch.log(ax + _EPS), torch.log(ay + _EPS)
    terms = ((ax - ay).abs().double() + (lx - ly).abs().double()).flatten()
    blocks = partials.shape[0]
    owner = (torch.arange(terms.shape[0], device=spec.device) // LOSS_THREADS) % blocks
    inv_m = 1.0 / terms.shape[0]
    partials.copy_(torch.zeros_like(partials).index_add_(0, owner, terms) * inv_m)
    g = (torch.sign(ay - ax) + torch.sign(ly - lx) / (ay + _EPS)) * inv_m
    bins = spec.shape[-1]
    edge = torch.zeros(bins, dtype=torch.bool, device=spec.device)
    edge[0] = True
    if n % 2 == 0:
        edge[-1] = True
    s = torch.where(ay > 0, torch.where(edge, g, 0.5 * g) / torch.where(ay > 0, ay, 1.0), 0.0)
    return torch.complex(sy.real * s, torch.where(edge, 0.0, sy.imag * s))


def stft_rave_norms_plain(spec: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of the norms kernel: spec (2B, F, bins), the target's
    rows first → `norms` (2, blocks) float64: Σ(|S_x| − |S_y|)² and
    Σ|S_x|² of the bins of each block, bin i in block (i // LOSS_THREADS)
    % blocks."""
    b = spec.shape[0] // 2
    ax, ay = spec[:b].abs(), spec[b:].abs()
    d2 = ((ax - ay).double() ** 2).flatten()
    x2 = (ax.double() ** 2).flatten()
    blocks = norms.shape[1]
    owner = (torch.arange(d2.shape[0], device=spec.device) // LOSS_THREADS) % blocks
    for row, terms in enumerate((d2, x2)):
        norms[row].copy_(torch.zeros(blocks, dtype=torch.float64, device=spec.device).index_add_(0, owner, terms))
    return norms


def stft_rave_loss_grad_plain(spec: torch.Tensor, n: int, partials: torch.Tensor,
                              norms: torch.Tensor) -> torch.Tensor:
    """Plain version of RAVE's loss-and-gradient kernel: as
    `stft_loss_grad_plain`, with the linear term ‖S_x − S_y‖ / ‖S_x‖ from
    `norms` (2, blocks), added to block 0's partial, and its gradient
    (|S_y| − |S_x|) / (‖S_x − S_y‖·‖S_x‖)."""
    b = spec.shape[0] // 2
    sx, sy = spec[:b], spec[b:]
    ax, ay = sx.abs(), sy.abs()
    lx, ly = torch.log(ax + _EPS), torch.log(ay + _EPS)
    terms = (lx - ly).abs().double().flatten()
    blocks = partials.shape[0]
    owner = (torch.arange(terms.shape[0], device=spec.device) // LOSS_THREADS) % blocks
    inv_m = 1.0 / terms.shape[0]
    nd, nx = norms[0].sum().sqrt(), norms[1].sum().sqrt()
    ok = (nd > 0) & (nx > 0)
    sums = torch.zeros_like(partials).index_add_(0, owner, terms) * inv_m
    sums[0] = sums[0] + torch.where(nx > 0, nd / torch.where(nx > 0, nx, 1.0), 0.0)
    partials.copy_(sums)
    lin = torch.where(ok, 1.0 / torch.where(ok, nd * nx, 1.0), 0.0).to(ay.dtype)
    g = (ay - ax) * lin + torch.sign(ly - lx) / (ay + _EPS) * inv_m
    bins = spec.shape[-1]
    edge = torch.zeros(bins, dtype=torch.bool, device=spec.device)
    edge[0] = True
    if n % 2 == 0:
        edge[-1] = True
    s = torch.where(ay > 0, torch.where(edge, g, 0.5 * g) / torch.where(ay > 0, ay, 1.0), 0.0)
    return torch.complex(sy.real * s, torch.where(edge, 0.0, sy.imag * s))


def stft_loss_sum_plain(partials: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the sum kernel: every partial → the loss (0-d)."""
    return partials.sum().to(dtype)


def stft_overlap_add_plain(gframes: torch.Tensor, c: torch.Tensor, go: torch.Tensor, t: int, hop: int,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the overlap-add kernel: the frames' gradients
    gframes (B, F, n), c (n,), the upstream gradient go (0-d) → the
    signal's gradient (B, T), each sample gathering, at its own padded
    position and at the reflect pad's mirrors, Σ over the frames f holding
    position p (f from p // hop down, k = p − f·hop < n) of g[f, k]·c[k];
    added to `out` where given."""
    rows, frames, n = gframes.shape
    pad = n // 2
    flat = gframes.reshape(rows, frames * n)
    samples = torch.arange(t, device=gframes.device)

    def gather(p):
        acc = torch.zeros((rows, t), dtype=gframes.dtype, device=gframes.device)
        f, k = p // hop, p % hop
        while True:
            ok = (k < n) & (f >= 0)
            if not bool(ok.any()):
                return acc
            ok &= f < frames
            idx = torch.where(ok, f * n + k, 0)
            acc = acc + torch.where(ok, flat[:, idx] * c[torch.where(ok, k, 0)], 0.0)
            f, k = f - 1, k + hop

    acc = gather(samples + pad)
    acc = acc + torch.where((samples >= 1) & (samples <= pad), gather((pad - samples).clamp(min=0)), 0.0)
    mirror = (samples >= t - 1 - pad) & (samples <= t - 2)
    acc = acc + torch.where(mirror, gather(torch.where(mirror, pad + 2 * (t - 1) - samples, 0)), 0.0)
    v = go * acc
    return v if out is None else out + v


def _check_sizes(operands: dict) -> None:
    """Every operand within the kernels' 32-bit indexing."""
    for name, t in operands.items():
        if t is not None and t.numel() > MAX_ELEMENTS:
            raise ValueError(f"{name} has {t.numel()} elements, more than {MAX_ELEMENTS}")


def stft_frame(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor, hop: int) -> torch.Tensor:
    """The windowed frames of x's rows then y's (2B, F, n) from x, y (B, T)
    and c (n,); the reflect pad needs n/2 < T.  CPU tensors run the plain
    version; float32 CUDA tensors launch the kernel."""
    if x.dim() != 2 or x.shape != y.shape or c.dim() != 1:
        raise ValueError(f"need x, y (B, T) and c (n,); got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(c.shape)}")
    (b, t), n = x.shape, c.shape[0]
    if not (0 < n // 2 < t) or hop < 1:
        raise ValueError(f"need n/2 < T and hop ≥ 1; got n = {n}, T = {t}, hop = {hop}")
    frames = n_frames(t, n, hop)
    operands = {"x": x, "y": y, "c": c}
    kernels.check_operands(operands)
    _check_sizes(operands)
    if 2 * b * frames * n > MAX_ELEMENTS:
        raise ValueError(f"{2 * b * frames * n} frame samples, more than {MAX_ELEMENTS}")
    if x.device.type == "cpu":
        return stft_frame_plain(x, y, c, hop)
    out = torch.empty((2 * b, frames, n), dtype=torch.float32, device=x.device)
    if b > 0:
        kernels.launch("stft_frame", x, y, c, out, b, t, n, hop, frames)
    return out


def stft_loss_grad(spec: torch.Tensor, n: int, partials: torch.Tensor) -> torch.Tensor:
    """The gradient with respect to the reconstruction's spectrum (B, F,
    bins), weighted for the unnormalised C2R, from both spectra spec (2B,
    F, bins = n//2 + 1), the target's rows first; the scale's partial sums
    go into `partials` (loss_blocks(B·F·bins),) float64.  CPU tensors run
    the plain version; complex64 CUDA tensors launch the kernel."""
    count = _check_spec(spec, n)
    if partials.shape != (loss_blocks(count),) or partials.dtype != torch.float64:
        raise ValueError(f"need float64 partials ({loss_blocks(count)},); got {tuple(partials.shape)} "
                         f"{partials.dtype}")
    if partials.device != spec.device or not partials.is_contiguous():
        raise ValueError("partials must be contiguous on the spectrum's device")
    if spec.device.type == "cpu":
        return stft_loss_grad_plain(spec, n, partials)
    grad = torch.empty((spec.shape[0] // 2, *spec.shape[1:]), dtype=spec.dtype, device=spec.device)
    bins = spec.shape[-1]
    if count > 0:
        kernels.launch("stft_loss_grad", spec, grad, partials, count, bins, bins - 1 if n % 2 == 0 else -1,
                       1.0 / count, 1.0 / count, partials.shape[0])
    return grad


def _check_spec(spec: torch.Tensor, n: int) -> int:
    """The bins of one signal of a (2B, F, n//2 + 1) complex spectrum."""
    if spec.dim() != 3 or spec.shape[0] % 2 or spec.shape[-1] != n // 2 + 1 or not spec.is_complex():
        raise ValueError(f"need a complex spec (2B, F, {n // 2 + 1}); got {tuple(spec.shape)} {spec.dtype}")
    kernels.check_operands({"spec": spec}, spectra=True)
    _check_sizes({"spec": spec})
    return spec.numel() // 2


def stft_rave_norms(spec: torch.Tensor, n: int) -> torch.Tensor:
    """The (2, loss_blocks(B·F·bins)) float64 partials of Σ(|S_x| − |S_y|)²
    and Σ|S_x|² of spec (2B, F, bins = n//2 + 1), the target's rows first.
    CPU tensors run the plain version; complex64 CUDA tensors launch the
    kernel."""
    count = _check_spec(spec, n)
    blocks = loss_blocks(count)
    norms = torch.empty((2, blocks), dtype=torch.float64, device=spec.device)
    if spec.device.type == "cpu":
        return stft_rave_norms_plain(spec, norms)
    if count > 0:
        kernels.launch("stft_rave_norms", spec, norms, count, blocks)
    else:
        norms.zero_()
    return norms


def stft_rave_loss_grad(spec: torch.Tensor, n: int, partials: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """RAVE's form of `stft_loss_grad`: the gradient with respect to the
    reconstruction's spectrum (B, F, bins), weighted for the unnormalised
    C2R, and the scale's partial sums (block 0 carrying the relative
    linear term) into `partials`, from spec and its `stft_rave_norms`.
    CPU tensors run the plain version; complex64 CUDA tensors launch the
    kernel."""
    count = _check_spec(spec, n)
    blocks = loss_blocks(count)
    if partials.shape != (blocks,) or partials.dtype != torch.float64 or norms.shape != (2, blocks) \
            or norms.dtype != torch.float64:
        raise ValueError(f"need float64 partials ({blocks},) and norms (2, {blocks}); got "
                         f"{tuple(partials.shape)} {partials.dtype}, {tuple(norms.shape)} {norms.dtype}")
    for name, t in (("partials", partials), ("norms", norms)):
        if t.device != spec.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the spectrum's device")
    if spec.device.type == "cpu":
        return stft_rave_loss_grad_plain(spec, n, partials, norms)
    grad = torch.empty((spec.shape[0] // 2, *spec.shape[1:]), dtype=spec.dtype, device=spec.device)
    bins = spec.shape[-1]
    if count > 0:
        kernels.launch("stft_rave_loss_grad", spec, grad, partials, norms, count, bins,
                       bins - 1 if n % 2 == 0 else -1, 1.0 / count, 1.0 / count, blocks)
    return grad


def stft_loss_sum(partials: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The loss (0-d, `dtype`): every partial summed in one fixed order.
    CPU tensors run the plain version; on the card (float32) the kernel."""
    if partials.dim() != 1 or partials.dtype != torch.float64 or not partials.is_contiguous():
        raise ValueError(f"need contiguous float64 partials (P,); got {tuple(partials.shape)} {partials.dtype}")
    if partials.device.type == "cpu":
        return stft_loss_sum_plain(partials, dtype)
    if dtype != torch.float32:
        raise TypeError(f"the loss is float32 on {partials.device}, got {dtype}")
    loss = torch.empty((), dtype=torch.float32, device=partials.device)
    kernels.launch("stft_loss_sum", partials, partials.shape[0], loss)
    return loss


def stft_overlap_add(gframes: torch.Tensor, c: torch.Tensor, go: torch.Tensor, t: int, hop: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The signal's gradient (B, T) from the frames' gradients gframes (B,
    F, n), c (n,) and the upstream gradient go (0-d), added to `out` where
    given (in place on the card).  CPU tensors run the plain version;
    float32 CUDA tensors launch the kernel."""
    if gframes.dim() != 3 or c.shape != (gframes.shape[2],) or go.dim() != 0:
        raise ValueError(f"need gframes (B, F, n), c (n,), go 0-d; got {tuple(gframes.shape)}, "
                         f"{tuple(c.shape)}, {tuple(go.shape)}")
    b, frames, n = gframes.shape
    if not (0 < n // 2 < t) or hop < 1 or frames != n_frames(t, n, hop):
        raise ValueError(f"need n/2 < T, hop ≥ 1 and {n_frames(t, n, hop) if hop >= 1 else '?'} frames; "
                         f"got n = {n}, T = {t}, hop = {hop}, F = {frames}")
    if out is not None and out.shape != (b, t):
        raise ValueError(f"need out ({b}, {t}); got {tuple(out.shape)}")
    operands = {"gframes": gframes, "c": c, "go": go, "out": out}
    kernels.check_operands(operands)
    _check_sizes(operands)
    if gframes.device.type == "cpu":
        return stft_overlap_add_plain(gframes, c, go, t, hop, out)
    accumulate = out is not None
    if out is None:
        out = torch.empty((b, t), dtype=torch.float32, device=gframes.device)
    if b > 0:
        kernels.launch("stft_overlap_add", gframes, c, go, out, b, t, n, hop, frames, int(accumulate))
    return out


FORMS = ("ddsp", "rave")


class MultiscaleSpectralLoss(torch.autograd.Function):
    """Σ_scales mean|S_x − S_y| + mean|log(S_x + ε) − log(S_y + ε)| of the
    centred, Hann-windowed, n^-1/2-normalised magnitude STFTs of target x
    and reconstruction y (..., T), as training/loss.py
    `spectral_loss_from_signals` computes it; with `form` "rave" the
    linear term is ‖S_x − S_y‖ / ‖S_x‖ (training/loss.py
    `rave_distance_plain`).  Forward: frame, R2C and the loss-and-gradient
    pass(es) for each scale, one sum; it saves each scale's gradient
    spectrum.  Backward: C2R and overlap-add for each scale, times the
    upstream gradient.  The target gets no gradient."""

    @staticmethod
    def forward(ctx, target, reconstruction, scales: Sequence[int], overlap: float, form: str = "ddsp"):
        t = reconstruction.shape[-1]
        x = target.reshape(-1, t).contiguous()
        y = reconstruction.reshape(-1, t).contiguous()
        b = y.shape[0]
        plan = []
        for n in scales:
            hop = hop_length(n, overlap)
            if hop < 1:
                raise ValueError(f"scale {n} at overlap {overlap} has no hop")
            plan.append((n, hop, loss_blocks(b * n_frames(t, n, hop) * (n // 2 + 1))))
        partials = torch.empty(sum(p[2] for p in plan), dtype=torch.float64, device=y.device)
        grads, at = [], 0
        for n, hop, blocks in plan:
            c = window_constant(n, y.dtype, y.device)
            spec = torch.fft.rfft(stft_frame(x, y, c, hop), dim=-1)
            if form == "rave":
                grads.append(stft_rave_loss_grad(spec, n, partials[at:at + blocks], stft_rave_norms(spec, n)))
            else:
                grads.append(stft_loss_grad(spec, n, partials[at:at + blocks]))
            at += blocks
        ctx.save_for_backward(*grads)
        ctx.plan, ctx.shape, ctx.dtype = plan, reconstruction.shape, y.dtype
        return stft_loss_sum(partials, y.dtype)

    @staticmethod
    def backward(ctx, grad_loss):
        go = grad_loss.contiguous()
        t = ctx.shape[-1]
        out = None
        for (n, hop, _), g in zip(ctx.plan, ctx.saved_tensors):
            gframes = torch.fft.irfft(g, n=n, dim=-1, norm="forward")
            out = stft_overlap_add(gframes, window_constant(n, ctx.dtype, g.device), go, t, hop, out)
        return None, out.reshape(ctx.shape), None, None, None


def multiscale_spectral_loss(target: torch.Tensor, reconstruction: torch.Tensor, scales: Sequence[int],
                             overlap: float, form: str = "ddsp") -> torch.Tensor:
    """The loss (0-d) through `MultiscaleSpectralLoss`: target and
    reconstruction (..., T) of one shape and type, float32 on the card or
    float32/float64 on the CPU; `form` "ddsp" or "rave"."""
    if target.shape != reconstruction.shape:
        raise ValueError(f"target {tuple(target.shape)} and reconstruction {tuple(reconstruction.shape)} differ")
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return MultiscaleSpectralLoss.apply(target, reconstruction, tuple(scales), overlap, form)
