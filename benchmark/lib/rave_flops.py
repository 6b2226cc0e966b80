"""Operations and bytes of RAVE v1's phase-1 training step, from shapes.

The products are the step's convolutions: the bank's analysis of the crop
(forward only: neither the crop nor the bank takes a gradient) and its two
syntheses (the target's forward; the reconstruction's forward and input
gradient), the encoder's six and the generator's 31 (phase 1 runs no noise
branch), each forward, for its input's gradient (none for the encoder's
first, whose input is the bands) and for its weight's gradient: 2 · B ·
C_out · (C_in / groups) · width · L_out operations each for a convolution,
2 · B · C_in · C_out · width · L_in for a transposed one (each input
sample scattered over `width` outputs), as torch's FlopCounterMode counts
them.  Bytes, float32 (4 a value), each tensor an operator reads counted
once and each it writes once: forward the input, the kernel and the
output; input gradient the output's gradient, the kernel and the input's
gradient; weight gradient the input and the output's gradient read, the
kernel's and the bias's gradients written.  The loss's transforms are
counted as lib/flops.py counts a real FFT (framing, the R2C of target and
reconstruction, the C2R of the gradient); the elementwise passes
(LeakyReLU, BatchNorm, weight norm, the loss's own passes, Adam) are not.

The loss's hand-written passes of RAVE's form (ops/kernels/stft_loss.cu
`stft_rave_norms_kernel`, `stft_rave_loss_grad_kernel`) are bound by
bytes: `rave_loss_bytes` counts what they read and write a step.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.lib.flops import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, rfft_flops

F32, C64, F64 = 4, 8, 8
# the host operators whose kernels the products' bound covers
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose", "aten::convolution_backward")
# the hand-written kernels of RAVE's form of the loss, by name
LOSS_KERNELS = ("stft_rave_norms_kernel", "stft_rave_loss_grad_kernel")
LOSS_THREADS, LOSS_MAX_BLOCKS = 256, 1056  # ops/stft_loss.py's grid of the loss passes


def layers(model: dict, samples: int) -> List[Tuple[str, int, int, int, int, int, int, bool, bool, bool]]:
    """(name, C_in, C_out, width, stride, groups, input length, transposed,
    input gradient, weight gradient) of each convolution of a phase-1 step
    over crops of `samples`, in forward order.  The bank's length is the
    configuration's `pqmf_taps` (the prototype the program designs)."""
    m, c, lat, ratios = model["n_band"], model["capacity"], model["latent_size"], model["ratios"]
    taps, length = int(model["pqmf_taps"]), samples // m
    out = [("pqmf.analysis", 1, m, taps, m, 1, samples, False, False, False),
           ("encoder.conv_in", m, c, 7, 1, 1, length, False, False, True)]
    dims = [c * 2**i for i in range(len(ratios) + 1)]
    for i, r in enumerate(ratios):
        out.append((f"encoder.convs.{i}", dims[i], dims[i + 1], 2 * r + 1, r, 1, length, False, True, True))
        length //= r
    out.append(("encoder.conv_out", dims[-1], 2 * lat, 5, 1, 2, length, False, True, True))
    dims = dims[::-1]
    out.append(("decoder.conv_in", lat, dims[0], 7, 1, 1, length, False, True, True))
    for i, r in enumerate(ratios):
        out.append((f"decoder.ups.{i}", dims[i], dims[i + 1], 2 * r, r, 1, length, True, True, True))
        length *= r
        for j in range(3):
            for k in (1, 2):
                out.append((f"decoder.stacks.{i}.{j}.conv{k}", dims[i + 1], dims[i + 1], 3, 1, 1, length, False,
                            True, True))
    stride = model["loud_stride"]
    out.append(("decoder.wave", c, m, 7, 1, 1, length, False, True, True))
    out.append(("decoder.loud", c, 1, 2 * stride + 1, stride, 1, length, False, True, True))
    out.append(("pqmf.synthesis.target", m, 1, taps, m, 1, length, True, False, False))
    out.append(("pqmf.synthesis.reconstruction", m, 1, taps, m, 1, length, True, True, False))
    return out


def conv_costs(model: dict, batch: int, samples: int) -> List[Tuple[str, float, float]]:
    """(label, operations, bytes) of each convolution operator of one step."""
    out = []
    for name, c_in, c_out, w, stride, groups, l_in, transposed, dgrad, wgrad in layers(model, samples):
        l_out = l_in * stride if transposed else l_in // stride
        products = (l_in if transposed else l_out) * w * c_out * (c_in // groups)
        ops = 2.0 * batch * products
        x, y = batch * c_in * l_in * F32, batch * c_out * l_out * F32
        k = c_out * (c_in // groups) * w * F32
        bias = 0 if name.startswith("pqmf") else c_out * F32
        out.append((f"{name}.forward", ops, x + k + bias + y))
        if dgrad:
            out.append((f"{name}.input_grad", ops, y + k + x))
        if wgrad:
            out.append((f"{name}.weight_grad", ops, x + y + k + bias))
    return out


def conv_bound_s(model: dict, batch: int, samples: int) -> float:
    """The least time of one step's convolution operators: each operator's
    larger of operations at the float32 peak and bytes at HBM's, summed."""
    return sum(max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
               for _, ops, nbytes in conv_costs(model, batch, samples))


def loss_rows(model: dict, batch: int, samples: int) -> List[Tuple[int, int]]:
    """(rows, samples a row) of the two distances' signals: the bands
    (B·M rows of T/M) and the full band (B rows of T)."""
    return [(batch * model["n_band"], samples // model["n_band"]), (batch, samples)]


def n_frames(t: int, n: int, hop: int) -> int:
    return 1 + (t + 2 * (n // 2) - n) // hop


def loss_fft_flops(model: dict, train: dict, batch: int, samples: int) -> float:
    """The two distances' transforms: each scale's R2C of target and
    reconstruction and the C2R of the gradient, a frame each."""
    total = 0.0
    for rows, t in loss_rows(model, batch, samples):
        for n in train["scales"]:
            total += 3 * rows * n_frames(t, n, int(n * (1 - train["overlap"]))) * rfft_flops(n)
    return total


def _blocks(count: int) -> int:
    return max(1, min(-(-count // LOSS_THREADS), LOSS_MAX_BLOCKS))


def rave_loss_bytes(model: dict, train: dict, batch: int, samples: int) -> float:
    """Bytes the two passes of RAVE's form read and write a step: for each
    scale of each distance, the norms pass reads both spectra (complex64)
    and writes two float64 partials a block; the loss-and-gradient pass
    reads both spectra and the norms' partials (counted once, though every
    block reads them), and writes the gradient spectrum and a partial a
    block."""
    total = 0.0
    for rows, t in loss_rows(model, batch, samples):
        for n in train["scales"]:
            count = rows * n_frames(t, n, int(n * (1 - train["overlap"]))) * (n // 2 + 1)
            blocks = _blocks(count)
            total += 2 * count * C64 + 2 * blocks * F64
            total += 2 * count * C64 + 2 * blocks * F64 + count * C64 + blocks * F64
    return total


def train_step_flops(cfg: dict) -> dict:
    """Operations of one phase-1 step at the configuration's batch, by
    part."""
    m, tc = cfg["model"], cfg["train"]
    samples = cfg["preprocess"]["signal_length"]
    costs = conv_costs(m, tc["batch"], samples)
    return {"products": sum(ops for name, ops, _ in costs if not name.startswith("pqmf")),
            "pqmf": sum(ops for name, ops, _ in costs if name.startswith("pqmf")),
            "loss_fft": loss_fft_flops(m, tc, tc["batch"], samples)}


def forward_macs(model: dict, samples: int) -> float:
    """Multiply-accumulates of one crop's forward through the encoder and
    the generator (what the paper's and the configuration's size is
    checked against: ≈ 3.0 G at the published size)."""
    return sum(ops / 2 for name, ops, _ in conv_costs(model, 1, samples)
               if name.endswith(".forward") and not name.startswith("pqmf"))

