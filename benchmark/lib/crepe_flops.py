"""Operations and bytes of CREPE's training step, from shapes.

The products are the six convolutions and the classifier (a dense layer:
a width-1 convolution over one position), each run forward, for its
input's gradient (none for conv1, whose input needs none) and for its
weight's gradient: 2 · B · C_out · C_in · width · L_out operations each,
as torch's FlopCounterMode counts a convolution.  Bytes, float32 (4 a
value), each tensor an operator reads counted once and each it writes
once: forward the padded input, the kernel and the output; input gradient
the output's gradient, the kernel and the input's gradient; weight
gradient the padded input and the output's gradient read, the kernel's
and the bias's gradients written (the bias's reduction runs inside the
same operator).  The synthesis's FFTs are counted as lib/flops.py counts
a real FFT; the elementwise passes (ReLU, BatchNorm, pooling, dropout,
Adam) are not counted.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.lib.flops import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, rfft_flops

FRAME_LENGTH = 1024
N_BINS = 360
F32 = 4
# the host operators whose kernels the products' bound covers
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def layers(model: dict) -> List[Tuple[str, int, int, int, int, int, int]]:
    """(name, C_in, C_out, width, padded input length, output length, has
    an input gradient) of each product, in forward order."""
    out, c_in, length = [], 1, FRAME_LENGTH
    for i, (c, w, s) in enumerate(zip(model["filters"], model["widths"], model["strides"])):
        l_out = -(-length // s)
        padded = max((l_out - 1) * s + w, length)
        out.append((f"conv{i + 1}", c_in, c, w, padded, l_out, int(i > 0)))
        c_in, length = c, l_out // 2
    out.append(("classifier", c_in * length, N_BINS, 1, 1, 1, 1))
    return out


def conv_costs(model: dict, batch: int) -> List[Tuple[str, float, float]]:
    """(label, operations, bytes) of each product operator of one step."""
    out = []
    for name, c_in, c_out, w, padded, l_out, dgrad in layers(model):
        ops = 2.0 * batch * c_out * c_in * w * l_out
        x, y, k = batch * c_in * padded * F32, batch * c_out * l_out * F32, c_out * c_in * w * F32
        out.append((f"{name}.forward", ops, x + k + c_out * F32 + y))
        if dgrad:
            out.append((f"{name}.input_grad", ops, y + k + x))
        out.append((f"{name}.weight_grad", ops, x + y + k + c_out * F32))
    return out


def conv_bound_s(model: dict, batch: int) -> float:
    """The least time of one step's product operators: each operator's
    larger of operations at the float32 peak and bytes at HBM's, summed."""
    return sum(max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
               for _, ops, nbytes in conv_costs(model, batch))


def synth_flops(batch: int, robust: bool) -> float:
    """The synthesis's FFTs of one batch: the room's convolution (two
    transforms and an inverse) and the pink noise (one and an inverse)."""
    return batch * (5 if robust else 0) * rfft_flops(FRAME_LENGTH)


def train_step_flops(cfg: dict) -> dict:
    """Operations of one training step at the configuration's batch, by
    part."""
    m, tc = cfg["model"], cfg["train"]
    return {"products": sum(ops for _, ops, _ in conv_costs(m, tc["batch"])),
            "synth_fft": synth_flops(tc["batch"], tc["robust"])}
