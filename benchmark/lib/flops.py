"""Operations and bytes from shapes, and the card's published peaks.

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 67 TFLOP/s in float32
outside the tensor cores (the program's products run in float32 with TF32
off), 3.35 TB/s of HBM3.  A real FFT of N points is counted as
2.5·N·log2(N) operations, half of the complex transform's 5·N·log2(N).
"""

from __future__ import annotations

import math

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
N_MFCC, Z_DIM = 30, 16


def bound_s(nbytes: float, flops: float):
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def oscillator_fwd_cost(rows: int, k: int, s: int):
    """(bytes, flops) of the forward bank: φ, ω and the K amplitudes read
    once, the (rows, S) audio written once; two FMAs per harmonic per
    sample (the recurrence and the accumulation)."""
    return 4 * rows * (2 + k) + 4 * rows * s, 4 * rows * s * k


def oscillator_bwd_cost(rows: int, k: int, s: int):
    """(bytes, flops) of the backward: φ, ω, A and the (rows, S) cotangent
    read once, dφ, dω, dA written once; the sine and cosine recurrences,
    the dA product and the dθ FMA, 8 flops per harmonic per sample."""
    return 4 * rows * (s + 2 * k + 4), 8 * rows * s * k


def rfft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def dense_flops(fan_in: int, fan_out: int) -> int:
    return 2 * fan_in * fan_out


def nn_flops_per_frame(model: dict) -> int:
    """Forward GEMM operations of the frame-rate NN for one frame: every
    dense layer, both GRU projections (all three gates), the two output
    projections; the encoder's where the model has one."""
    h, k, nb = model["hidden_size"], model["n_harmonic"], model["n_bands"]
    ae = model["name"] == "mfcc-autoencoder"

    def mlp(fan_in):
        return dense_flops(fan_in, h) + 2 * dense_flops(h, h)

    total = mlp(1) + mlp(1) + mlp(h + 2)
    total += dense_flops((3 if ae else 2) * h, 3 * h) + dense_flops(h, 3 * h)
    total += dense_flops(h, k + 1) + dense_flops(h, nb)
    if ae:
        total += mlp(Z_DIM)
        total += dense_flops(N_MFCC, 3 * h) + dense_flops(h, 3 * h) + dense_flops(h, Z_DIM)
    return total


def noise_fft_flops_per_frame(model: dict, backward: bool) -> float:
    """The FIR's design (one irfft of the bands) and the block's linear
    convolution by FFTs of 2·block: two transforms and one inverse forward,
    one transform and one inverse more backward (the noise is data)."""
    s, nb = model["block_size"], model["n_bands"]
    design = rfft_flops(2 * (nb - 1))
    conv = rfft_flops(2 * s)
    forward = design + 3 * conv
    return forward + (design + 2 * conv if backward else 0.0)


def train_step_flops(cfg: dict) -> dict:
    """Operations of one optimizer step at the configuration's batch and
    length, by part; recomputation is not counted."""
    m, tc, pre = cfg["model"], cfg["train"], cfg["preprocess"]
    b, t, s, k = tc["batch"], pre["signal_length"], m["block_size"], m["n_harmonic"]
    rows = b * (t // s)
    parts = {"nn": 3 * nn_flops_per_frame(m) * rows}
    parts["oscillator"] = oscillator_fwd_cost(rows, k, s)[1] + oscillator_bwd_cost(rows, k, s)[1]
    stft = 0.0
    for n in tc["scales"]:
        hop = int(n * (1 - tc["overlap"]))
        stft += (1 + t // hop) * rfft_flops(n)
    parts["loss_stft"] = 3 * b * stft  # target and reconstruction forward, reconstruction backward
    parts["noise_fft"] = noise_fft_flops_per_frame(m, backward=True) * rows
    if m["has_reverb"]:
        parts["reverb_fft"] = (4 * b + 2) * rfft_flops(2 * t)
    return parts

