"""Roofline probes: the card's FP32 FMA and accurate-sin ceilings.

Port of the two Pallas kernels inside
scripts/bench_roofline.py::measure_vpu_rates_pallas (`fma_kernel`,
`:229-242`, and `sin_kernel`, `:244-258`).  Each is an elementwise chain on
a float32 tensor:

  fma:  s = x; c = 1 + s·1e-9; p = 0.9·s; acc = 0.5·s; then FMA_DEPTH times
        (s, p) = (c·s − p, s), acc = acc + c·p; returns acc
  sin:  y_j = sin(x + 0.1·(j+1)), j < CHAINS, then SIN_DEPTH − 1 more
        nested sins each; folded as out = 0.5·out + 0.0625·y_j

`fma_chain` and `sin_chain` are the dispatch points: a CPU tensor runs the
plain PyTorch version (`*_plain`, the same arithmetic), a CUDA tensor
launches the hand-written kernel `ops/kernels/roofline_probe.cu`, one
thread an element in blocks of `threads`, counted as `roofline_fma` or
`roofline_sin` (ops/kernels).  Nothing falls back.  Only the roofline
measurement (`bench_roofline.py`) calls them; no serving or training path
does.
"""

from __future__ import annotations

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.ops import kernels

# bench_roofline.py:222-223: the Pallas grid of GRID tiles of ROWS × COLS
ROWS, COLS, GRID = 32, 512, 256
FMA_DEPTH, CHAINS, SIN_DEPTH = 256, 8, 4
FMA_PER_ELEMENT = 2 * FMA_DEPTH + 3  # as the script counts them (:295)
SIN_PER_ELEMENT = CHAINS * SIN_DEPTH
# the sin probe's other FP32 instructions: CHAINS adds, and a multiply and
# an add for each of the CHAINS − 1 folds
SIN_OTHER_PER_ELEMENT = CHAINS + 2 * (CHAINS - 1)
# Block sizes bench_roofline.py sweeps; each probe launches by default in
# the one that measured fastest on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6).
BLOCK_SIZES = (128, 256, 512, 1024)
FMA_THREADS, SIN_THREADS = 1024, 256


def probe_input(seed: int = 0, rows: int = GRID * ROWS, cols: int = COLS, device="cpu"):
    """The script's input: uniform in [0.1, 1), float32 (:227-228)."""
    x = np.random.default_rng(seed).uniform(0.1, 1.0, (rows, cols)).astype(np.float32)
    return torch.tensor(x, device=device)


def fma_chain_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fma probe (any float type)."""
    s = x
    c = 1.0 + s * 1e-9
    p = s * 0.9
    acc = s * 0.5
    for _ in range(FMA_DEPTH):
        s, p = c * s - p, s
        acc = acc + c * p
    return acc


def sin_chain_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the sin probe (any float type)."""
    ys = [torch.sin(x + 0.1 * (j + 1)) for j in range(CHAINS)]
    for _ in range(SIN_DEPTH - 1):
        ys = [torch.sin(y) for y in ys]
    out = ys[0]
    for y in ys[1:]:
        out = out * 0.5 + y * 0.0625
    return out


def _probe(x: torch.Tensor, kind: int, threads: int, plain) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the probe kernels take a contiguous float32 tensor")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads a block must be a multiple of 32 in [32, 1024], got {threads}")
    n = x.numel()
    if n >= 2**31:
        raise ValueError(f"the probe kernels take fewer than 2^31 elements, got {n}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    kernels.launch(("roofline_fma", "roofline_sin")[kind], x, out, n, kind, threads)
    return out


def fma_chain(x: torch.Tensor, threads: int = FMA_THREADS) -> torch.Tensor:
    """The fma probe on any shape: a CPU tensor (float32 or float64) runs
    the plain version; a contiguous float32 CUDA tensor launches the kernel
    in blocks of `threads`, counted as `roofline_fma`."""
    return _probe(x, 0, threads, fma_chain_plain)


def sin_chain(x: torch.Tensor, threads: int = SIN_THREADS) -> torch.Tensor:
    """The sin probe: as `fma_chain`, counted as `roofline_sin`."""
    return _probe(x, 1, threads, sin_chain_plain)
