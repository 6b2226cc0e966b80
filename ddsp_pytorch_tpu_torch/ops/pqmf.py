"""Pseudo-quadrature mirror filter bank: RAVE v1's multiband front end
(acids-ircam/RAVE v1, rave/pqmf.py, the classic, non-polyphase form).

The prototype h is a Kaiser-window lowpass at `ATTENUATION` dB: its length
and β from Kaiser's order formula at a transition width of wc/π (the
length made odd), h the windowed sinc of cutoff wc, unscaled (scipy's
`firwin(N, wc, window=('kaiser', β), scale=False, nyq=π)`).  wc minimises
RAVE's `loss_wc`, the largest |(h ∗ h reversed)[centre + 2M·k]| over k ≥ 1.
The bank is hₖ[n] = 2·h[n]·cos((2k+1)·π/(2M)·(n − (N−1)/2) + (−1)ᵏ·π/4).

  analysis   each band the crop convolved (cross-correlated, as conv1d)
             with hₖ, centred pad N//2, every M-th sample kept; then
             `reverse_half`: the even-indexed samples of the odd bands
             negated
  synthesis  `reverse_half` undone, each band upsampled by M with zeros
             and times M, convolved with the flipped hₖ (centred pad),
             summed over the bands

Departures from RAVE: the port has no scipy, so the design is written in
numpy (`kaiser_order`, `np.kaiser`, the sinc) and wc is found by a
deterministic 1-D search (`search_wc`: a grid, then golden-section inside
the best grid cell) in place of scipy's Nelder-Mead `fmin` from 1/M; at M
= 16 both land at wc ≈ 0.1075 and N = 377.  The bank keeps its odd length
N (RAVE pads it to the next power of two, which moves its polyphase
output by whole samples), so analysis gives T/M samples a band and
synthesis T.  On the card the synthesis runs as one transposed
convolution of stride M (the same sums without the zeros); the plain
zero-stuffed form is `synthesis_plain`, the definition.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ATTENUATION = 100.0  # dB, RAVE's PQMF(100, n_band)
GRID = 2001  # points of search_wc's grid over [0.5/M, 3/M]
GOLDEN_STEPS = 80


def kaiser_order(attenuation: float, width: float) -> Tuple[int, float]:
    """(taps, β) of Kaiser's order formula (scipy.signal.kaiserord) for a
    stopband of `attenuation` dB and a transition `width` in units of the
    Nyquist frequency."""
    a = abs(attenuation)
    if a > 50:
        beta = 0.1102 * (a - 8.7)
    elif a > 21:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    taps = (a - 7.95) / 2.285 / (math.pi * width) + 1
    return int(math.ceil(taps)), beta


def kaiser_filter(wc: float, attenuation: float = ATTENUATION, n: Optional[int] = None) -> np.ndarray:
    """The prototype of cutoff wc (rad/sample): RAVE's `kaiser_filter`, its
    length from Kaiser's formula made odd unless `n` is given; float64."""
    n_, beta = kaiser_order(attenuation, wc / math.pi)
    n = 2 * (n_ // 2) + 1 if n is None else n
    m = np.arange(n) - 0.5 * (n - 1)
    cutoff = wc / math.pi
    return cutoff * np.sinc(cutoff * m) * np.kaiser(n, beta)


def loss_wc(wc: float, attenuation: float, m: int, n: Optional[int] = None) -> float:
    """RAVE's `loss_wc`: the largest |(h ∗ h reversed)[centre + 2M·k]|, k ≥ 1."""
    h = kaiser_filter(wc, attenuation, n)
    g = np.convolve(h, h[::-1], "full")
    return float(np.max(np.abs(g[g.shape[-1] // 2::2 * m][1:])))


def search_wc(attenuation: float, m: int, n: Optional[int] = None) -> float:
    """wc minimising `loss_wc`: the best of GRID points over [0.5/M, 3/M],
    then GOLDEN_STEPS golden-section steps between its neighbours."""
    grid = np.linspace(0.5 / m, 3.0 / m, GRID)
    losses = [loss_wc(float(w), attenuation, m, n) for w in grid]
    i = int(np.argmin(losses))
    lo, hi = float(grid[max(i - 1, 0)]), float(grid[min(i + 1, GRID - 1)])
    ratio = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = hi - ratio * (hi - lo), lo + ratio * (hi - lo)
    fc, fd = loss_wc(c, attenuation, m, n), loss_wc(d, attenuation, m, n)
    for _ in range(GOLDEN_STEPS):
        if fc <= fd:
            hi, d, fd = d, c, fc
            c = hi - ratio * (hi - lo)
            fc = loss_wc(c, attenuation, m, n)
        else:
            lo, c, fc = c, d, fd
            d = lo + ratio * (hi - lo)
            fd = loss_wc(d, attenuation, m, n)
    best = min((losses[i], float(grid[i])), (fc, c), (fd, d))
    return best[1]


@functools.lru_cache(maxsize=None)
def prototype(m: int, attenuation: float = ATTENUATION) -> Tuple[np.ndarray, float]:
    """(h (N,), wc) of an M-band bank, float64.  Read-only: callers share
    the cached array."""
    wc = search_wc(attenuation, m)
    h = kaiser_filter(wc, attenuation)
    h.flags.writeable = False
    return h, wc


@functools.lru_cache(maxsize=None)
def qmf_bank(m: int, attenuation: float = ATTENUATION) -> np.ndarray:
    """The bank (M, N) of `prototype(m)`, float64.  Read-only."""
    bank = modulate(prototype(m, attenuation)[0], m)
    bank.flags.writeable = False
    return bank


def modulate(h: np.ndarray, m: int) -> np.ndarray:
    """The M-band bank (M, N) of prototype h: hₖ[n] = 2·h[n]·cos((2k+1)·
    π/(2M)·(n − (N−1)/2) + (−1)ᵏ·π/4)."""
    k = np.arange(m)[:, None]
    t = np.arange(h.shape[0])[None, :] - (h.shape[0] - 1) / 2
    return 2.0 * h[None, :] * np.cos((2 * k + 1) * math.pi / (2 * m) * t + (-1.0) ** k * math.pi / 4)


def reverse_half(x: torch.Tensor) -> torch.Tensor:
    """RAVE's `reverse_half` of (..., M, L): the even-indexed samples of
    the odd bands negated (its own inverse)."""
    mask = torch.ones(x.shape[-2:], dtype=x.dtype, device=x.device)
    mask[1::2, ::2] = -1.0
    return x * mask


class PQMF(torch.nn.Module):
    """The M-band bank as a module: `analysis` (B, T) or (B, 1, T) → (B,
    M, T/M), `synthesis` (B, M, L) → (B, 1, L·M).  The bank is a float64
    buffer, rounded once to the signal's type at each use."""

    def __init__(self, n_band: int, attenuation: float = ATTENUATION):
        super().__init__()
        self.register_buffer("bank", torch.tensor(qmf_bank(n_band, attenuation)), persistent=False)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None]
        m, n = self.bank.shape
        if x.shape[-1] % m:
            raise ValueError(f"a crop of {x.shape[-1]} samples does not split into {m} bands")
        return reverse_half(F.conv1d(x, self.bank.to(x.dtype)[:, None], stride=m, padding=n // 2))

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        m, n = self.bank.shape
        return F.conv_transpose1d(reverse_half(x) * m, self.bank.to(x.dtype)[:, None], stride=m,
                                  padding=n // 2, output_padding=m - 1)


def synthesis_plain(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """The definition of the synthesis: (B, M, L) → (B, 1, L·M) through the
    zero-stuffed upsampling and a convolution with the flipped bank."""
    m, n = bank.shape
    y = reverse_half(x)
    up = torch.zeros((*y.shape[:2], m * y.shape[-1]), dtype=y.dtype, device=y.device)
    up[..., ::m] = y * m
    return F.conv1d(up, bank.flip(-1)[None].to(y.dtype), padding=n // 2)
