"""Diagnostic plots (port of ddsp_pytorch_tpu/utils/plots.py).

matplotlib is imported when a figure is built, with the Agg backend, so a
headless training process never touches a display; where it is not
installed, `pyplot()` raises ImportError.
"""

from __future__ import annotations

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.ops import spectral
from ddsp_pytorch_tpu_torch.utils.units import hz_to_midi, tonp


def pyplot():
    """matplotlib.pyplot on the Agg backend (ImportError without matplotlib)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_sig(sig, ax, stem: bool = False):
    if stem:
        ax.stem(np.asarray(sig))
    else:
        ax.plot(np.asarray(sig))
    ax.set_xlabel("sample")
    return ax


def amplitude_to_db(mag: np.ndarray) -> np.ndarray:
    """A (bins, frames) magnitude image in dB, in float64: 20·log10 of the
    magnitudes floored at 1e-10, clipped 80 dB below their maximum
    (ops/spectral.py amplitude_to_db)."""
    return spectral.amplitude_to_db(torch.from_numpy(np.asarray(mag, np.float64)), amin=1e-10).numpy()


def plot_spec(stft_mag, ax, amp_to_db: bool = True):
    plt = pyplot()
    mag = np.asarray(stft_mag)
    img = amplitude_to_db(mag) if amp_to_db else mag
    im = ax.imshow(img, aspect="auto")
    plt.gcf().colorbar(im, ax=ax)
    ax.invert_yaxis()
    return ax


def plot_f0(ax, f0, index: int = 0):
    f0 = tonp(f0)[index].squeeze(-1)
    ax.set_title("F0 (MIDI)")
    ax.set_ylim([-1, 128])
    plot_sig(hz_to_midi(f0), ax)


def plot_loudness(ax, loudness, index: int = 0):
    loudness = tonp(loudness)[index].squeeze(-1)
    ax.set_title("Loudness")
    plot_sig(loudness, ax)
