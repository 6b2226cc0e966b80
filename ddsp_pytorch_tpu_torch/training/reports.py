"""The reconstruction report: a 2 × 3 diagnostic figure of an eval step's
outputs (port of ddsp_pytorch_tpu/training/reports.py): the mel
spectrograms of the target and the reconstruction at the middle loss
scale, the f0 and loudness tracks, and the noise magnitudes and harmonic
distribution over the frames."""

from __future__ import annotations

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.ops.spectral import stft_to_mel
from ddsp_pytorch_tpu_torch.utils.plots import plot_f0, plot_loudness, plot_spec, pyplot


def _host(x) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reconstruction_report(output: dict, config, index: int = 0):
    """The figure of an eval-step output dict (ImportError without
    matplotlib)."""
    plt = pyplot()
    fig, axes = plt.subplots(nrows=2, ncols=3, figsize=(12, 5))

    scales = config.train.scales
    sr = config.preprocess.sample_rate
    scale_idx = len(scales) // 2
    n_fft = scales[scale_idx]

    ori = torch.as_tensor(_host(output["sig_stft"][scale_idx][index]))
    rec = torch.as_tensor(_host(output["rec_stft"][scale_idx][index]))
    axes[0][0].set_title("Original")
    plot_spec(stft_to_mel(ori, sr, n_fft).numpy(), axes[0][0])
    axes[1][0].set_title("Reconstruction")
    plot_spec(stft_to_mel(rec, sr, n_fft).numpy(), axes[1][0])

    plot_f0(axes[0][1], _host(output["f0"]), index)
    plot_loudness(axes[1][1], _host(output["loudness"]), index)

    noise_mags = _host(output["noise_ctrls"]["magnitudes"][index]).T
    axes[0][2].set_title("noise magnitude")
    axes[0][2].set_xlabel("frames")
    axes[0][2].set_ylabel("frequency bin")
    plot_spec(noise_mags, axes[0][2])

    harm = _host(output["harmonic_ctrls"]["harmonic_distribution"][index]).T
    axes[1][2].set_title("harmonic distribution")
    axes[1][2].set_xlabel("frames")
    axes[1][2].set_ylabel("harmonic number")
    plot_spec(harm, axes[1][2])

    fig.suptitle("reconstruction report")
    fig.tight_layout()
    return fig
