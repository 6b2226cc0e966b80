"""Unit conversions (port of ddsp_pytorch_tpu/utils/units.py, the
reference's utils.py:41-53)."""

import numpy as np
import torch


def hz_to_midi(freqs):
    return 12.0 * np.log2(np.asarray(freqs) / 440.0) + 69.0


def midi_to_hz(midi):
    return 440.0 * 2.0 ** ((np.asarray(midi) - 69.0) / 12.0)


def tonp(x):
    """A tensor on any device (or anything array-like) → numpy, as the
    reference's tensor.detach().cpu().numpy()."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
