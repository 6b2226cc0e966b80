"""Utilities of the port (port of ddsp_pytorch_tpu.utils: units, wav IO
and the diagnostic plots)."""

from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav, resample_poly, save_wav  # noqa: F401
from ddsp_pytorch_tpu_torch.utils.plots import plot_f0, plot_loudness, plot_sig, plot_spec  # noqa: F401
from ddsp_pytorch_tpu_torch.utils.units import hz_to_midi, midi_to_hz, tonp  # noqa: F401
