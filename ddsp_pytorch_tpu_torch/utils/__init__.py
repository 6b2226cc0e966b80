"""Utilities of the port (port of ddsp_pytorch_tpu.utils: wav IO)."""

from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav, resample_poly, save_wav  # noqa: F401
