"""Utilities of the port (port of ddsp_pytorch_tpu.utils, the part export
needs)."""

from ddsp_pytorch_tpu_torch.utils.audio_io import save_wav  # noqa: F401
