"""L0 — DSP functional core on torch tensors (port of ddsp_pytorch_tpu.ops:
every name ddsp_pytorch_tpu/ops/__init__.py exports, plus the kernels'
dispatch points)."""

from ddsp_pytorch_tpu_torch.ops.core import (  # noqa: F401
    mean_std_loudness,
    remove_above_nyquist,
    resample,
    safe_log,
    scale_function,
    upsample,
)
from ddsp_pytorch_tpu_torch.ops.filters import (  # noqa: F401
    amp_to_impulse_response,
    fft_convolve,
    filtered_noise,
    uniform_noise,
)
from ddsp_pytorch_tpu_torch.ops.loudness import a_weighting, extract_loudness, fft_frequencies  # noqa: F401
from ddsp_pytorch_tpu_torch.ops.oscillator import (  # noqa: F401
    OscillatorBank,
    harmonic_synth,
    harmonic_synth_frames,
    oscillator_bank,
    oscillator_bank_bwd,
    oscillator_bank_bwd_plain,
    oscillator_bank_plain,
    phase_accumulate_frames,
)
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch  # noqa: F401
from ddsp_pytorch_tpu_torch.ops.spectral import (  # noqa: F401
    amplitude_to_db,
    dct_matrix,
    frame_signal,
    hann_window,
    mel_filterbank,
    mfcc,
    multiscale_fft,
    power_to_db,
    stft,
    stft_to_mel,
)
