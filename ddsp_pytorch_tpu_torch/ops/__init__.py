"""L0 — DSP functional core on torch tensors (port of ddsp_pytorch_tpu.ops,
the part the serving, training and preprocessing paths run)."""

from ddsp_pytorch_tpu_torch.ops.core import (  # noqa: F401
    mean_std_loudness,
    remove_above_nyquist,
    safe_log,
    scale_function,
)
from ddsp_pytorch_tpu_torch.ops.filters import (  # noqa: F401
    amp_to_impulse_response,
    fft_convolve,
    filtered_noise,
    uniform_noise,
)
from ddsp_pytorch_tpu_torch.ops.loudness import extract_loudness  # noqa: F401
from ddsp_pytorch_tpu_torch.ops.oscillator import (  # noqa: F401
    OscillatorBank,
    harmonic_synth_frames,
    oscillator_bank,
    oscillator_bank_bwd,
    oscillator_bank_bwd_plain,
    oscillator_bank_plain,
    phase_accumulate_frames,
)
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch  # noqa: F401
from ddsp_pytorch_tpu_torch.ops.spectral import (  # noqa: F401
    frame_signal,
    hann_window,
    mfcc,
    multiscale_fft,
    stft,
)
