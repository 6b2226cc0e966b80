"""Timbre-transfer CLI of the port (the counterpart of the repository's
transfer.py):

    python -m ddsp_pytorch_tpu_torch.transfer --bundle pretrained/ddsp_sigmund_bundle \\
        --input voice.wav --output out.wav [--octave-shift 1] [--loudness-shift 0] \\
        [--no-reverb] [--device cuda]

Reads the input wav at the bundle's sample rate (utils/audio_io.load_wav,
resampling if needed), re-renders it through the bundle
(inference.timbre_transfer: the bundle's pitch tracker, loudness, the
model, its reverb) and writes 16-bit mono PCM.  Runs on the GPU by
default; there is no fallback: pass --device cpu for the plain PyTorch
path.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.inference import timbre_transfer
    from ddsp_pytorch_tpu_torch.utils import load_wav, save_wav

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bundle", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--octave-shift", type=float, default=0.0)
    p.add_argument("--loudness-shift", type=float, default=0.0)
    p.add_argument("--no-reverb", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not os.path.exists(os.path.join(args.bundle, "config.yaml")):
        p.error(f"not an exported bundle (no config.yaml): {args.bundle}")
    sr = Config.from_yaml(os.path.join(args.bundle, "config.yaml")).preprocess.sample_rate
    audio, _ = load_wav(args.input, sr)
    out = timbre_transfer(args.bundle, audio, sr, octave_shift=args.octave_shift,
                          loudness_shift=args.loudness_shift, include_reverb=not args.no_reverb,
                          device=args.device)
    save_wav(args.output, out, sr)
    print(f"wrote {args.output} ({len(out) / sr:.2f}s at {sr} Hz)")
    return args.output


if __name__ == "__main__":
    main()
