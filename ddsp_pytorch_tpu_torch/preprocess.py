"""Preprocessing CLI of the port (the counterpart of the repository's
preprocess.py):

    python -m ddsp_pytorch_tpu_torch.preprocess --config configs/config.yaml \\
        [--partition train] [--set key.path=value ...] [--device cuda]
    python -m ddsp_pytorch_tpu_torch.preprocess --config CFG --from-sigmund WAV [--partition P]

Processes the `train` and `validation` partitions under data.data_location
into the .npy feature cache at preprocess.out_dir, with the pitch tracker of
preprocess.pitch_tracker (hybrid, the default, crepe or yin).  The
features are extracted on the GPU by default; there is no fallback: pass
--device cpu for the plain PyTorch path.  A config whose model trains on
raw crops (configs/rave_v1.yaml) gets the crops alone (signals.npy), no
feature extracted.  --from-sigmund instead ingests a
Pd-recorded 3-channel PCM wav (audio, pitch, loudness; data/sigmund.py)
into preprocess.out_dir[/P], on the host.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.data.preprocess import preprocess_folder
    from ddsp_pytorch_tpu_torch.data.sigmund import preprocess_from_sigmund
    from ddsp_pytorch_tpu_torch.models import MODEL_REGISTRY

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--from-sigmund", default=None, metavar="WAV")
    p.add_argument("--partition", default=None,
                   help="process only this partition (default: train and validation)")
    p.add_argument("--set", action="append", default=[], dest="overrides", metavar="KEY.PATH=VALUE",
                   help="override any config field (dotted path, YAML scalar value; repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    config = Config.from_yaml(args.config)
    config.apply_overrides(args.overrides)
    if args.from_sigmund:
        preprocess_from_sigmund(args.from_sigmund, config, args.partition)
        return
    features = MODEL_REGISTRY[config.model.name].needs_features
    for partition in (args.partition,) if args.partition else ("train", "validation"):
        preprocess_folder(config.data.data_location, partition, config, device=args.device, features=features)


if __name__ == "__main__":
    main()
