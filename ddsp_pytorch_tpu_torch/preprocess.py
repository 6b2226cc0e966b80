"""Preprocessing CLI of the port (the counterpart of the repository's
preprocess.py):

    python -m ddsp_pytorch_tpu_torch.preprocess --config configs/config.yaml \\
        [--partition train] [--set key.path=value ...] [--device cuda]

Processes the `train` and `validation` partitions under data.data_location
into the .npy feature cache at preprocess.out_dir, with the pitch tracker of
preprocess.pitch_tracker ("yin"; the CREPE trackers are not ported and
raise).  The features are extracted on the GPU by default; there is no
fallback: pass --device cpu for the plain PyTorch path.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.data.preprocess import preprocess_folder

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--partition", default=None,
                   help="process only this partition (default: train and validation)")
    p.add_argument("--set", action="append", default=[], dest="overrides", metavar="KEY.PATH=VALUE",
                   help="override any config field (dotted path, YAML scalar value; repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    config = Config.from_yaml(args.config)
    config.apply_overrides(args.overrides)
    for partition in (args.partition,) if args.partition else ("train", "validation"):
        preprocess_folder(config.data.data_location, partition, config, device=args.device)


if __name__ == "__main__":
    main()
