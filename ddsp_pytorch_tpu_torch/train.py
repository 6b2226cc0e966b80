"""Training CLI of the port (the counterpart of the repository's train.py):

    python -m ddsp_pytorch_tpu_torch.train --config configs/config.yaml \\
        --name myrun [--root runs] [--steps N] [--batch B] [--lr LR] \\
        [--set key.path=value ...] [--device cuda]

Loads the YAML config, builds the model by registry name, computes the
dataset's loudness stats and runs the one-device Trainer on the feature
cache at preprocess.out_dir (`train/` and `validation/`).  Resumes from the
newest checkpoint in <root>/<name>.  The device defaults to the GPU and
there is no fallback: pass --device cpu for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.data import Datamodule
    from ddsp_pytorch_tpu_torch.training import Trainer

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--name", default="debug")
    p.add_argument("--root", default="runs")
    p.add_argument("--steps", type=int, default=None, help="override train.steps")
    p.add_argument("--batch", type=int, default=None, help="override train.batch")
    p.add_argument("--lr", type=float, default=None, help="override train.lr")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY.PATH=VALUE", dest="overrides",
        help="override any config field (dotted path, YAML scalar value; repeatable)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    cfg.apply_overrides(args.overrides)
    if args.steps is not None:
        cfg.train.steps = args.steps
    if args.batch is not None:
        cfg.train.batch = args.batch
    if args.lr is not None:
        cfg.train.lr = args.lr
    run_dir = os.path.join(args.root, args.name)
    trainer = Trainer(cfg, run_dir, device=args.device)
    datamodule = Datamodule(cfg)
    datamodule.setup()
    try:
        state = trainer.fit(datamodule)
    finally:
        trainer.close()
    print(f"trained to step {state.step}; run directory {run_dir}")
    return state


if __name__ == "__main__":
    main()
