"""Train and export a bundle on the out-of-family corpus (port of
scripts/train_oof.py):

    python -m ddsp_pytorch_tpu_torch.train_oof --steps 20000 [--model decoder|autoencoder] \\
        [--pitch-tracker yin|crepe|hybrid] [--degrade CONDITION] [--root /tmp/ddsp_oof] \\
        [--out pretrained] [--tag oof] [--set key.path=value ...] [--device cuda]

The whole pipeline a user's recordings go through, on audio the model
cannot reproduce by construction: data/fixtures.py wavs (Karplus-Strong
plucks, FM brass, bowed saws; --degrade passes them through a
fixtures.DEGRADATIONS condition, the truth kept clean) → preprocess_folder
(the --pitch-tracker, A-weighted loudness, MFCCs) → the Trainer at the
reference workload (48 kHz, 4 s chunks, block 512, hidden 512, 64
harmonics, 65 bands, reverb, six scales; the train split on the device)
→ export_run, and the loss trajectory as <out>/<tag>_loss.json in the
layout of pretrained/oof_loss.json.  The corpus and the cache under --root
are made once and reused.  --set overrides the config before anything is
made (the corpus follows preprocess.sample_rate and signal_length).  The
device defaults to the GPU and there is no fallback: --device cpu runs the
plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule
from ddsp_pytorch_tpu_torch.data.fixtures import DEGRADATIONS, make_degrader, make_oof_corpus
from ddsp_pytorch_tpu_torch.data.preprocess import preprocess_folder
from ddsp_pytorch_tpu_torch.export import export_run
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics

SAMPLE_RATE, BLOCK_SIZE, SIGNAL_LENGTH = 48000, 512, 192000


def oof_config(corpus: str, cache: str, args) -> Config:
    """The run's config (train_oof.py:96-150), `args.overrides` applied."""
    autoencoder = args.model == "autoencoder"
    preprocess = {"sample_rate": SAMPLE_RATE, "signal_length": SIGNAL_LENGTH, "block_size": BLOCK_SIZE,
                  "out_dir": cache, "pitch_tracker": args.pitch_tracker}
    if args.pitch_tracker != "yin":
        preprocess["crepe_params"] = args.crepe_params
    if autoencoder:
        # the fixed causal MFCC floor: train-time features equal the stream's
        preprocess["mfcc_ref_db"] = 0.0
    cfg = Config.from_dict({
        "data": {"data_location": corpus},
        "preprocess": preprocess,
        "model": {
            "name": "mfcc-autoencoder" if autoencoder else "single-inst-decoder",
            "kwargs": {"hidden_size": 512, "n_harmonic": 64, "n_bands": 65, "sample_rate": SAMPLE_RATE,
                       "block_size": BLOCK_SIZE, "has_reverb": True},
        },
        "train": {
            "scales": [4096, 2048, 1024, 512, 256, 128],
            "overlap": 0.75,
            "batch": args.batch,
            "lr": 1e-3,
            "steps": args.steps,
            "steps_per_call": args.steps_per_call,
            "metrics_flush_steps": args.flush_steps,
            "checkpoint_every_steps": args.checkpoint_every,
            "val_interval_epochs": args.val_interval_epochs,
            "log_interval_epochs": args.log_interval_epochs,
        },
    })
    return cfg.apply_overrides(args.overrides)


def loss_trajectory(run_dir: str, cfg: Config, degrade, pitch_tracker: str) -> dict:
    """The run's loss record in the layout of pretrained/oof_loss.json."""
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    val_losses = [v for _, v in read_metrics(run_dir, "loss/val")]
    return {
        "corpus": "out-of-family (fixtures.py: pluck / fm_brass / bowed)",
        "degradation": degrade,
        "model": cfg.model.name,
        "pitch_tracker": pitch_tracker,
        "pipeline": f"wav -> preprocess.py ({pitch_tracker}) -> train -> export",
        "steps": len(losses),
        "loss_first10_mean": sum(losses[:10]) / max(len(losses[:10]), 1),
        "loss_last10_mean": sum(losses[-10:]) / max(len(losses[-10:]), 1),
        "val_losses": val_losses,
        "loss_curve_every_100": losses[::100],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps-per-call", type=int, default=25)
    p.add_argument("--n-train", type=int, default=18)
    p.add_argument("--n-validation", type=int, default=4)
    p.add_argument("--root", default="/tmp/ddsp_oof")
    p.add_argument("--out", default="pretrained")
    p.add_argument("--tag", default="oof")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--model", default="decoder", choices=("decoder", "autoencoder"),
                   help="autoencoder: the mfcc-autoencoder with the fixed MFCC dB floor "
                        "(mfcc_ref_db 0), so its bundle streams exactly")
    p.add_argument("--pitch-tracker", default="yin", choices=("yin", "crepe", "hybrid"))
    p.add_argument("--crepe-params", default="pretrained/crepe_tiny.msgpack")
    p.add_argument("--flush-steps", type=int, default=20, help="train.metrics_flush_steps")
    p.add_argument("--checkpoint-every", type=int, default=2000)
    p.add_argument("--val-interval-epochs", type=int, default=500)
    p.add_argument("--log-interval-epochs", type=int, default=200)
    p.add_argument("--degrade", default=None, metavar="CONDITION", choices=sorted(DEGRADATIONS),
                   help="pass the corpus through fixtures.DEGRADATIONS[CONDITION] (e.g. "
                        "full_chain: room reverb, mic chain, 10 dB SNR pink noise)")
    p.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE", dest="overrides",
                   help="override a config field before the corpus is made (repeatable)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    corpus = os.path.join(args.root, "corpus")
    cache = os.path.join(args.root, "cache")
    cfg = oof_config(corpus, cache, args)
    pc = cfg.preprocess
    if not os.path.exists(corpus):
        print(f"synthesizing out-of-family corpus at {corpus} (degradation: {args.degrade or 'none'})",
              flush=True)
        make_oof_corpus(corpus, sample_rate=pc.sample_rate, note_seconds=pc.signal_length / pc.sample_rate,
                        n_train=args.n_train, n_validation=args.n_validation, seed=0,
                        degrade_fn=make_degrader(**DEGRADATIONS[args.degrade]) if args.degrade else None)
    if not os.path.exists(os.path.join(cache, "train", "signals.npy")):
        print(f"preprocessing ({pc.pitch_tracker} pitch, A-loudness, MFCC)", flush=True)
        for partition in ("train", "validation"):
            preprocess_folder(corpus, partition, cfg, device=device)

    run_dir = os.path.join(args.root, "runs", args.tag)
    datamodule = Datamodule(cfg, device_cache=True, device=device)
    datamodule.setup()
    trainer = Trainer(cfg, run_dir, device=device, use_tensorboard=False)
    try:
        trainer.fit(datamodule)
    finally:
        trainer.close()

    traj = loss_trajectory(run_dir, cfg, args.degrade, args.pitch_tracker)
    print(json.dumps({k: traj[k] for k in list(traj)[:5]}, indent=2))
    os.makedirs(args.out, exist_ok=True)
    bundle = export_run(run_dir, args.out, name=args.tag, device=device)
    with open(os.path.join(args.out, f"{args.tag}_loss.json"), "w") as f:
        json.dump(traj, f, indent=2)
    print(f"bundle: {bundle}")
    return traj


if __name__ == "__main__":
    main()
