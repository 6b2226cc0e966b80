"""Train and export a pretrained instrument bundle on the synthetic corpus.

The port's counterpart of scripts/train_pretrained.py, with its flags:

    python -m ddsp_pytorch_tpu_torch.train_pretrained --instrument violin \\
        --model mfcc-autoencoder --steps 4000 --out export \\
        [--n-items 24] [--batch 8] [--steps-per-call 25] [--root runs/pretrained] \\
        [--device cuda]

It renders the instrument's synthetic corpus (data/synthetic.py; 2 ×
n_items notes of 4 s at 48 kHz, 48 harmonics, the seed a CRC of the
instrument's name; the autoencoder's MFCCs with the fixed dB reference
mfcc_ref_db 0.0 that streaming needs) into <root>/cache_<instrument>[_ae]
unless it is there, trains the model at the reference's full width
(hidden 512, 64 harmonics, 65 bands, reverb on, six scales at 0.75
overlap, Adam 1e-3) from the device-resident cache, then exports the run
into --out: ddsp_<tag>_bundle/, ddsp_<tag>_impulse.wav,
ddsp_<tag>_config.yaml and <tag>_loss.json (tag = the instrument, with
"_ae" for the autoencoder).  It writes only under --root and --out.  The
device defaults to the GPU and there is no fallback: pass --device cpu for
the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

SAMPLE_RATE, BLOCK_SIZE, SIGNAL_LENGTH = 48000, 512, 192000
CORPUS_HARMONICS = 48  # the rendered notes' partials (the model has 64)


def tag_of(instrument: str, autoencoder: bool) -> str:
    return instrument + ("_ae" if autoencoder else "")


def corpus_seed(instrument: str) -> int:
    """The corpus's seed: a CRC of the instrument's name (str hash() is
    salted per process)."""
    return zlib.crc32(instrument.encode()) % (2**31)


def render_corpus(root: str, instrument: str, autoencoder: bool, n_items: int, device="cuda") -> str:
    """The instrument's synthetic feature cache under `root`, rendered on
    `device` unless it exists.  Returns its directory."""
    from ddsp_pytorch_tpu_torch.data.synthetic import make_synthetic_dataset

    cache = os.path.join(root, "cache_" + tag_of(instrument, autoencoder))
    if not os.path.exists(cache):
        print(f"rendering {n_items}x2 synthetic {instrument} notes...", flush=True)
        make_synthetic_dataset(
            cache,
            n_items=n_items,
            sample_rate=SAMPLE_RATE,
            signal_length=SIGNAL_LENGTH,
            block_size=BLOCK_SIZE,
            n_harmonic=CORPUS_HARMONICS,
            instrument=instrument,
            # an autoencoder bundle streams live: its MFCCs take the causal
            # fixed-reference dB floor
            mfcc_ref_db=0.0 if autoencoder else None,
            seed=corpus_seed(instrument),
            device=device,
        )
    return cache


def pretrained_config(model: str, cache: str, steps: int, batch: int, steps_per_call: int):
    """The run config of scripts/train_pretrained.py (what
    pretrained/ddsp_<tag>_config.yaml froze)."""
    from ddsp_pytorch_tpu_torch.config import Config

    return Config.from_dict({
        "preprocess": {
            "sample_rate": SAMPLE_RATE,
            "signal_length": SIGNAL_LENGTH,
            "block_size": BLOCK_SIZE,
            "out_dir": cache,
            "mfcc_ref_db": 0.0 if model == "mfcc-autoencoder" else None,
            "pitch_tracker": "yin",
        },
        "model": {
            "name": model,
            "kwargs": {
                "hidden_size": 512,
                "n_harmonic": 64,
                "n_bands": 65,
                "sample_rate": SAMPLE_RATE,
                "block_size": BLOCK_SIZE,
                "has_reverb": True,
            },
        },
        "train": {
            "scales": [4096, 2048, 1024, 512, 256, 128],
            "overlap": 0.75,
            "batch": batch,
            "lr": 1e-3,
            "steps": steps,
            "steps_per_call": steps_per_call,
            "checkpoint_every_steps": 1000,
            "val_interval_epochs": 200,
            "log_interval_epochs": 100,
        },
    })


def main(argv=None) -> str:
    from ddsp_pytorch_tpu_torch.data import Datamodule
    from ddsp_pytorch_tpu_torch.export import export_run
    from ddsp_pytorch_tpu_torch.training import Trainer
    from ddsp_pytorch_tpu_torch.training.metrics import read_metrics

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--instrument", default="violin", choices=["violin", "sax", "flute"])
    p.add_argument("--model", default="single-inst-decoder",
                   choices=["single-inst-decoder", "mfcc-autoencoder"])
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--n-items", type=int, default=24)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps-per-call", type=int, default=25)
    p.add_argument("--root", default=os.path.join("runs", "pretrained"),
                   help="where the corpus and the run are written")
    p.add_argument("--out", default="export", help="where the bundle and its files are written")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    autoencoder = args.model == "mfcc-autoencoder"
    tag = tag_of(args.instrument, autoencoder)
    cache = render_corpus(args.root, args.instrument, autoencoder, args.n_items, args.device)
    cfg = pretrained_config(args.model, cache, args.steps, args.batch, args.steps_per_call)
    run_dir = os.path.join(args.root, "runs", tag)
    dm = Datamodule(cfg, device_cache=True, device=args.device)
    dm.setup()
    trainer = Trainer(cfg, run_dir, device=args.device, use_tensorboard=False)
    try:
        trainer.fit(dm)
    finally:
        trainer.close()

    losses = [v for _, v in read_metrics(run_dir, "loss")]
    traj = {
        "instrument": args.instrument,
        "model": args.model,
        "steps": len(losses),
        "loss_first10_mean": sum(losses[:10]) / max(len(losses[:10]), 1),
        "loss_last10_mean": sum(losses[-10:]) / max(len(losses[-10:]), 1),
        "loss_curve_every_100": losses[::100],
    }
    print(json.dumps({k: traj[k] for k in list(traj)[:4]}, indent=2))
    os.makedirs(args.out, exist_ok=True)
    bundle = export_run(run_dir, args.out, name=tag, device=args.device)
    with open(os.path.join(args.out, f"{tag}_loss.json"), "w") as f:
        json.dump(traj, f, indent=2)
    print(f"bundle: {bundle}")
    return bundle


if __name__ == "__main__":
    main()
