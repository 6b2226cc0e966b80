"""Train through the sigmund ingestion path (port of scripts/train_sigmund.py):

    python -m ddsp_pytorch_tpu_torch.train_sigmund --steps 10000 --segment-steps 5000 \\
        [--root /tmp/ddsp_sigmund] [--out pretrained] [--tag sigmund] \\
        [--set key.path=value ...] [--device cuda]

The reference's pretrained models were preprocessed by a Pure Data patch
(patches/preprocess.pd: sigmund~ pitch → mtof → Hz and a loudness outlet,
both smoothed by `lop~ 1000`) recording a 3-channel wav.  With no Pd here,
this emulates the patch and drives the real ingestion end to end:

  1. fixture performances (data/fixtures.py notes through the full_chain
     degradation: room reverb, mic chain, 10 dB SNR pink noise);
  2. a sigmund~-style analyzer over the degraded audio: YIN pitch and
     A-weighted loudness a block (on the device), held to the sample rate
     and smoothed by Pd's one-pole `lop~ 1000` (`lop`);
  3. one 3-channel float32 wav a partition (audio, pitch in Hz, loudness);
  4. data/sigmund.py preprocess_from_sigmund → the .npy cache;
  5. train.py --segment-steps at the reference workload (workload.py),
     each segment a fresh process resuming the one before;
  6. validation on the trained state, export_run, and <out>/<tag>_loss.json
     in the layout of pretrained/sigmund_loss.json.

The corpus, the wavs and the cache under --root are made once and reused.
--set overrides the workload config before anything is made (the corpus
follows preprocess.sample_rate and signal_length).  The device defaults to
the GPU and there is no fallback: --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch import train as train_cli
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule
from ddsp_pytorch_tpu_torch.data.fixtures import DEGRADATIONS, lfilter, make_degrader, make_oof_corpus
from ddsp_pytorch_tpu_torch.data.sigmund import preprocess_from_sigmund
from ddsp_pytorch_tpu_torch.export import export_run
from ddsp_pytorch_tpu_torch.ops.loudness import extract_loudness
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav, save_wav_float
from ddsp_pytorch_tpu_torch.workload import reference_workload_config

LOP_HZ = 1000.0  # Pd's lop~ 1000 on both analyzer outlets


def lop(x, sample_rate: int, fc: float = LOP_HZ) -> np.ndarray:
    """Pd's lop~: the one-pole low-pass y[n] = y[n−1] + a·(x[n] − y[n−1]),
    a = 1 − exp(−2π·fc/sr), started at y[−1] = x[0] (train_sigmund.py:72;
    scipy's lfilter with zi = (1 − a)·x[0]), in float64 → float32."""
    a = 1.0 - math.exp(-2.0 * math.pi * fc / sample_rate)
    x = np.asarray(x)
    return lfilter([a], [1.0, -(1.0 - a)], x, y_init=[x[0]]).astype(np.float32)


def sigmund_channels(sigs: np.ndarray, sample_rate: int, block_size: int, *, device="cuda") -> np.ndarray:
    """The patch's 3-channel recording of notes (N, T): (N·T, 3) float32,
    the notes one after another in channel 0, their YIN pitch (Hz) and
    A-weighted loudness, one value a block held for the block's samples
    and lop~-smoothed over the whole recording, in channels 1 and 2."""
    f0 = extract_pitch(sigs, sample_rate, block_size, device=device).cpu().numpy()
    loud = extract_loudness(sigs, sample_rate, block_size, device=device).cpu().numpy()
    audio = sigs.reshape(-1)
    pitch_ch = lop(np.repeat(f0.reshape(-1), block_size).astype(np.float32), sample_rate)
    loud_ch = lop(np.repeat(loud.reshape(-1), block_size).astype(np.float32), sample_rate)
    n = audio.shape[0]
    return np.stack([audio, pitch_ch[:n], loud_ch[:n]], axis=1).astype(np.float32)


def prepare(root: str, cfg: Config, n_train: int, n_validation: int, *, device="cuda") -> None:
    """The fixture corpus (full_chain), the two sigmund wavs and the cache
    under `root`, each made unless it is there."""
    pc = cfg.preprocess
    sr = pc.sample_rate
    corpus = os.path.join(root, "corpus")
    if not os.path.exists(corpus):
        make_oof_corpus(corpus, sample_rate=sr, note_seconds=pc.signal_length / sr, n_train=n_train,
                        n_validation=n_validation, seed=0,
                        degrade_fn=make_degrader(**DEGRADATIONS["full_chain"]))
    wav_dir = cfg.data.data_location
    os.makedirs(wav_dir, exist_ok=True)
    for partition in ("train", "validation"):
        out_wav = os.path.join(wav_dir, partition + ".wav")
        if os.path.exists(out_wav):
            continue
        part_dir = os.path.join(corpus, partition)
        sigs = np.stack([load_wav(os.path.join(part_dir, f), sr)[0]
                         for f in sorted(os.listdir(part_dir)) if f.endswith(".wav")])
        tri = sigmund_channels(sigs, sr, pc.block_size, device=device)
        save_wav_float(out_wav, tri, sr)
        print(partition, tri.shape, flush=True)
    if not os.path.exists(os.path.join(pc.out_dir, "train", "signals.npy")):
        for partition in ("train", "validation"):
            preprocess_from_sigmund(os.path.join(wav_dir, partition + ".wav"), cfg, partition)


def validate_and_export(run_dir: str, out: str, tag: str, *, device="cuda") -> str:
    """Validation on the run's newest checkpoint (loss/val and its media
    into the run), then export_run.  Returns the bundle directory."""
    cfg = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    datamodule = Datamodule(cfg, device=device)
    datamodule.setup()
    trainer = Trainer(cfg, run_dir, device=device, use_tensorboard=False)
    try:
        state, resumed = trainer.resume_or_init(cfg.data.mean_loudness, cfg.data.std_loudness)
        if not resumed:
            raise RuntimeError(f"no checkpoint to validate under {run_dir}")
        trainer._run_validation(state, datamodule.val_dataloader())
    finally:
        trainer.close()
    return export_run(run_dir, out, name=tag, device=device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--segment-steps", type=int, default=5000)
    p.add_argument("--steps-per-call", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n-train", type=int, default=18)
    p.add_argument("--n-validation", type=int, default=4)
    p.add_argument("--root", default="/tmp/ddsp_sigmund")
    p.add_argument("--out", default="pretrained")
    p.add_argument("--tag", default="sigmund")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE", dest="overrides",
                   help="override a workload config field before anything is made (repeatable)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.root, exist_ok=True)
    cfg = Config.from_dict(reference_workload_config(
        os.path.join(args.root, "wavs"), os.path.join(args.root, "cache"),
        train={"batch": args.batch, "steps": args.steps, "steps_per_call": args.steps_per_call},
    )).apply_overrides(args.overrides)
    cfg_path = os.path.join(args.root, "sigmund.yaml")
    cfg.to_yaml(cfg_path)

    t0 = time.time()
    print("[sigmund] prep: corpus -> 3-channel wav -> cache", flush=True)
    prepare(args.root, cfg, args.n_train, args.n_validation, device=device)
    print("[sigmund] segmented training", flush=True)
    runs = os.path.join(args.root, "runs")
    train_cli.main(["--config", cfg_path, "--root", runs, "--name", args.tag, "--device-cache",
                    "--device", str(args.device), "--segment-steps", str(args.segment_steps), "--no-tensorboard"])
    run_dir = os.path.join(runs, args.tag)
    print("[sigmund] validate + export", flush=True)
    bundle = validate_and_export(run_dir, args.out, args.tag, device=device)
    print(f"bundle: {bundle}", flush=True)

    losses = [v for _, v in read_metrics(run_dir, "loss")]
    val_losses = [v for _, v in read_metrics(run_dir, "loss/val")]
    traj = {
        "corpus": "out-of-family fixtures, full_chain degradation (reverb + mic chain + 10 dB SNR pink)",
        "pipeline": "fixtures wav -> sigmund~-emulated 3-channel wav (YIN pitch + A-loudness channels, "
                    "lop~1000-smoothed) -> data/sigmund.py ingestion -> segmented train -> export "
                    "(reference preprocess_from_sigmund.py:10-44 parity path)",
        "steps": len(losses),
        "batch": cfg.train.batch,
        "wall_s": round(time.time() - t0, 1),
        "loss_first10_mean": sum(losses[:10]) / max(len(losses[:10]), 1),
        "loss_last100_mean": sum(losses[-100:]) / max(len(losses[-100:]), 1),
        "val_losses": val_losses,
        "loss_curve_every_100": losses[::100],
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.tag}_loss.json"), "w") as f:
        json.dump(traj, f, indent=2)
    print(json.dumps({k: traj[k] for k in ("steps", "wall_s", "loss_first10_mean", "loss_last100_mean")},
                     indent=2))
    return traj


if __name__ == "__main__":
    main()
