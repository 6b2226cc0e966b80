"""A sustained training run of the reference workload, each stage its own
process (port of scripts/trainrun_tpu.py):

    python -m ddsp_pytorch_tpu_torch.trainrun [--steps 500000] \\
        [--segment-steps 50000 | --segment-schedule N1,N2,...] [--steps-per-call 50] \\
        [--unroll 1] [--pitch-tracker hybrid|yin|crepe] [--n-train 24] [--n-validation 4] \\
        [--root DIR] [--out reports/trainrun_h100.json] [--skip-validate] \\
        [--set key.path=value ...] [--device cuda]

The pipeline:
  1. config: workload.reference_workload_config (batch 16, 48 kHz,
     192 000-sample chunks, block 512, hidden 512, 64 harmonics, 65 bands,
     reverb, the 6-scale 0.75-overlap loss, Adam 1e-3) with the pitch
     tracker, train.steps, steps_per_call and scan_unroll, then --set,
     written to <root>/trainrun.yaml;
  2. prep (a child on --device): the out-of-family fixture corpus
     (data/fixtures.make_oof_corpus, seed 0, notes of signal_length
     samples) → preprocess_folder of both partitions (the hybrid CREPE × YIN
     tracker by default) → the feature cache;
  3. the card: its name, count and power limit (a child);
  4. segmented training: `python -m ddsp_pytorch_tpu_torch.train
     --device-cache --segment-steps/--segment-schedule`, a stats-priming
     child and one fresh child a segment, each resuming the checkpoint the
     one before saved (segments.jsonl);
  5. validation (a child): the final checkpoint scored over the validation
     partition (loss/val in the run's metrics);
  6. the report, in TRAINRUN_r05.json's keys plus `card`, written to --out.

The corpus and the cache under --root are made once and reused; --root
defaults to a new temporary directory.  --set overrides the workload
config before anything is made (the corpus follows preprocess.sample_rate
and signal_length).  The device defaults to the GPU and there is no
fallback: --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.workload import reference_workload_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "reports", "trainrun_h100.json")  # git-ignored
RUN_NAME = "trainrun"

NOTES = (
    "steps_per_s_wall divides a segment's steps by its child process's wall "
    "clock: the torch import, the device cache upload, the checkpoint restore, "
    "the warm-up runs and capture of the CUDA graph, the training, the metrics "
    "flush and the checkpoint save.  steps_per_s_train_window divides them by the "
    "Trainer's train window (training/train.py: from its first call to a "
    "torch.cuda.synchronize after the last), which on the card is a device rate: "
    "it includes the graph's eager warm-up runs and its capture (graph_warmup_s "
    "and graph_capture_s a segment) but no start-up.  sustained_* divide "
    "total_steps by the children's summed wall clocks.  Every number is the "
    "card's named in `card`."
)


def child_env() -> dict:
    """This environment with the package on PYTHONPATH, for child processes
    run from any directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def run_child(code: str, **kwargs) -> subprocess.CompletedProcess:
    """`python -c code` in its own process; raises CalledProcessError if it fails."""
    return subprocess.run([sys.executable, "-c", code], env=child_env(), check=True, **kwargs)


def workload_config(root: str, *, steps: int, steps_per_call: int, unroll: int = 1,
                    pitch_tracker: str = "hybrid", overrides=()) -> Config:
    """The reference workload with the run's train knobs (trainrun_tpu.py:40-60),
    its corpus under <root>/corpus and its cache under <root>/cache, then
    `overrides` (key.path=value)."""
    return Config.from_dict(reference_workload_config(
        os.path.join(root, "corpus"), os.path.join(root, "cache"),
        preprocess={"pitch_tracker": pitch_tracker},
        train={"steps": steps, "steps_per_call": steps_per_call, "scan_unroll": unroll},
    )).apply_overrides(list(overrides))


def prep(cfg_path: str, n_train: int, n_validation: int, device="cuda") -> None:
    """The fixture corpus at data.data_location and its feature cache at
    preprocess.out_dir, each made unless it is there."""
    from ddsp_pytorch_tpu_torch.data.fixtures import make_oof_corpus
    from ddsp_pytorch_tpu_torch.data.preprocess import preprocess_folder

    cfg = Config.from_yaml(cfg_path)
    pc = cfg.preprocess
    corpus = cfg.data.data_location
    if not os.path.exists(corpus):
        make_oof_corpus(corpus, sample_rate=pc.sample_rate, note_seconds=pc.signal_length / pc.sample_rate,
                        n_train=n_train, n_validation=n_validation, seed=0)
    if not os.path.exists(os.path.join(pc.out_dir, "train", "signals.npy")):
        for partition in ("train", "validation"):
            preprocess_folder(corpus, partition, cfg, device=device)
    print("prep done", flush=True)


def prep_child(cfg_path: str, n_train: int, n_validation: int, device: str) -> None:
    run_child(f"from ddsp_pytorch_tpu_torch.trainrun import prep; "
              f"prep({cfg_path!r}, {n_train}, {n_validation}, {device!r})")


def probe(device="cuda") -> dict:
    """The platform the run trains on: for a card its name, the number of
    cards and nvidia-smi's name and power limit (`card`)."""
    import torch

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "device_kind": "cpu", "n_devices": 1, "card": None}
    from ddsp_pytorch_tpu_torch.kernel_bench import card_line

    return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(dev),
            "n_devices": torch.cuda.device_count(), "card": card_line()}


def probe_child(device: str) -> dict:
    out = run_child(f"import json; from ddsp_pytorch_tpu_torch.trainrun import probe; "
                    f"print(json.dumps(probe({device!r})))", capture_output=True, text=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def validate(run_dir: str, device="cuda") -> float:
    """The run's newest checkpoint scored over the whole validation
    partition (trainrun_tpu.py:103-124): loss/val into the run's metrics;
    returns it."""
    from ddsp_pytorch_tpu_torch.data import Datamodule
    from ddsp_pytorch_tpu_torch.training import Trainer

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
    (step, loss), = read_metrics(run_dir, "loss/val")[-1:]
    print(f"validated at step {step}: loss/val {loss}", flush=True)
    return loss


def _metric_at(rows: list, tag: str, step: int):
    values = [r["value"] for r in rows if r["tag"] == tag and r["step"] == step]
    return values[-1] if values else None


def segment_row(seg: dict, prev_step: int, rows: list) -> dict:
    """A train segment's row: its steps over its child's wall clock and over
    its train window, and the window's graph warm-up and capture, peak
    device memory and kernel launches (eager, replayed) as the Trainer
    logged them."""
    n = seg["to_step"] - prev_step
    to = seg["to_step"]
    row = {"to_step": to, "steps": n, "wall_s": seg["wall_s"], "steps_per_s_wall": n / seg["wall_s"],
           "steps_per_s_train_window": _metric_at(rows, "train_window_steps_per_s", to),
           "train_window_s": _metric_at(rows, "train_window_s", to),
           "graph_warmup_s": _metric_at(rows, "graph_warmup_s", to),
           "graph_capture_s": _metric_at(rows, "graph_capture_s", to),
           "max_memory_allocated_bytes": _metric_at(rows, "max_memory_allocated_bytes", to)}
    for kind in ("kernel_launches", "kernel_replayed"):
        row[kind] = {r["tag"].split("/", 1)[1]: int(r["value"]) for r in rows
                     if r["tag"].startswith(kind + "/") and r["step"] == to}
    return row


def report(args, run_dir: str, probe_: dict, wall_total: float) -> dict:
    """The TRAINRUN report (trainrun_tpu.py:127-203): its keys, plus `card`."""
    with open(os.path.join(run_dir, "segments.jsonl")) as f:
        segs = [json.loads(line) for line in f]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = sorted((r["step"], r["value"]) for r in rows if r["tag"] == "loss")
    val = [(r["step"], r["value"]) for r in rows if r["tag"] == "loss/val"]
    train_segs = [s for s in segs if s["label"] == "train" and s["returncode"] == 0]
    per_segment, prev = [], 0
    for s in train_segs:
        per_segment.append(segment_row(s, prev, rows))
        prev = s["to_step"]
    n_steps = losses[-1][0] if losses else 0
    train_wall = sum(s["wall_s"] for s in train_segs)
    prime_wall = sum(s["wall_s"] for s in segs if s["label"] == "prime-stats")
    stride = max(1, len(losses) // 200)
    cfg = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    mk, tc = cfg.model.kwargs, cfg.train
    return {
        "what": "sustained end-to-end training of the reference workload on "
                f"{probe_['device_kind']} via segmented processes (python -m "
                "ddsp_pytorch_tpu_torch.train --segment-steps)",
        "workload": f"batch {tc.batch}, {mk['sample_rate']} Hz, {cfg.preprocess.signal_length}-sample chunks, "
                    f"block {mk['block_size']}, hidden {mk['hidden_size']}, {mk['n_harmonic']} harmonics, "
                    f"{mk['n_bands']} bands, reverb {mk['has_reverb']}, scales {tc.scales} @ {tc.overlap}, "
                    f"Adam lr {tc.lr}",
        "pipeline": f"fixtures corpus (wav) -> preprocess ({cfg.preprocess.pitch_tracker} pitch + A-loudness "
                    "+ MFCC) -> segmented train -> validate",
        "platform": probe_,
        "card": probe_["card"],
        "total_steps": n_steps,
        "target_steps": args.steps,
        "segment_steps": args.segment_schedule or args.segment_steps,
        "steps_per_call": args.steps_per_call,
        "scan_unroll": args.unroll,
        "pitch_tracker": args.pitch_tracker,
        "n_train_segments": len(train_segs),
        "wall_clock_total_s": wall_total,
        "wall_clock_train_segments_s": train_wall,
        "wall_clock_prime_stats_s": prime_wall,
        "sustained_steps_per_s_incl_everything": n_steps / max(train_wall + prime_wall, 1e-9),
        "sustained_steps_per_s_train_segments": n_steps / max(train_wall, 1e-9),
        "per_segment": per_segment,
        "loss_first10_mean": sum(v for _, v in losses[:10]) / max(len(losses[:10]), 1),
        "loss_last100_mean": sum(v for _, v in losses[-100:]) / max(len(losses[-100:]), 1),
        "final_val_loss": val[-1][1] if val else None,
        "loss_curve": [{"step": s, "loss": round(v, 4)} for s, v in losses[::stride]],
        "notes": NOTES,
    }


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=500000)
    p.add_argument("--segment-steps", type=int, default=50000)
    p.add_argument("--segment-schedule", default=None, metavar="N1,N2,...",
                   help="per-segment sizes (overrides --segment-steps; the last size repeats)")
    p.add_argument("--steps-per-call", type=int, default=50)
    p.add_argument("--unroll", type=int, default=1, help="train.scan_unroll")
    p.add_argument("--pitch-tracker", default="hybrid", choices=("hybrid", "yin", "crepe"))
    p.add_argument("--n-train", type=int, default=24)
    p.add_argument("--n-validation", type=int, default=4)
    p.add_argument("--root", default=None, help="corpus, cache and runs (default: a new temporary directory)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--skip-validate", action="store_true")
    p.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE", dest="overrides",
                   help="override a workload config field before anything is made (repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    resolve_device(args.device)  # no child is started for a device that is missing
    root = args.root or tempfile.mkdtemp(prefix="ddsp_trainrun_")
    os.makedirs(root, exist_ok=True)
    cfg = workload_config(root, steps=args.steps, steps_per_call=args.steps_per_call, unroll=args.unroll,
                          pitch_tracker=args.pitch_tracker, overrides=args.overrides)
    cfg_path = os.path.join(root, "trainrun.yaml")
    cfg.to_yaml(cfg_path)
    runs = os.path.join(root, "runs")
    run_dir = os.path.join(runs, RUN_NAME)

    t0 = time.time()
    print(f"[trainrun] prep ({args.device} child) under {root} ...", flush=True)
    prep_child(cfg_path, args.n_train, args.n_validation, args.device)
    probe_ = probe_child(args.device)
    print(f"[trainrun] platform: {probe_}", flush=True)

    print("[trainrun] segmented training ...", flush=True)
    seg_args = (["--segment-schedule", args.segment_schedule] if args.segment_schedule
                else ["--segment-steps", str(args.segment_steps)])
    subprocess.run([sys.executable, "-m", "ddsp_pytorch_tpu_torch.train", "--config", cfg_path, "--root", runs,
                    "--name", RUN_NAME, "--device-cache", "--device", args.device, "--no-tensorboard", *seg_args],
                   env=child_env(), check=True)
    if not args.skip_validate:
        print(f"[trainrun] final validation ({args.device} child) ...", flush=True)
        run_child(f"from ddsp_pytorch_tpu_torch.trainrun import validate; validate({run_dir!r}, {args.device!r})")

    result = report(args, run_dir, probe_, time.time() - t0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: result[k] for k in (
        "card", "total_steps", "wall_clock_total_s", "sustained_steps_per_s_train_segments",
        "loss_first10_mean", "loss_last100_mean", "final_val_loss")}, indent=2))
    print(f"[trainrun] wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
