"""The readings a CREPE cell's limits of `correct` are set from: the
program's own and three controls', at the cell's own size, through the
crepe_train kind's set-up and judge.

    python3 benchmark/tools/crepe_control.py --cell crepe.train_b256 --seeds 1,2,3 [--out FILE]

For each seed, on the cell's weights and draws from that seed, judged
against the float64 reference exactly as a run is: the program's first
three steps (`program`, what a run compares); the plain reference put in
the program's place in float32 with TF32 convolutions and products
(`control_tf32`: one precision below the configuration's float32 with TF32
off); the program with its CREPE in bf16 (`program_bf16`, model dtype
bfloat16); the program with every step's state put back after it
(`state_unchanged`); and the program with 1e-2 of each batch's peak added
to its synthesized frames (`synth_fault`: the fault that frames_gap's limit
is set below).  Each reading is the four compared numbers and the verdict
a run with the cell's limits gives them (`harness.Run.correct`), with the
checks it fails.  Prints one JSON line a seed.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.kinds import crepe_train as kind  # noqa: E402


@contextlib.contextmanager
def state_unchanged():
    """The program's train step with the model's parameters and statistics
    put back after it."""
    from ddsp_pytorch_tpu_torch import train_crepe

    real = train_crepe.train_step

    def step(model, *args, **kwargs):
        saved = [t.detach().clone() for t in model.state_dict().values()]
        out = real(model, *args, **kwargs)
        with torch.no_grad():
            for t, s in zip(model.state_dict().values(), saved):
                t.copy_(s)
        return out

    train_crepe.train_step = step
    try:
        yield
    finally:
        train_crepe.train_step = real


@contextlib.contextmanager
def synth_fault():
    """The program's batch synthesis with 1e-2 of each batch's peak added
    to its frames."""
    from ddsp_pytorch_tpu_torch import train_crepe

    real = train_crepe.synth_batch

    def synth(draws, robust=False):
        frames, f0 = real(draws, robust)
        return frames + 1e-2 * frames.abs().max(), f0

    train_crepe.synth_batch = synth
    try:
        yield
    finally:
        train_crepe.synth_batch = real


def _program(cfg, seed, device) -> dict:
    trainer, first, weights = kind.make_trainer(cfg, seed, device)
    seen = kind.first_steps(trainer, first, weights)
    del trainer
    return seen


def verdict(values: dict, limits: dict) -> dict:
    """The compared numbers, and what a run with `limits` makes of them."""
    checks = {k: [values[k], float(limits[k])] for k in limits}
    run = harness.Run(e2e={}, attempted=0, failed=0, checks=checks, memory_peak_bytes=0)
    return {**values, "correct": run.correct, "fails": [k for k, (v, lim) in checks.items() if v > lim]}


def readings(cfg, limits, seed, device) -> dict:
    seen = _program(cfg, seed, device)
    ref = kind.reference_steps(cfg, seen, device)
    out = {"program": kind.numbers(seen, ref)}
    tf32 = kind.reference_steps(cfg, seen, device, torch.float32, allow_tf32=True)
    out["control_tf32"] = kind.numbers({"state0": seen["state0"], "states": tf32["states"],
                                        "loss1": tf32["losses"][0], "frames": tf32["frames"]}, ref)
    bf16 = dict(cfg, model=dict(cfg["model"], dtype="bfloat16"))
    out["program_bf16"] = kind.numbers(_program(bf16, seed, device), ref)
    with state_unchanged():
        out["state_unchanged"] = kind.numbers(_program(cfg, seed, device), ref)
    with synth_fault():
        out["synth_fault"] = kind.numbers(_program(cfg, seed, device), ref)
    return {k: verdict(v, limits) for k, v in out.items()}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("crepe_control: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _, cfg, cell = harness.load_cell(harness.benchmark_spec(ROOT), args.cell)
    device = torch.device("cuda", 0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"cell": args.cell, "seed": seed, "card": card, **readings(cfg, cell["limits"], seed, device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
