"""The readings a RAVE cell's limits of `correct` are set from: the
program's own and four controls', at the cell's own size, through the
rave_train kind's set-up and judge.

    python3 benchmark/tools/rave_control.py --cell rave.train_b8 --seeds 1,2,3 [--out FILE]

For each seed, on the cell's weights, crops and draws from that seed,
judged against the float64 reference exactly as a run is: the program's
first three steps (`program`, what a run compares); the plain reference
put in the program's place in float32 with TF32 convolutions and products
(`control_tf32`: one precision below the configuration's float32 with TF32
off); the program with RAVE's distance replaced by DDSP's, the mean L1
linear term in place of the relative Frobenius norm (`ddsp_distance`);
the program with the PQMF prototype one tap shorter on each side, at the
same cutoff (`short_prototype`); and the program with every step's update
put back after it (`state_unchanged`).  Each reading is the four compared
numbers and the verdict a run with the cell's limits gives them
(`harness.Run.correct`), with the checks it fails.  Prints one JSON line a
seed.  Needs a CUDA card.
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
from benchmark.kinds import rave_train as kind  # noqa: E402

COMPARED = ("loss_gap", "grad_gap", "update_gap", "stats_gap")


@contextlib.contextmanager
def patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def ddsp_distance():
    """RAVE's distance with DDSP's linear term (the fused DDSP form)."""
    from ddsp_pytorch_tpu_torch.ops.stft_loss import multiscale_spectral_loss
    from ddsp_pytorch_tpu_torch.training import loss as loss_mod

    def distance(x, y, scales, overlap):
        t = y.shape[-1]
        return multiscale_spectral_loss(x.reshape(-1, t).float(), y.reshape(-1, t).float(), scales, overlap)

    return patched(loss_mod, "rave_distance", distance)


def state_unchanged():
    """The program's update with the parameters put back after it."""
    from ddsp_pytorch_tpu_torch.training import train as train_mod

    real = train_mod._update_in_place

    def update(state, tx, loss, grads):
        saved = [p.detach().clone() for p in state.params()]
        out = real(state, tx, loss, grads)
        with torch.no_grad():
            for p, s in zip(state.params(), saved):
                p.copy_(s)
        return out

    return patched(train_mod, "_update_in_place", update)


def short_bank(model) -> None:
    """The model's bank from the prototype one tap shorter on each side,
    at the same cutoff."""
    from ddsp_pytorch_tpu_torch.ops import pqmf

    m = model.pqmf.bank.shape[0]
    h, wc = pqmf.prototype(m)
    bank = pqmf.modulate(pqmf.kaiser_filter(wc, pqmf.ATTENUATION, h.shape[0] - 2), m)
    model.pqmf.bank = torch.tensor(bank, device=model.pqmf.bank.device)


def program(cfg, cell, seed, device, fault=None) -> dict:
    spc = int(cfg["assumed"]["steps_per_call"])
    multi, state, loader, weights, gen0, snaps = kind.make_program(cfg, seed, device, spc,
                                                                   int(cell["params"]["corpus_items"]))
    if fault is not None:
        fault(state.model)
    stream = kind._index_stream(loader, spc)
    seen, _ = kind.first_call(multi, state, loader, stream, weights, gen0, snaps, cfg)
    del multi, state, loader
    torch.cuda.empty_cache()
    return seen


def verdict(values: dict, limits: dict) -> dict:
    """The compared numbers, and what a run with `limits` makes of them."""
    checks = {k: [values[k], float(limits[k])] for k in COMPARED}
    run = harness.Run(e2e={}, attempted=0, failed=0, checks=checks, memory_peak_bytes=0)
    return {**{k: values[k] for k in COMPARED}, "correct": run.correct,
            "fails": [k for k, (v, lim) in checks.items() if v > lim]}


def readings(cfg, cell, seed, device) -> dict:
    seen = program(cfg, cell, seed, device)
    ref = kind.reference_steps(cfg, seen, device)
    out = {"program": kind.numbers(seen, ref)}
    tf32 = kind.reference_steps(cfg, seen, device, torch.float32, allow_tf32=True)
    out["control_tf32"] = kind.numbers(
        {**seen, "loss1": tf32["losses"][0], "grads1": tf32["grads"], "p3": tf32["states"][-1],
         "stats1": {k: tf32["states"][0][k] for k in seen["stats1"]}}, ref)
    with ddsp_distance():
        out["ddsp_distance"] = kind.numbers(program(cfg, cell, seed, device), ref)
    out["short_prototype"] = kind.numbers(program(cfg, cell, seed, device, short_bank), ref)
    with state_unchanged():
        out["state_unchanged"] = kind.numbers(program(cfg, cell, seed, device), ref)
    return {k: verdict(v, cell["limits"]) for k, v in out.items()}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rave_control: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _, cfg, cell = harness.load_cell(harness.benchmark_spec(ROOT), args.cell)
    device = torch.device("cuda", 0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"cell": args.cell, "seed": seed, "card": card, **readings(cfg, cell, seed, device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
