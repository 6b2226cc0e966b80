"""Trajectory-level equivalence of time-sharded and unsharded training.

Port of scripts/time_sharded_trajectory.py.  One sharded step equal to one
unsharded step does not show that their small differences stay bounded
over a run, so this trains the same model from the same weights twice —
unsharded, and time-sharded on an in-process ('data' 2, 'time' 4) mesh with
the pad-and-mask path engaged (4544 samples = 71 frames, which 4 does not
divide) — on the same batches and the same noise draws, and reports both
loss curves, their windowed means and the final parameters' distance.
`check_bounds` holds a report to the bounds of
pretrained/time_sharded_trajectory.json and
tests/test_time_sharded_training.py:295-322: the windowed loss within 5 %
at every checkpoint, each run's last window below 0.6× its first, the
final global parameter rel-L2 under 0.2.

    python -m ddsp_pytorch_tpu_torch.time_sharded_trajectory [--steps 400] \\
        [--out FILE] [--device cuda|cpu]

The device defaults to the GPU and there is no fallback.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Dataset, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.parallel import make_mesh
from ddsp_pytorch_tpu_torch.training import make_optimizer, make_train_step
from ddsp_pytorch_tpu_torch.training.state import TrainState
from ddsp_pytorch_tpu_torch.training.time_sharded import plan_time_padding

# the bounds of tests/test_time_sharded_training.py:295-322
MAX_WINDOW_REL_DIFF = 0.05
MIN_LOSS_FALL = 0.6  # the last window below this share of the first
MAX_PARAM_REL_L2 = 0.2


def trajectory_config(signal_length: int, cache_dir: str) -> Config:
    """The script's workload (time_sharded_trajectory.py:76-104)."""
    return Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": signal_length, "block_size": 64,
                       "out_dir": cache_dir},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 32, "n_harmonic": 8, "n_bands": 9, "sample_rate": 16000,
            "block_size": 64, "has_reverb": True}},
        "train": {"scales": [512, 256], "overlap": 0.75, "batch": 4, "lr": 1e-3},
    })


def run_trajectories(steps: int = 400, signal_length: int = 4544, window: int = 25,
                     cache_dir: str | None = None, device="cuda") -> dict:
    """Train unsharded and time-sharded for `steps` identical steps; returns
    the report (time_sharded_trajectory.py:36-187's keys, the parameters
    under this package's state_dict names)."""
    device = resolve_device(device)
    if cache_dir is None:
        cache_dir = os.path.join(tempfile.mkdtemp(), "cache")
    make_synthetic_dataset(cache_dir, n_items=8, sample_rate=16000, signal_length=signal_length,
                           block_size=64, n_harmonic=8, device=device)
    cfg = trajectory_config(signal_length, cache_dir)
    mesh = make_mesh(data=2, time=4)
    plan = plan_time_padding(cfg, mesh)
    if plan.pad_frames == 0:
        raise ValueError("the trajectory must exercise pad-and-mask: pick a frame count 4 does not divide")

    ds = Dataset(os.path.join(cache_dir, "train"))
    n_items = len(ds)
    items = [ds[i] for i in range(n_items)]
    loud = np.stack([it["loudness"] for it in items])
    mean_l, std_l = float(loud.mean()), float(loud.std())
    stacked = {k: torch.tensor(np.stack([it[k] for it in items]), device=device) for k in items[0]}

    def batch_at(step: int) -> dict:
        idx = torch.tensor([(step * cfg.train.batch + j) % n_items for j in range(cfg.train.batch)],
                           device=device)
        return {k: v.index_select(0, idx) for k, v in stacked.items()}

    base = init_params(load_model(cfg.model.name, cfg.model.kwargs),
                       torch.Generator().manual_seed(0)).to(device)

    def train(sharded: bool):
        model = copy.deepcopy(base)
        tx = make_optimizer(cfg)
        state = TrainState(0, model, tx.init([p for _, p in model.named_parameters()]),
                           torch.Generator(device).manual_seed(1), mean_l, std_l)
        step_fn = make_train_step(model, tx, cfg, mesh if sharded else None)
        losses = []
        t0 = time.monotonic()
        for s in range(steps):
            losses.append(step_fn(state, batch_at(s))["loss"])
        losses = torch.stack(losses).tolist()
        return model, losses, time.monotonic() - t0

    model_u, losses_u, wall_u = train(sharded=False)
    model_s, losses_s, wall_s = train(sharded=True)

    checkpoints = []
    for end in range(window, steps + 1, window):
        mu = float(np.mean(losses_u[end - window:end]))
        ms = float(np.mean(losses_s[end - window:end]))
        checkpoints.append({"step": end, "loss_unsharded": mu, "loss_sharded": ms,
                            "rel_diff": abs(ms - mu) / mu})
    per_tensor = {}
    num = den = 0.0
    for (name, a), b in zip(model_u.named_parameters(), model_s.parameters()):
        d = float((b.detach() - a.detach()).double().norm())
        n = float(a.detach().double().norm())
        per_tensor[name] = {"l2_diff": d, "l2": n, "rel": d / max(n, 1e-12)}
        num += d * d
        den += n * n
    return {
        "steps": steps,
        "signal_length": signal_length,
        "pad_frames": plan.pad_frames,
        "frames": plan.frames,
        "frames_pad": plan.frames_pad,
        "optimizer": cfg.train.optimizer,
        "lr": cfg.train.lr,
        "window": window,
        "device": str(device),
        "loss_first_window": checkpoints[0],
        "loss_last_window": checkpoints[-1],
        "checkpoints": checkpoints,
        "losses_unsharded": losses_u,
        "losses_sharded": losses_s,
        "final_param_global_rel_l2": (num ** 0.5) / max(den ** 0.5, 1e-12),
        "final_param_per_tensor": per_tensor,
        "wall_s_unsharded": wall_u,
        "wall_s_sharded": wall_s,
    }


def check_bounds(report: dict) -> list:
    """The bounds a report misses (empty when it meets them all)."""
    failed = [f"step {c['step']}: windowed loss rel diff {c['rel_diff']:.4f} ≥ {MAX_WINDOW_REL_DIFF}"
              for c in report["checkpoints"] if c["rel_diff"] >= MAX_WINDOW_REL_DIFF]
    for run in ("unsharded", "sharded"):
        first = report["loss_first_window"][f"loss_{run}"]
        last = report["loss_last_window"][f"loss_{run}"]
        if not last < MIN_LOSS_FALL * first:
            failed.append(f"{run}: last window {last:.4f} not below {MIN_LOSS_FALL} × first {first:.4f}")
    if not report["final_param_global_rel_l2"] < MAX_PARAM_REL_L2:
        failed.append(f"final param rel L2 {report['final_param_global_rel_l2']:.4f} ≥ {MAX_PARAM_REL_L2}")
    return failed


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--signal-length", type=int, default=4544)
    p.add_argument("--out", default=None, help="write the report here (JSON)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    report = run_trajectories(steps=args.steps, signal_length=args.signal_length, device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    first, last = report["loss_first_window"], report["loss_last_window"]
    print(f"unsharded: {last['loss_unsharded']:.4f}  sharded: {last['loss_sharded']:.4f}  "
          f"(first-window rel diff {first['rel_diff']:.2e}, last {last['rel_diff']:.2e}); "
          f"final param global rel L2 {report['final_param_global_rel_l2']:.3e}; "
          f"wall s unsharded {report['wall_s_unsharded']:.2f} sharded {report['wall_s_sharded']:.2f}")
    failed = check_bounds(report)
    print("bounds: " + ("met" if not failed else "MISSED: " + "; ".join(failed)))
    return report


if __name__ == "__main__":
    main()
