"""Weak-scaling sweep of the data-parallel train step.

Port of scripts/bench_scaling.py.  For each world size 1, 2, 4, … up to
the cards visible (torch.cuda.device_count()), or the --world-sizes given,
it starts one process a rank — on the card one NCCL rank a card, on the
CPU gloo ranks — that joins a process group as the train CLI's
--multihost does (train.init_multihost, build_mesh: no mesh at world
size 1) and steps the data-parallel step of parallel/sharding.py: each
rank its rows of the global batch, the gradients and loss averaged in one
all_reduce a step.  The global batch is the per-device batch × the world
size (weak scaling).  After one warm-up call it times --reps steps: on the
card one call of a MultiStep replaying the CUDA graph of a step (NCCL
captured), as the Trainer runs it; on the CPU (gloo cannot be captured)
--reps eager steps.  It reports steps/s, samples/s and the efficiency:
samples/s a device against world size 1.

    python -m ddsp_pytorch_tpu_torch.bench_scaling [--per-device-batch 2] \\
        [--signal-length 48000] [--reps 10] [--world-sizes 1,2] \\
        [--set key.path=value ...] [--out FILE] [--device cuda]

On one card it runs world size 1 and says so: scaling needs more cards.
The model is configs/config.yaml's (hidden 512, 64 harmonics, 65 bands,
reverb, 6-scale loss) as in the JAX script; --set overrides any field
(the tests shrink it).  The device defaults to the card and there is no
fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

RESULT_TAG = "BENCH_SCALING_RESULT "
# seconds a rank may take, start-up and NCCL included
RANK_TIMEOUT = 900


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(args, world: int):
    from ddsp_pytorch_tpu_torch.bench_headline import REFERENCE_KWARGS, REFERENCE_SCALES
    from ddsp_pytorch_tpu_torch.config import Config

    block = REFERENCE_KWARGS["block_size"]
    config = Config.from_dict({
        "preprocess": {"sample_rate": args.sample_rate, "signal_length": args.signal_length // block * block,
                       "block_size": block},
        "model": {"name": "single-inst-decoder",
                  "kwargs": dict(REFERENCE_KWARGS, sample_rate=args.sample_rate)},
        "train": {"scales": list(REFERENCE_SCALES), "overlap": 0.75,
                  "batch": world * args.per_device_batch},
        "mesh": {"data": -1, "time": 1},
    })
    config.apply_overrides(args.overrides)
    return config


def worker(args) -> None:
    """One rank: join the group, build the step, time it; rank 0 prints the
    result line."""
    import torch
    import torch.distributed as dist

    from ddsp_pytorch_tpu_torch.bench_headline import device_name, train_batch
    from ddsp_pytorch_tpu_torch.models import init_params, load_model
    from ddsp_pytorch_tpu_torch.parallel.sharding import replicate_state
    from ddsp_pytorch_tpu_torch.train import build_mesh, init_multihost
    from ddsp_pytorch_tpu_torch.training.optim import make_optimizer
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import draw_noise, make_train_multi_step, make_train_step

    args.no_mesh, args.backend = False, None  # the train CLI's defaults: NCCL on cuda, gloo on cpu
    device = init_multihost(args)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        config = _config(args, world)
        mesh = build_mesh(args, config)
        model = load_model(config.model.name, config.model.kwargs).to(device)
        generator = torch.Generator(device).manual_seed(0)
        init_params(model, generator)
        tx = make_optimizer(config)
        state = TrainState(0, model, tx.init([p for _, p in model.named_parameters()]), generator, 0.0, 1.0)
        if mesh is not None:
            state = replicate_state(state, mesh)
        b, t = config.train.batch, config.preprocess.signal_length
        rows = slice(rank * args.per_device_batch, (rank + 1) * args.per_device_batch)
        batch = {k: v[rows] for k, v in train_batch(config, device).items()}
        if device.type == "cuda":
            multi = make_train_multi_step(model, tx, config, args.reps, mesh=mesh)
            stacked = {k: v.unsqueeze(0).expand(args.reps, *v.shape) for k, v in batch.items()}

            def call():
                multi(state, stacked)
        else:
            step = make_train_step(model, tx, config, mesh)
            rows_noise = 1 if mesh is None else mesh.data_procs

            def call():
                for _ in range(args.reps):
                    step(state, batch, draw_noise(model, state.generator, batch, rows_noise))

        def synced():
            call()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier()

        synced()  # warm-up: kernel builds, the graph's capture, NCCL's channels
        t0 = time.perf_counter()
        synced()
        dt = (time.perf_counter() - t0) / args.reps
        if rank == 0:
            print(RESULT_TAG + json.dumps({
                "devices": world, "global_batch": b, "step_ms": 1000 * dt,
                "steps_per_s": 1.0 / dt, "samples_per_s": b * t / dt,
                "step": "graphed" if device.type == "cuda" else "eager",
                "backend": dist.get_backend(), "device": device_name(device)}), flush=True)
    finally:
        dist.destroy_process_group()


def run_world(args, world: int) -> dict:
    """Start `world` ranks of this module's worker; rank 0's result."""
    port = _free_port()
    package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "ddsp_pytorch_tpu_torch.bench_scaling", "--worker",
           "--device", args.device, "--per-device-batch", str(args.per_device_batch),
           "--signal-length", str(args.signal_length), "--sample-rate", str(args.sample_rate),
           "--reps", str(args.reps), "--dist-timeout", str(args.dist_timeout)]
    for o in args.overrides:
        cmd += ["--set", o]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env["PYTHONPATH"] = os.pathsep.join(x for x in (package_root, env.get("PYTHONPATH")) if x)
        if args.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=RANK_TIMEOUT))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(r, p.returncode, e[-2000:]) for r, (p, (_, e)) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise RuntimeError(f"bench_scaling: world {world}: ranks failed: {failed}")
    for line in outs[0][0].splitlines():
        if line.startswith(RESULT_TAG):
            return json.loads(line[len(RESULT_TAG):])
    raise RuntimeError(f"bench_scaling: world {world}: rank 0 printed no result")


def sweep(args) -> dict:
    """Every world size in turn; efficiency against the first (world 1)."""
    import torch

    from ddsp_pytorch_tpu_torch import resolve_device
    from ddsp_pytorch_tpu_torch.bench_headline import card_of

    device = resolve_device(args.device)
    if args.world_sizes:
        sizes = [int(w) for w in args.world_sizes.split(",")]
    else:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        sizes = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n]
    results, base = [], None
    for world in sizes:
        r = run_world(args, world)
        per_device = r["samples_per_s"] / world
        base = per_device if base is None else base
        r["efficiency"] = per_device / base
        results.append(r)
        print(f"devices {world:3d}: step {r['step_ms']:9.3f} ms  {r['samples_per_s'] / 1e6:9.3f} "
              f"Msamples/s  efficiency {r['efficiency']:7.2%}", flush=True)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    payload = {
        "device": results[0]["device"],
        "card": card_of(device),
        "cards_visible": cards,
        "note": (f"{cards} card(s) visible: world size 1 only; scaling needs more cards"
                 if device.type == "cuda" and max(sizes) == 1 else None),
        "workload": {"per_device_batch": args.per_device_batch,
                     "signal_length": args.signal_length // 512 * 512,
                     "sample_rate": args.sample_rate, "overrides": args.overrides},
        "protocol": ("weak scaling: global batch = world size x per-device batch; one process a rank; "
                     "the time of --reps steps after one warm-up call (the card: one MultiStep call, "
                     "a CUDA graph of a step with NCCL inside; the CPU: eager steps over gloo); "
                     "efficiency = samples/s a device against world size 1"),
        "results": results,
    }
    if payload["note"]:
        print(payload["note"], flush=True)
    print(json.dumps(payload), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return payload


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--per-device-batch", type=int, default=2)
    p.add_argument("--signal-length", type=int, default=48000)
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--world-sizes", default=None, help="comma-separated (default 1, 2, 4, … to the cards)")
    p.add_argument("--set", action="append", default=[], dest="overrides", metavar="KEY.PATH=VALUE",
                   help="override any config field (dotted path, YAML scalar value; repeatable)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist-timeout", type=float, default=300.0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.worker:
        return worker(args)
    return sweep(args)


if __name__ == "__main__":
    main()
