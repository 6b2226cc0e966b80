"""Training CLI of the port (the counterpart of the repository's train.py):

    python -m ddsp_pytorch_tpu_torch.train --config configs/config.yaml \\
        --name myrun [--root runs] [--steps N] [--batch B] [--lr LR] \\
        [--set key.path=value ...] [--device-cache] [--device cuda] \\
        [--profile] [--segment-steps N | --segment-schedule N1,N2,...] \\
        [--multihost [--backend nccl|gloo] [--dist-timeout S]] \\
        [--mesh-data D] [--mesh-time T] [--no-mesh] [--no-tensorboard]

Loads the YAML config, builds the model by registry name, computes the
dataset's loudness stats (none for RAVE, configs/rave_v1.yaml, which
trains on raw crops) and runs the one-device Trainer on the feature
cache at preprocess.out_dir (`train/` and `validation/`), with the
config's train.steps_per_call steps per call (a CUDA graph of
train.scan_unroll steps replayed on the card).  --device-cache uploads the
train split to the device once and gathers each batch there.  Resumes from
the newest checkpoint in <root>/<name>; SIGTERM or SIGINT checkpoints and
stops at the next call.

The metrics are mirrored to TensorBoard in the run directory where
`tensorboard` imports (training/metrics.py), as in the JAX CLI;
--no-tensorboard turns that sink off (metrics.jsonl is written either way).

--profile traces the first 30 steps (torch.profiler, the card's kernels
included) into <root>/<name>/trace/trace.json, then trains on.
--segment-steps N runs the training as a sequence of fresh child processes
of N steps each (--segment-schedule: a size a segment, the last repeated),
each resuming from the checkpoint the one before it saved; the first child
only computes the loudness stats, freezes them into the run's config and
saves the step-0 checkpoint.  Each child's wall clock is appended to
<root>/<name>/segments.jsonl.

--multihost joins a torch.distributed process group from the environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them; the
JAX CLI's jax.distributed.initialize).  The backend follows the device —
NCCL for cuda, one card a rank (LOCAL_RANK's, where --device names no
index), gloo for cpu — unless --backend names one; the log states it.  As
in JAX (train.py:142-149), a mesh is built only when the world size is
above 1: config.mesh's (data, time), or --mesh-data/--mesh-time, data −1
meaning world size // time.  config.train.batch is then the global batch,
each rank loading its interleaved shard; only rank 0 logs and writes.  With
--no-mesh, or at world size 1, the run is unsharded.

The device defaults to the GPU and there is no fallback: pass --device cpu
for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
import subprocess
import sys
import time

# steps traced by --profile
PROFILE_STEPS = 30
# flags of the parent that its segment children do not get (each child
# gets its own --steps)
_SEGMENT_FLAGS = ("--segment-steps", "--segment-schedule", "--steps")


def _parser() -> argparse.ArgumentParser:
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
    p.add_argument("--device-cache", action="store_true",
                   help="keep the train split on the device (DeviceDataLoader)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help=f"trace the first {PROFILE_STEPS} steps into <run_dir>/trace")
    p.add_argument("--segment-steps", type=int, default=None,
                   help="train in fresh child processes of this many steps each")
    p.add_argument("--segment-schedule", default=None, metavar="N1,N2,...",
                   help="like --segment-steps with a size a segment (the last repeats)")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="mesh 'data' axis (default config.mesh.data; -1: world size // time)")
    p.add_argument("--mesh-time", type=int, default=None,
                   help="mesh 'time' axis (default config.mesh.time); > 1: the time-sharded step")
    p.add_argument("--no-mesh", action="store_true", help="train unsharded")
    p.add_argument("--no-tensorboard", action="store_true",
                   help="no TensorBoard sink (metrics.jsonl only)")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed group from RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="with --multihost: the process group's backend (default: nccl on "
                        "cuda, gloo on cpu)")
    p.add_argument("--dist-timeout", type=float, default=1800.0,
                   help="with --multihost: seconds a collective may wait before it fails")
    return p


def _load_config(args):
    from ddsp_pytorch_tpu_torch.config import Config

    cfg = Config.from_yaml(args.config)
    cfg.apply_overrides(args.overrides)
    if args.steps is not None:
        cfg.train.steps = args.steps
    if args.batch is not None:
        cfg.train.batch = args.batch
    if args.lr is not None:
        cfg.train.lr = args.lr
    if args.mesh_data is not None:
        cfg.mesh.data = args.mesh_data
    if args.mesh_time is not None:
        cfg.mesh.time = args.mesh_time
    return cfg


def init_multihost(args):
    """Join the process group the environment describes; returns this
    rank's device.  NCCL for a cuda device, gloo for cpu, unless --backend
    names one."""
    import torch
    import torch.distributed as dist

    from ddsp_pytorch_tpu_torch import resolve_device

    device = resolve_device(args.device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("--backend nccl needs a cuda device")
    if backend == "nccl" and torch.device(args.device).index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=args.dist_timeout))
    print(f"[train] rank {dist.get_rank()} of {dist.get_world_size()}: backend {backend}, "
          f"device {device}", flush=True)
    return device


def build_mesh(args, cfg):
    """The run's mesh: across the process group when --multihost and the
    world size is above 1 (and not --no-mesh), else None."""
    import torch.distributed as dist

    from ddsp_pytorch_tpu_torch.parallel import make_mesh

    if args.no_mesh or not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() == 1:
        print("[train] world size 1: no mesh (config.mesh not used)", flush=True)
        return None
    mesh = make_mesh(cfg.mesh.data, cfg.mesh.time, group=dist.group.WORLD)
    print(f"[train] {mesh}", flush=True)
    return mesh


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    segmented = args.segment_steps is not None or args.segment_schedule is not None
    if segmented and args.multihost:
        parser.error("--multihost runs one process a rank; it does not take --segment-*")
    if segmented:
        return run_segmented(args, sys.argv[1:] if argv is None else list(argv))

    cfg = _load_config(args)
    run_dir = os.path.join(args.root, args.name)
    device = init_multihost(args) if args.multihost else args.device
    try:
        state = _fit(args, cfg, run_dir, device)
    finally:
        if args.multihost:
            import torch.distributed as dist

            # what holds the group (the mesh, the trainer's steps, the
            # loaders) went with _fit's frame; its reference cycles are
            # freed here, while the process is whole, and not at interpreter
            # exit, where a rank could end in std::terminate (gloo's threads
            # still joinable)
            gc.collect()
            dist.destroy_process_group()
    print(f"trained to step {state.step}; run directory {run_dir}")
    return state


def _fit(args, cfg, run_dir: str, device):
    """Build the mesh, the Trainer and the loaders and train; the state."""
    from ddsp_pytorch_tpu_torch.data import Datamodule
    from ddsp_pytorch_tpu_torch.training import Trainer
    from ddsp_pytorch_tpu_torch.training.profiling import trace

    mesh = build_mesh(args, cfg)
    trainer = Trainer(cfg, run_dir, device=device, mesh=mesh, use_tensorboard=not args.no_tensorboard)
    datamodule = Datamodule(cfg, device_cache=args.device_cache, device=device, mesh=mesh,
                            features=trainer.model.needs_features)
    datamodule.setup()
    try:
        if args.profile:
            with trace(os.path.join(run_dir, "trace"), trainer.device):
                trainer.fit(datamodule, total_steps=min(PROFILE_STEPS, cfg.train.steps))
        return trainer.fit(datamodule)
    finally:
        trainer.close()


def segment_schedule(args) -> list:
    """The segment sizes of --segment-schedule or --segment-steps; a size
    that is not positive raises ValueError."""
    if args.segment_schedule is not None:
        schedule = [int(s) for s in args.segment_schedule.split(",") if s]
    else:
        schedule = [args.segment_steps]
    if not schedule or any(s <= 0 for s in schedule):
        raise ValueError(f"segment sizes must be positive, got {schedule}")
    return schedule


def child_args(argv) -> list:
    """`argv` without the segmentation flags and --steps, with their values."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in _SEGMENT_FLAGS:
            skip = True
        elif not a.startswith(tuple(f + "=" for f in _SEGMENT_FLAGS)):
            out.append(a)
    return out


def run_segmented(args, argv) -> int:
    """Run `python -m ddsp_pytorch_tpu_torch.train` children up to the
    configured steps: first a stats-priming child (--steps 0), then one a
    segment.  Each child's wall clock and return code go to
    <run_dir>/segments.jsonl; a child that fails ends the run with its code
    (SystemExit).  Returns the steps reached."""
    from ddsp_pytorch_tpu_torch import resolve_device

    resolve_device(args.device)  # no child is started for a device that is missing
    schedule = segment_schedule(args)
    total = _load_config(args).train.steps
    cleaned = child_args(argv)
    run_dir = os.path.join(args.root, args.name)
    seg_log = os.path.join(run_dir, "segments.jsonl")
    package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (package_root, env.get("PYTHONPATH")) if p)

    def child(boundary: int, label: str) -> None:
        cmd = [sys.executable, "-m", "ddsp_pytorch_tpu_torch.train", *cleaned, "--steps", str(boundary)]
        print(f"[segment] {label} -> step {boundary}/{total}", flush=True)
        t0 = time.time()
        rc = subprocess.run(cmd, env=env).returncode
        wall = time.time() - t0
        os.makedirs(run_dir, exist_ok=True)
        with open(seg_log, "a") as f:
            f.write(json.dumps({"label": label, "to_step": boundary, "total": total,
                                "wall_s": round(wall, 3), "returncode": rc}) + "\n")
        if rc != 0:
            raise SystemExit(rc)

    child(0, "prime-stats")
    boundary, i = 0, 0
    while boundary < total:
        boundary = min(boundary + schedule[min(i, len(schedule) - 1)], total)
        child(boundary, "train")
        i += 1
    return boundary


if __name__ == "__main__":
    main()
