"""Where a training step's time goes on the GPU.

    python -m ddsp_pytorch_tpu_torch.profile_training \\
        [--config configs/config.yaml] [--steps 5] [--frames N] [--out FILE]

The counterpart of ddsp_pytorch_tpu/training/profiling.py on
torch.profiler.  Builds the config's model with fresh weights on CUDA and a
batch of `train.batch` pitch glides with vibrato (targets from a plain sine
render; the time of a step does not depend on the data), warms up, then runs
`--steps` train steps twice: untraced (ms per step on the host clock, each
step ending in torch.cuda.synchronize()), then under torch.profiler.  From
the trace it reports the device-busy time (the union of kernel intervals)
against the traced wall time, the kernels launched per step, the kernels
ranked by device time, and, from one separately traced forward and backward
of the GRU alone at the same shapes, how many of a step's launches the
375-frame GRU loop makes.  Prints one JSON object and writes it to --out if
given.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch


def glide_controls(n_items: int, n_frames: int, block: int, sample_rate: int, seed: int,
                   mean_loudness: float = -7.9, std_loudness: float = 0.55):
    """Frame-rate (pitch, loudness), each (n_items, n_frames) float32: glides
    of −0.5 to +1 octave from 196–660 Hz with a 5.5 Hz vibrato of ±0.3
    semitone, and loudness swells around (mean_loudness, std_loudness)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) * block / sample_rate
    dur = max(t[-1], 1e-9)
    start = rng.uniform(196.0, 660.0, (n_items, 1))
    octaves = rng.uniform(-0.5, 1.0, (n_items, 1))
    rate = rng.uniform(4.5, 6.5, (n_items, 1))
    vib = 0.3 / 12.0 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi, (n_items, 1)))
    pitch = start * 2.0 ** (octaves * t / dur + vib)
    swell = np.sin(np.pi * t / dur) * rng.uniform(0.5, 1.5, (n_items, 1))
    loud = mean_loudness + std_loudness * (swell - 0.5 + 0.2 * rng.standard_normal((n_items, 1)))
    return pitch.astype(np.float32), loud.astype(np.float32)


def _sine_render(pitch, block, sample_rate):
    """(N, F) frame pitch → (N, F·block) sine at that pitch, amplitude 0.3."""
    f0 = np.repeat(pitch.astype(np.float64), block, axis=1)
    return (0.3 * np.sin(np.cumsum(2 * math.pi * f0 / sample_rate, axis=1))).astype(np.float32)


def _union_us(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _cuda_kernels(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> dict:
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.models import init_params, load_model
    from ddsp_pytorch_tpu_torch.ops import oscillator as osc
    from ddsp_pytorch_tpu_torch.training import make_optimizer, make_train_step
    from ddsp_pytorch_tpu_torch.training.state import TrainState

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--frames", type=int, default=None, help="default: the config's n_frames")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    cfg = Config.from_yaml(args.config)
    kw = cfg.model.kwargs
    frames = args.frames or cfg.n_frames
    block, sr, batch_size = int(kw["block_size"]), int(kw["sample_rate"]), cfg.train.batch
    model = load_model(cfg.model.name, kw).to(device)
    generator = torch.Generator(device).manual_seed(cfg.train.seed)
    init_params(model, generator)
    tx = make_optimizer(cfg)
    state = TrainState(0, model, tx.init([q for _, q in model.named_parameters()]), generator,
                       -7.9, 0.55)
    step = make_train_step(model, tx, cfg)
    pitch, loud = glide_controls(batch_size, frames, block, sr, seed=1)
    batch = {
        "pitch": torch.tensor(pitch[..., None], device=device),
        "loudness": torch.tensor(loud[..., None], device=device),
        "sig": torch.tensor(_sine_render(pitch, block, sr), device=device),
    }

    def run(n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    run(2)  # warm-up: kernel build, cuFFT plans, cuBLAS handles
    untraced = run(args.steps)
    launches_before = (osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    osc_launches = (osc.oscillator_bank.launches - launches_before[0],
                    osc.oscillator_bank_bwd.launches - launches_before[1])
    kernels = _cuda_kernels(prof)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3

    # the GRU alone, forward and backward at the step's shapes
    gru = model.decoder.gru
    x = torch.randn(batch_size, frames, 2 * gru.hidden_size, device=device)
    out, _ = gru(x)
    out.sum().backward()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as gprof:
        out, _ = gru(x)
        out.sum().backward()
        torch.cuda.synchronize()
    gru_launches = len(_cuda_kernels(gprof))
    model.zero_grad(set_to_none=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    per_step = len(kernels) / args.steps
    result = {
        "card": card,
        "torch": torch.__version__,
        "config": args.config,
        "batch": batch_size,
        "frames": frames,
        "steps": args.steps,
        "untraced_step_ms": {
            "p50": float(np.percentile(untraced, 50)),
            "min": float(min(untraced)),
            "max": float(max(untraced)),
        },
        "traced_wall_ms": traced_wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / traced_wall_ms,
        "kernel_launches_per_step": per_step,
        "gru_fwd_bwd_launches": gru_launches,
        "gru_share_of_launches": gru_launches / per_step,
        "oscillator_launches_per_step": {
            "oscillator_fwd": osc_launches[0] / args.steps,
            "oscillator_bwd": osc_launches[1] / args.steps,
        },
        "kernels_by_device_time": [
            {"name": name[:160], "count": c, "device_ms": us / 1e3}
            for name, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:40]
        ],
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return result


if __name__ == "__main__":
    main()
