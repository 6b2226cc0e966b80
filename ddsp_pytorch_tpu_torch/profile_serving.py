"""Where a served block's time goes on the GPU.

    python -m ddsp_pytorch_tpu_torch.profile_serving \\
        [--bundle pretrained/ddsp_violin_bundle] [--blocks 64] [--out FILE]

Streams `--blocks` blocks of a pitch glide through make_streaming_synth on
CUDA twice after a warm-up: once untraced (per-block render time on the
host clock, each block ending in torch.cuda.synchronize()), then under
torch.profiler.  From the trace it reports the device-busy time (the union
of kernel intervals) against the traced wall time, the kernels launched
per block, and every kernel ranked by device time.  Prints one JSON object
and writes it to --out if given.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch


def glide(n_blocks: int, block: int):
    """Sample-rate pitch glide 196 → 1568 Hz (G3 → G6, the violin's range)
    with a loudness swell, (1, n_blocks·block) each."""
    t = np.linspace(0.0, 1.0, n_blocks * block)
    pitch = (196.0 * 2.0 ** (3.0 * t)).astype(np.float32)[None]
    loud = (-9.0 + 3.0 * np.sin(np.pi * t)).astype(np.float32)[None]
    return pitch, loud


def _stream(synth, pitch, loud, n_blocks):
    block = synth.block_size
    times = []
    for i in range(n_blocks):
        sl = slice(i * block, (i + 1) * block)
        t0 = time.perf_counter()
        synth.step_samples(pitch[:, sl], loud[:, sl])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _union_us(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> dict:
    from ddsp_pytorch_tpu_torch.export import make_streaming_synth

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bundle", default="pretrained/ddsp_violin_bundle")
    p.add_argument("--blocks", type=int, default=64)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    synth = make_streaming_synth(args.bundle, device="cuda")
    pitch, loud = glide(args.blocks, synth.block_size)
    _stream(synth, pitch, loud, min(8, args.blocks))  # warm-up
    synth.reset()
    untraced = _stream(synth, pitch, loud, args.blocks)

    synth.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _stream(synth, pitch, loud, args.blocks)
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    result = {
        "card": card,
        "torch": torch.__version__,
        "bundle": args.bundle,
        "blocks": args.blocks,
        "budget_ms": 1e3 * synth.block_size / synth.sample_rate,
        "untraced_render_ms": {
            "p50": float(np.percentile(untraced, 50)),
            "p99": float(np.percentile(untraced, 99)),
            "max": float(max(untraced)),
        },
        "traced_wall_ms": traced_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_wall_ms,
        "kernel_launches_per_block": len(kernels) / args.blocks,
        "kernels_by_device_time": [
            {"name": name[:160], "count": c, "device_ms": us / 1e3}
            for name, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])
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
