"""Where a training step's time goes on the GPU, eager and as a CUDA graph.

    python -m ddsp_pytorch_tpu_torch.profile_training \\
        [--config configs/config.yaml] [--steps 5] [--frames N] \\
        [--steps-per-call N] [--unroll U] [--out FILE]

The counterpart of ddsp_pytorch_tpu/training/profiling.py on
torch.profiler.  Builds the config's model with fresh weights on CUDA and a
batch of `train.batch` pitch glides with vibrato (targets from a plain sine
render; the time of a step does not depend on the data), warms up, then runs
`--steps` eager train steps twice: untraced (ms per step on the host clock,
each step ending in torch.cuda.synchronize()), then under torch.profiler.
From the trace it reports the device-busy time (the union of kernel
intervals) against the traced wall time, the kernels launched per step, the
kernels ranked by device time, and, from one separately traced forward and
backward of each GRU alone at the same shapes (the decoder's; for the
mfcc-autoencoder, `configs/autoencoder.yaml` or
`pretrained/ddsp_violin_ae_config.yaml`, the encoder's too), how many of a
step's launches and what share of its device time each 375-frame GRU loop
takes.  The autoencoder's batch carries the MFCCs of its targets
(preprocess geometry and dB reference of the config).

It also times the eager step fed from host (numpy) batches, as the Trainer
feeds it without the device-resident loader: through a pageable copy
(`to_device`) and through `HostBatchStager` (a pinned buffer and a
non-blocking copy), in alternating turns of back-to-back steps, and the
copy alone, synced.

With --steps-per-call N > 1 it then times the same step as the Trainer runs
it at steps_per_call N: a MultiStep replaying a CUDA graph of --unroll U
steps, N / U replays a call.  It reports the capture (and instantiation)
time, the device memory the capture reserved, ms per step over synced calls
on the host clock, and from one traced call the device-busy share and the
kernels per step, beside the oscillator kernels' launches per step as the
wrappers count them: `captured` per graph and `replayed` per step.  Prints
one JSON object and writes it to --out if given.  Needs a CUDA card.
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

from ddsp_pytorch_tpu_torch.training.profiling import device_kernels


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


GRAPHED_CALLS = 3  # synced calls of --steps-per-call steps timed
HOST_FEED_TURNS = 4  # alternating turns of each host-batch feed
HOST_FEED_STEPS = 3  # back-to-back eager steps a turn, then one synchronize


def _traced(run, n_steps: int) -> dict:
    """Trace `run()` (which trains `n_steps` steps and synchronizes) under
    torch.profiler: wall time, device-busy time (the union of kernel
    intervals), idle share, device events per step, device ms by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms = device_kernels(prof)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    return {
        "traced_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_ms_per_step": busy_ms / n_steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / n_steps,
        "kernels_by_device_time": [
            {"name": name[:160], "count": c, "device_ms": us / 1e3}
            for name, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:40]
        ],
    }


def _gru_alone(gru, batch_size: int, frames: int, device) -> dict:
    """Device launches and device ms (the union of its kernels' intervals)
    of one forward and backward of the GRU alone at the step's shapes.  Its
    autograd graph dies with this frame: a graph kept alive keeps the
    parameters' gradient accumulators on this stream, which a captured
    step's backward would then have to join (an error under capture)."""
    x = torch.randn(batch_size, frames, gru.weight_ih.shape[1], device=device)
    gru(x)[0].sum().backward()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        gru(x)[0].sum().backward()
        torch.cuda.synchronize()
    kernels, busy_ms = device_kernels(prof)
    return {"launches": len(kernels), "device_ms": busy_ms}


def _synced_ms(run, n: int) -> list:
    """Host-clock ms of `n` runs, each ending in torch.cuda.synchronize()."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _stats(times) -> dict:
    return {"p50": float(np.percentile(times, 50)), "min": float(min(times)), "max": float(max(times))}


def _host_feeds(step, state, batch, device) -> dict:
    """The eager step fed from host (numpy) batches, through a pageable copy
    and through HostBatchStager, in alternating turns: ms per step over
    HOST_FEED_STEPS back-to-back steps a turn (one synchronize at the end),
    and ms of the copy alone, synced."""
    from ddsp_pytorch_tpu_torch.training.train import HostBatchStager, to_device

    host = {k: v.cpu().numpy() for k, v in batch.items()}
    stager = HostBatchStager(device)
    feeds = {"pageable": lambda: to_device(host, device), "pinned_stager": lambda: stager(host)}
    step_ms = {name: [] for name in feeds}
    copy_ms = {name: [] for name in feeds}
    for feed in feeds.values():
        _synced_ms(lambda: step(state, feed()), 1)  # warm-up: pinned buffers, allocator
    for _ in range(HOST_FEED_TURNS):
        for name, feed in feeds.items():
            copy_ms[name] += _synced_ms(feed, HOST_FEED_STEPS)
            turn = _synced_ms(lambda: [step(state, feed()) for _ in range(HOST_FEED_STEPS)], 1)
            step_ms[name].append(turn[0] / HOST_FEED_STEPS)
    return {
        "batch_bytes": sum(v.nbytes for v in host.values()),
        **{name: {"step_ms": _stats(step_ms[name]), "copy_ms": _stats(copy_ms[name])} for name in feeds},
    }


def main(argv=None) -> dict:
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.models import init_params, load_model
    from ddsp_pytorch_tpu_torch.ops import kernels
    from ddsp_pytorch_tpu_torch.ops.spectral import mfcc
    from ddsp_pytorch_tpu_torch.training import make_optimizer, make_train_step
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import make_train_multi_step

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--frames", type=int, default=None, help="default: the config's n_frames")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="also time the graphed step at this steps_per_call")
    p.add_argument("--unroll", type=int, default=1, help="steps captured in one graph")
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
    autoencoder = cfg.model.name == "mfcc-autoencoder"
    if autoencoder:
        pc = cfg.preprocess
        batch["mfcc"] = mfcc(batch["sig"], sr, n_mfcc=pc.n_mfcc, n_fft=pc.mfcc_n_fft, hop_length=block,
                             fmin=pc.mfcc_fmin, fmax=pc.mfcc_fmax, n_mels=pc.n_mels,
                             ref_db=pc.mfcc_ref_db)[:, :frames].contiguous()

    def run_eager(n):
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()

    _synced_ms(lambda: run_eager(1), 2)  # warm-up: kernel build, cuFFT plans, cuBLAS handles
    torch.cuda.reset_peak_memory_stats(device)
    untraced = _synced_ms(lambda: run_eager(1), args.steps)
    eager_peak = torch.cuda.max_memory_allocated(device)
    kernels.reset_counts()
    eager = _traced(lambda: run_eager(args.steps), args.steps)
    eager_counts = kernels.counts()

    host_feeds = _host_feeds(step, state, batch, device)
    grus = {"decoder": model.decoder.gru}
    if autoencoder:
        grus["encoder"] = model.encoder.GRU_0
    gru = {name: _gru_alone(g, batch_size, frames, device) for name, g in grus.items()}
    for g in gru.values():
        g["share_of_launches"] = g["launches"] / eager["kernel_launches_per_step"]
        g["share_of_device_ms"] = g["device_ms"] / eager["device_busy_ms_per_step"]
    model.zero_grad(set_to_none=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    result = {
        "card": card,
        "torch": torch.__version__,
        "config": args.config,
        "model": cfg.model.name,
        "batch": batch_size,
        "frames": frames,
        "steps": args.steps,
        "untraced_step_ms": _stats(untraced),
        "peak_memory_bytes": eager_peak,
        **{k: v for k, v in eager.items() if k != "kernels_by_device_time"},
        "gru_fwd_bwd_alone": gru,
        "oscillator_launches_per_step": {
            name: eager_counts[name]["launches"] / args.steps for name in ("oscillator_fwd", "oscillator_bwd")
        },
        "kernels_by_device_time": eager["kernels_by_device_time"],
        "host_batch_feeds": host_feeds,
    }

    if args.steps_per_call > 1:
        n = args.steps_per_call
        multi = make_train_multi_step(model, tx, cfg, n, args.unroll)
        batches = {k: v.expand(n, *v.shape).contiguous() for k, v in batch.items()}
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_counts()
        t0 = time.perf_counter()
        multi(state, batches)  # the first call captures the graph
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        warmup = kernels.counts()
        calls = _synced_ms(lambda: multi(state, batches), GRAPHED_CALLS)
        graph_peak = torch.cuda.max_memory_allocated(device)
        kernels.reset_counts()
        graphed = _traced(lambda: (multi(state, batches), torch.cuda.synchronize()), n)
        counts = kernels.counts()
        result["graphed"] = {
            "steps_per_call": n,
            "unroll": args.unroll,
            "capture_s": multi.capture_s,
            "first_call_s": first_call_s,
            "graph_pool_bytes": multi.pool_bytes,
            "peak_memory_bytes": graph_peak,
            "call_ms": _stats(calls),
            "step_ms": _stats([c / n for c in calls]),
            **{k: v for k, v in graphed.items() if k != "kernels_by_device_time"},
            "oscillator_launches": {
                name: {"captured_per_graph": multi.captured[name],
                       "replayed_per_step": counts[name]["replayed"] / n,
                       "host_launches_per_step": counts[name]["launches"] / n,
                       "warmup_host_launches": warmup[name]["launches"]}
                for name in ("oscillator_fwd", "oscillator_bwd")
            },
            "kernels_by_device_time": graphed["kernels_by_device_time"][:20],
        }
        result["graphed_speedup"] = result["untraced_step_ms"]["p50"] / result["graphed"]["step_ms"]["p50"]

    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return result


if __name__ == "__main__":
    main()
