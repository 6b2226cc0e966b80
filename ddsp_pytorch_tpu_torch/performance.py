"""Synthesis benchmark: the reference's performance.py protocol on the port.

Port of the repository's performance.py:19-118 (`run_benchmark` and its
CLI).  The protocol: synthesize N = 2^ceil(log2 sample_rate) samples,
rounded down to whole blocks (65 536 at 48 kHz = 128 frames), from random
controls drawn by `np.random.default_rng(0)`, through one
`StreamingSynth.step` a call; report the mean wall-clock of `n_run` calls
and the ×-realtime factor.

    python -m ddsp_pytorch_tpu_torch.performance [--bundle DIR] [--n-run 10] \\
        [--batch 1] [--device cuda]

The model is a bundle (`make_streaming_synth`) or, with no bundle, a
Config's model with fresh weights (`init_params` from a seeded CPU
generator, so every device gets the same weights).  The controls are staged
on the device and stride-decimated to frame rate outside the timed calls.
One warm-up call precedes the timing.  Each timed call ends in
`torch.cuda.synchronize()`; `value_pull=True` ends it in the device→host
copy of the output (`.cpu()`) instead, the end-to-end figure a caller that
needs the samples sees.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.export import make_streaming_synth
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth


def make_synth(bundle=None, config: Config | None = None, batch: int = 1, device="cuda") -> StreamingSynth:
    """The benchmarked synth: a bundle's, or `config`'s model (default
    Config()) with fresh weights drawn from a CPU generator seeded 0."""
    if bundle is not None:
        return make_streaming_synth(bundle, batch=batch, device=device)
    config = Config() if config is None else config
    model = load_model(config.model.name, config.model.kwargs)
    init_params(model, torch.Generator().manual_seed(0))
    return StreamingSynth(
        model,
        mean_loudness=config.data.mean_loudness or 0.0,
        std_loudness=config.data.std_loudness or 1.0,
        batch=batch,
        device=device,
    )


def n_samples(sample_rate: int, block_size: int) -> int:
    """2^ceil(log2 sample_rate), rounded down to whole blocks."""
    n = 2 ** math.ceil(math.log2(sample_rate))
    return (n // block_size) * block_size


def protocol_controls(sample_rate: int, block_size: int, batch: int, device) -> tuple:
    """The protocol's random controls on `device`: pitch U(100, 400) Hz and
    standard-normal loudness at sample rate from default_rng(0),
    stride-decimated to (batch, frames, 1) frame rate."""
    n = n_samples(sample_rate, block_size)
    rng = np.random.default_rng(0)
    pitch = rng.uniform(100, 400, (batch, n)).astype(np.float32)
    loud = rng.standard_normal((batch, n)).astype(np.float32)
    return (torch.tensor(pitch[:, ::block_size, None], device=device),
            torch.tensor(loud[:, ::block_size, None], device=device))


def stage_controls(synth: StreamingSynth, batch: int) -> tuple:
    """`protocol_controls` at the synth's rate and block, on its device."""
    return protocol_controls(synth.sample_rate, synth.block_size, batch, synth.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_benchmark(bundle=None, n_run: int = 10, batch: int = 1, config: Config | None = None,
                  protocol_runs: int = 1, discard_first: bool = False, value_pull: bool = False,
                  device="cuda") -> dict:
    """Benchmark a bundle, a Config's model (fresh weights), or the default
    Config's.  bench.py runs this with its headline config.

    protocol_runs > 1 repeats the timed protocol (the mean of n_run calls)
    on the same synth and reports the best mean; discard_first throws the
    first protocol run away.  value_pull=True ends each timed call in the
    output's copy to the host instead of a synchronize.

    Returns mean_ms, audio_ms, x_realtime, samples_per_s, batch,
    sample_rate, device_name and calls (the synth steps made, warm-up
    included: one oscillator-kernel launch each on a card)."""
    device = resolve_device(device)
    synth = make_synth(bundle, config, batch, device)
    sr = synth.sample_rate
    n = n_samples(sr, synth.block_size)
    f0, lo = stage_controls(synth, batch)
    _sync(device)
    calls = 0

    def call():
        nonlocal calls
        calls += 1
        out = synth.step(f0, lo)
        if value_pull:
            out.cpu()  # waits for the render, then copies it to the host
        else:
            _sync(device)

    call()  # warm-up: kernel library load, cuBLAS handles, allocator

    def protocol_mean() -> float:
        mean = 0.0
        for i in range(n_run):
            st = time.perf_counter()
            call()
            mean += (time.perf_counter() - st - mean) / (i + 1)
        return mean

    if discard_first:
        protocol_mean()
    mean = min(protocol_mean() for _ in range(max(1, protocol_runs)))
    return {
        "mean_ms": 1000 * mean,
        "audio_ms": 1000 * n / sr,
        "x_realtime": batch * n / (mean * sr),
        "samples_per_s": batch * n / mean,
        "batch": batch,
        "sample_rate": sr,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "calls": calls,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bundle", default=None)
    p.add_argument("--n-run", type=int, default=10)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    r = run_benchmark(args.bundle, args.n_run, args.batch, device=args.device)
    smiley = ":)" if r["x_realtime"] >= 1 else ":("
    print(f"average of {r['mean_ms']:.2f}ms to generate {r['audio_ms']:.2f}ms "
          f"over {args.n_run} trials (batch {r['batch']}, {r['device_name']})")
    print(f"generation is {r['x_realtime']:.2f}x realtime {smiley}")
    print(80 * "-")
    return r


if __name__ == "__main__":
    main()
