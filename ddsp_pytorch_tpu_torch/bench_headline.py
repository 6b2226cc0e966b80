"""Headline benchmarks: the repository's five workload configs on the port.

Port of scripts/bench_headline.py:1-305.  Each config prints ONE JSON line
with the JAX script's keys, plus where it ran (`device`), the card's name
and power limit as nvidia-smi prints them (`card`) and the `reps` timed:

  1. single-voice 16 kHz decoder forward, on the CPU: the JAX script's
     CPU-portability bar.  Its definition asks for the CPU, so it runs
     there, in a subprocess when other configs run too (a process of its
     own, as the JAX script's platform pin needs one); it is no fallback.
  2. 48 kHz 100-harmonic voice + noise + in-stream reverb, batch 1: one
     `StreamingSynth.step` of 65 536 samples a call.
  3. the reference workload's train step at batch 16 (4 s at 48 kHz,
     hidden 512, 64 harmonics, 65 bands, reverb, 6-scale loss, Adam, the
     full backward), as the Trainer runs it on the card: a call of
     STEPS_PER_CALL steps replaying the CUDA graph of one step
     (`MultiStep`); the eager step beside it.
  4. the same step at batch 64 (the multi-instrument family batch).
  5. long-form synthesis: 32 voices × 8 s through LongFormSynthesizer,
     decoder + oscillator + noise + the full-second reverb, no mesh
     (the in-process 1 × 1 mesh).

    python -m ddsp_pytorch_tpu_torch.bench_headline [--configs 1,2,3,4,5] \\
        [--reps-scale S] [--device cuda]

Timing is the JAX script's `_bestmean` (:31-44): one warm-up call, then
the best of 3 means of `reps` calls, each call ending in a synchronize (on
the card; the CPU's calls are synchronous).  --reps-scale scales every
config's reps (at least 1 a mean).  Weights are fresh (`init_params` from a
CPU generator seeded 0), controls from `np.random.default_rng(0)`.  The
device defaults to the card and there is no fallback; only config 1 runs
on the CPU, because its definition asks for it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import init_params, load_model

SR, BLOCK = 48000, 512
REFERENCE_KWARGS = dict(hidden_size=512, n_harmonic=64, n_bands=65, sample_rate=SR,
                        block_size=BLOCK, has_reverb=True)
REFERENCE_SCALES = [4096, 2048, 1024, 512, 256, 128]
# reps of each config's mean, as in the JAX script
REPS = {1: 5, 2: 20, 3: 30, 4: 30, 5: 5}
OUTER = 3  # means; the best is reported
# steps a graphed call of configs 3 and 4 (one graph of one step, replayed)
STEPS_PER_CALL = 10


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bestmean(fn: Callable[[], object], reps: int, device: torch.device, outer: int = OUTER) -> float:
    """Best of `outer` means of `reps` synchronized calls of fn, after one
    warm-up call (bench_headline.py:31-44); seconds."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(outer):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            sync(device)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def card_of(device: torch.device) -> Optional[str]:
    if device.type != "cuda":
        return None
    from ddsp_pytorch_tpu_torch.kernel_bench import card_line

    return card_line()


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _fresh_model(kwargs: dict, device):
    model = load_model("single-inst-decoder", kwargs)
    init_params(model, torch.Generator().manual_seed(0))
    return model.to(device)


def config_1(reps: int = REPS[1], kwargs: Optional[dict] = None, signal_length: int = 64000) -> dict:
    """Single-voice 16 kHz decoder forward on the CPU: one 4 s clip, block
    256, hidden 512, 64 harmonics, 65 bands, reverb."""
    kwargs = {**REFERENCE_KWARGS, "sample_rate": 16000, "block_size": 256, **(kwargs or {})}
    cpu = torch.device("cpu")
    model = _fresh_model(kwargs, cpu).eval()
    f = signal_length // kwargs["block_size"]
    batch = {"pitch": torch.full((1, f, 1), 220.0), "loudness": torch.zeros((1, f, 1))}
    generator = torch.Generator().manual_seed(0)

    @torch.inference_mode()
    def fwd():
        return model(batch, generator=generator)["signal"]

    mean = bestmean(fwd, reps, cpu)
    return {"config": 1, "desc": "single-voice 16kHz decoder forward, CPU",
            "ms": 1000 * mean, "x_realtime": signal_length / kwargs["sample_rate"] / mean,
            "device": "cpu", "reps": reps}


def config_2(device, reps: int = REPS[2], kwargs: Optional[dict] = None) -> dict:
    """48 kHz 100-harmonic voice + noise + in-stream reverb, batch 1, 65 536
    samples a call."""
    from ddsp_pytorch_tpu_torch.streaming import StreamingSynth

    device = resolve_device(device)
    kwargs = {**REFERENCE_KWARGS, "n_harmonic": 100, **(kwargs or {})}
    synth = StreamingSynth(_fresh_model(kwargs, device), batch=1, include_reverb=True, device=device)
    block = synth.block_size
    n = 65536 // block * block
    rng = np.random.default_rng(0)
    f0 = torch.tensor(rng.uniform(100, 400, (1, n // block, 1)).astype(np.float32), device=device)
    lo = torch.tensor(rng.standard_normal((1, n // block, 1)).astype(np.float32), device=device)
    mean = bestmean(lambda: synth.step(f0, lo), reps, device)
    return {"config": 2, "desc": "48kHz 100-harm voice + noise + in-stream reverb, batch 1",
            "ms_per_call": 1000 * mean, "x_realtime": n / synth.sample_rate / mean,
            "device": device_name(device), "reps": reps}


def train_config(batch_size: int, kwargs: Optional[dict] = None, signal_length: int = 192000,
                 scales=None) -> Config:
    """The reference workload's training config at `batch_size`
    (bench_headline.py:132-157); `kwargs` override the model's."""
    kwargs = {**REFERENCE_KWARGS, **(kwargs or {})}
    return Config.from_dict({
        "preprocess": {"sample_rate": kwargs["sample_rate"], "signal_length": signal_length,
                       "block_size": kwargs["block_size"]},
        "model": {"name": "single-inst-decoder", "kwargs": kwargs},
        "train": {"batch": batch_size, "scales": list(scales or REFERENCE_SCALES), "overlap": 0.75},
    })


def train_batch(config: Config, device, seed: int = 0) -> dict:
    """The JAX script's batch (bench_headline.py:159-171): noise targets
    of 0.1 std, pitch U(100, 400) Hz, standard-normal loudness."""
    b, t = config.train.batch, config.preprocess.signal_length
    f = t // config.preprocess.block_size
    rng = np.random.default_rng(seed)
    batch = {"sig": rng.standard_normal((b, t)).astype(np.float32) * np.float32(0.1),
             "pitch": rng.uniform(100, 400, (b, f, 1)).astype(np.float32),
             "loudness": rng.standard_normal((b, f, 1)).astype(np.float32)}
    return {k: torch.tensor(v, device=device) for k, v in batch.items()}


def time_train_step(config: Config, device, reps: int, eager_reps: Optional[int] = None) -> dict:
    """ms a train step of `config`: eager (one synchronized step a call)
    and, on the card, graphed as the Trainer runs it (calls of
    STEPS_PER_CALL steps, one CUDA graph of a step replayed).  Both under
    the bestmean protocol, from one Trainer's fresh state; graphed `reps`
    counts steps (rounded up to whole calls)."""
    from ddsp_pytorch_tpu_torch.training import Trainer
    from ddsp_pytorch_tpu_torch.training.train import make_train_multi_step

    device = resolve_device(device)
    eager_reps = reps if eager_reps is None else eager_reps
    batch = train_batch(config, device)
    with tempfile.TemporaryDirectory(prefix="ddsp_bench_") as tmp:
        trainer = Trainer(config, tmp, device=device, use_tensorboard=False)
        try:
            state = trainer.init_state()
            eager = bestmean(lambda: trainer._train_step(state, batch), eager_reps, device)
            out = {"eager_ms_per_step": 1000 * eager, "eager_reps": eager_reps}
            if device.type == "cuda":
                multi = make_train_multi_step(trainer.model, trainer.tx, config, STEPS_PER_CALL)
                stacked = {k: v.unsqueeze(0).expand(STEPS_PER_CALL, *v.shape)
                           for k, v in batch.items()}
                calls = max(1, math.ceil(reps / STEPS_PER_CALL))
                graphed = bestmean(lambda: multi(state, stacked), calls, device) / STEPS_PER_CALL
                out.update(graphed_ms_per_step=1000 * graphed, graphed_reps=calls * STEPS_PER_CALL,
                           capture_s=multi.capture_s)
            step = out.get("graphed_ms_per_step", out["eager_ms_per_step"])
        finally:
            trainer.close()
    b, t = config.train.batch, config.preprocess.signal_length
    out.update(ms_per_step=step, steps_per_s=1000.0 / step, gsamples_per_s=b * t / step / 1e6)
    return out


def _train_line(n: int, batch_size: int, desc: str, device, reps: int, eager_reps, kwargs,
                signal_length: int, scales) -> dict:
    device = resolve_device(device)
    r = time_train_step(train_config(batch_size, kwargs, signal_length, scales), device, reps, eager_reps)
    return {"config": n, "desc": desc, "ms_per_step": r["ms_per_step"], "steps_per_s": r["steps_per_s"],
            "gsamples_per_s": r["gsamples_per_s"],
            "step": "graphed" if "graphed_ms_per_step" in r else "eager",
            **{k: v for k, v in r.items() if k not in ("ms_per_step", "steps_per_s", "gsamples_per_s")},
            "dtype": (kwargs or {}).get("dtype", "float32"), "device": device_name(device)}


def config_3(device, reps: int = REPS[3], eager_reps: Optional[int] = None,
             kwargs: Optional[dict] = None, signal_length: int = 192000, scales=None) -> dict:
    """The reference workload's train step at batch 16."""
    return _train_line(3, 16, "training step, reference workload (batch 16, 4s@48kHz, 6-scale loss, "
                              "reverb, Adam, full backward)", device, reps, eager_reps, kwargs,
                       signal_length, scales)


def config_4(device, reps: int = REPS[4], eager_reps: Optional[int] = None,
             kwargs: Optional[dict] = None, signal_length: int = 192000, scales=None) -> dict:
    """The same step at batch 64 on one card."""
    return _train_line(4, 64, "multi-instrument training step, batch 64 (sax+violin+flute family "
                              "batch), 1 card", device, reps, eager_reps, kwargs, signal_length, scales)


def config_5(device, reps: int = REPS[5], kwargs: Optional[dict] = None, voices: int = 32,
             seconds: int = 8) -> dict:
    """Long-form synthesis: `voices` × `seconds` through LongFormSynthesizer
    on the in-process 1 × 1 mesh (no sharding), reverb included."""
    from ddsp_pytorch_tpu_torch.parallel import LongFormSynthesizer, make_mesh

    device = resolve_device(device)
    kwargs = {**REFERENCE_KWARGS, **(kwargs or {})}
    sr, block = kwargs["sample_rate"], kwargs["block_size"]
    sl = seconds * sr // block * block
    f = sl // block
    synth = LongFormSynthesizer(_fresh_model(kwargs, device).eval(), make_mesh(data=1, time=1))
    rng = np.random.default_rng(0)
    f0 = torch.tensor(rng.uniform(100, 400, (voices, f, 1)).astype(np.float32), device=device)
    lo = torch.tensor(rng.standard_normal((voices, f, 1)).astype(np.float32), device=device)
    generator = torch.Generator(device).manual_seed(0)
    mean = bestmean(lambda: synth.synthesize(f0, lo, generator=generator), reps, device)
    total = voices * sl
    return {"config": 5,
            "desc": f"long-form synthesis slab: {voices} voices x {seconds}s (decoder + oscillator + "
                    "noise + full-IR reverb), 1 card",
            "ms": 1000 * mean, "gsamples_per_s": total / mean / 1e9,
            "x_realtime_aggregate": total / sr / mean,
            "min_of_256voice_10min_on_this_chip_s": 256 * 600 * sr / (total / mean),
            "device": device_name(device), "reps": reps}


def _scaled(n: int, scale: float) -> int:
    return max(1, round(REPS[n] * scale))


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", default="1,2,3,4,5")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; config 1 runs on the CPU")
    p.add_argument("--reps-scale", type=float, default=1.0,
                   help="scale every config's reps (at least 1 a mean)")
    args = p.parse_args(argv)
    try:
        wanted = sorted({int(c) for c in args.configs.split(",")})
    except ValueError:
        p.error(f"--configs must be comma-separated integers, got {args.configs!r}")
    bad = [c for c in wanted if c not in REPS]
    if bad:
        p.error(f"unknown config id(s) {bad}; valid: 1-5")
    device = resolve_device(args.device)
    card = card_of(device)
    lines = []

    def emit(line):
        line["card"] = card
        print(json.dumps(line), flush=True)
        lines.append(line)

    if 1 in wanted and len(wanted) > 1:
        # config 1 runs on the CPU in a process of its own
        cmd = [sys.executable, "-m", "ddsp_pytorch_tpu_torch.bench_headline", "--configs", "1",
               "--device", args.device, "--reps-scale", str(args.reps_scale)]
        package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(x for x in (package_root, env.get("PYTHONPATH")) if x)
        out = subprocess.run(cmd, env=env, check=True, capture_output=True, text=True).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        lines.append(line)
        wanted.remove(1)
    runners = {
        1: lambda: config_1(_scaled(1, args.reps_scale)),
        2: lambda: config_2(device, _scaled(2, args.reps_scale)),
        3: lambda: config_3(device, _scaled(3, args.reps_scale)),
        4: lambda: config_4(device, _scaled(4, args.reps_scale)),
        5: lambda: config_5(device, _scaled(5, args.reps_scale)),
    }
    for c in wanted:
        emit(runners[c]())
    return lines


if __name__ == "__main__":
    main()
