"""Where the reference train step's device time goes, stage by stage, the
card's own ceilings for each stage's kind of work, and the bf16 verdict.

Port of scripts/bench_step_breakdown.py.  The stages of the reference
workload's step (batch 16, 48 kHz, 4 s chunks, hidden 512, 64 harmonics,
65 bands, reverb, 6-scale loss; configs/config.yaml), each timed alone at
the reference batch and at a throughput batch (:11-19):

  gru_controls   GRUDecoder + projections (the frame-rate NN)
  oscillator     HarmonicSynth from fixed controls (the forward kernel)
  noise          FilteredNoise (FIR design + FFT convolution)
  reverb         Reverb (the full-second IR by FFT convolution)
  loss           the 6-scale STFT L1 of (reconstruction, target)
  optimizer      the Adam update at the parameter count
  full_fwd       the whole forward
  full_step      forward + backward + update: the Trainer's graphed step

Protocol (:44-80 there: N dependent iterations under one jit): on the card
one CUDA graph holds `iters` iterations of a stage, so dispatch is
excluded, and CUDA events around a replay give its device time; the best
of REPLAYS replays, over `iters`.  full_step is `iters` steps of one
`MultiStep` call (a graph of one step replayed, the noise drawn between
replays) between events.  On the CPU the host clock times `iters` calls.

Ceilings (:243-300), measured on the same card by the same protocol:
512-class matmuls ((16·375, 512) @ (512, 1536)) in float32 (TF32 off) and
in bf16 (float32 reduction) as TFLOP/s, batched rfft(4096) as GFLOP/s
(5 N log2 N a transform) and a saxpy over 64 MB as GB/s.

The bf16 verdict (:356-363): full_step and gru_controls with the model's
dtype bfloat16 at each batch, measured in turns with float32 (a graphed
step's time moves ~10 % between calls), and each speed-up (mean float32
ms over mean bf16 ms).  It is a measurement, reported whatever its sign.

    python -m ddsp_pytorch_tpu_torch.bench_step_breakdown [--batches 16,128] \\
        [--iters 20] [--out FILE] [--device cuda]

Prints the ceilings and each batch's entry as JSON, the card's name and
power limit beside them, and writes the whole report to --out.  The device
defaults to the card and there is no fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import tempfile
import time
from typing import Callable, Optional

import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.bench_headline import card_of, device_name, train_batch, train_config
from ddsp_pytorch_tpu_torch.models.decoder import matmul_precision

STAGES = ("gru_controls", "oscillator", "noise", "reverb", "loss", "optimizer", "full_fwd", "full_step")
FWD_STAGES = ("gru_controls", "oscillator", "noise", "reverb")
VERDICT_STAGES = ("gru_controls", "full_step")
REPLAYS = 5  # timed replays (or loops on the CPU); the best is kept
WARMUP_RUNS = 2  # eager runs before a capture (kernel builds, cuFFT plans, cuBLAS handles)


@contextlib.contextmanager
def _no_tf32():
    matmul = torch.backends.cuda.matmul
    previous = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = previous


def timed_loop(fn: Callable[[], object], iters: int, device: torch.device,
               replays: int = REPLAYS) -> float:
    """Seconds an iteration of fn: on the card the device time of one CUDA
    graph of `iters` calls (best of `replays` replays); on the CPU the host
    time of `iters` calls (best of `replays` loops)."""
    if device.type != "cuda":
        fn()
        best = float("inf")
        for _ in range(replays):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) / iters)
        return best
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_RUNS):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / iters)
    del graph
    torch.cuda.empty_cache()
    return best


def _timed_calls(fn: Callable[[], object], iters: int, device: torch.device,
                 replays: int = REPLAYS) -> float:
    """Seconds an iteration of fn() (which runs `iters` iterations itself),
    between CUDA events on the card, the host clock on the CPU; after one
    warm-up call, best of `replays`."""
    fn()
    best = float("inf")
    for _ in range(replays):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            secs = time.perf_counter() - t0
        best = min(best, secs / iters)
    return best


def measure_stages(batch_size: int, iters: int, device, dtype: str = "float32",
                   stages=STAGES, kwargs: Optional[dict] = None, signal_length: int = 192000,
                   scales=None) -> tuple:
    """({stage: seconds an iteration}, parameter count) of the reference
    step at `batch_size` with the model's dtype `dtype`, for the `stages`
    asked for.  `kwargs`, `signal_length`, `scales` shrink the workload (the
    tests)."""
    from ddsp_pytorch_tpu_torch.training import Trainer
    from ddsp_pytorch_tpu_torch.training.loss import spectral_loss_from_signals
    from ddsp_pytorch_tpu_torch.training.train import _normalize_loudness, make_train_multi_step

    device = resolve_device(device)
    config = train_config(batch_size, {**(kwargs or {}), "dtype": dtype}, signal_length, scales)
    batch = train_batch(config, device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="ddsp_breakdown_") as tmp, _no_tf32():
        trainer = Trainer(config, tmp, device=device, use_tensorboard=False)
        try:
            state = trainer.init_state()
            model, tx = trainer.model, trainer.tx
            params = state.params()
            model_batch = _normalize_loudness(batch, state.mean_loudness, state.std_loudness)
            scales, overlap = tuple(config.train.scales), config.train.overlap
            noise = torch.rand(batch["pitch"].shape[:2] + (model.block_size,),
                               generator=torch.Generator(device).manual_seed(1), device=device) * 2 - 1
            with torch.no_grad():
                harmonic_ctrls, noise_ctrls = model.frame_controls(model_batch["pitch"],
                                                                   model_batch["loudness"])
                rec = model(model_batch, noise=noise)["signal"]
                grads = [p * 1e-30 for p in params]

            @torch.no_grad()
            def run(stage):
                if stage == "gru_controls":
                    return model.frame_controls(model_batch["pitch"], model_batch["loudness"])
                if stage == "oscillator":
                    return model.harmonic_synth(**harmonic_ctrls)
                if stage == "noise":
                    return model.noise_synth(**noise_ctrls, noise=noise)
                if stage == "reverb":
                    return model.reverb(rec)
                if stage == "loss":
                    return spectral_loss_from_signals(batch["sig"], rec, scales, overlap)
                if stage == "optimizer":
                    return tx.update(grads, state.opt_state)
                return model(model_batch, noise=noise)

            for stage in stages:
                if stage == "full_step":
                    multi = make_train_multi_step(model, tx, config, iters)
                    stacked = {k: v.unsqueeze(0).expand(iters, *v.shape) for k, v in batch.items()}
                    out[stage] = _timed_calls(lambda: multi(state, stacked), iters, device)
                else:
                    out[stage] = timed_loop(lambda: run(stage), iters, device)
        finally:
            trainer.close()
    return out, sum(p.numel() for p in params)


def measure_ceilings(device, rows: int = 16 * 375, n_fft: int = 4096, fft_batch: int = 16 * 184,
                     saxpy_n: int = 16 * 1024 * 1024, iters: int = 20) -> dict:
    """The card's ceilings for the stages' kinds of work (:243-300 there):
    512-class matmul TFLOP/s in float32 and in bf16, rfft(n_fft) GFLOP/s,
    saxpy GB/s."""
    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(1)
    out = {}
    x = torch.randn((rows, 512), generator=g, device=device)
    w = torch.randn((512, 1536), generator=g, device=device)
    flops = 2 * rows * 512 * 1536
    with _no_tf32(), matmul_precision():
        out["matmul_f32_tflops"] = flops / timed_loop(lambda: x @ w, iters, device) / 1e12
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        out["matmul_bf16_tflops"] = flops / timed_loop(lambda: xb @ wb, iters, device) / 1e12
    sig = torch.randn((fft_batch, n_fft), generator=g, device=device)
    s = timed_loop(lambda: torch.fft.rfft(sig), iters, device)
    out["fft4096_gflops"] = 5 * n_fft * math.log2(n_fft) * fft_batch / s / 1e9
    out["fft4096_s_per_batch"] = s
    a = torch.randn((saxpy_n,), generator=g, device=device)
    b = torch.randn((saxpy_n,), generator=g, device=device)
    s = timed_loop(lambda: torch.add(b, a, alpha=1.0001), iters, device)
    out["hbm_saxpy_gbps"] = 3 * 4 * saxpy_n / s / 1e9  # 2 reads + 1 write
    return out


def batch_entry(batch_size: int, iters: int, device, **workload) -> dict:
    """One batch's entry: the stages in float32, their sums against the
    whole forward and step, and the bf16 verdict: full_step and
    gru_controls measured in turns, float32, bf16, float32, bf16 (the
    first float32 turn is the stages' own), each turn's ms kept, and each
    speed-up the mean float32 ms over the mean bf16 ms."""
    stages, n_params = measure_stages(batch_size, iters, device, **workload)
    turns = {"float32": [stages], "bfloat16": []}
    for dtype in ("bfloat16", "float32", "bfloat16"):
        turns[dtype].append(measure_stages(batch_size, iters, device, dtype, VERDICT_STAGES, **workload)[0])
    ms = {stage: {dtype: [t[stage] * 1e3 for t in ts] for dtype, ts in turns.items()}
          for stage in VERDICT_STAGES}
    mean = {stage: {dtype: sum(v) / len(v) for dtype, v in by.items()} for stage, by in ms.items()}
    total = stages["full_step"]
    accounted = sum(stages[k] for k in STAGES[:6])
    return {
        "stages_ms": {k: v * 1e3 for k, v in stages.items()},
        "n_params": n_params,
        "fwd_stage_sum_vs_full_fwd": sum(stages[k] for k in FWD_STAGES) / stages["full_fwd"],
        "fwd_stages_plus_loss_opt_vs_full_step": accounted / total,
        "steps_per_s_full_step": 1.0 / total,
        "full_step_ms_bf16": mean["full_step"]["bfloat16"],
        "bf16_speedup_full_step": mean["full_step"]["float32"] / mean["full_step"]["bfloat16"],
        "gru_ms_bf16": mean["gru_controls"]["bfloat16"],
        "bf16_speedup_gru": mean["gru_controls"]["float32"] / mean["gru_controls"]["bfloat16"],
        "verdict_ms_in_turns": ms,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", default="16,128")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default=None, help="write the report (JSON) here too")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    card = card_of(device)
    report = {
        "what": "per-stage device time of the reference-workload train step + same-card ceilings",
        "device": device_name(device),
        "card": card,
        "protocol": ("one CUDA graph of --iters iterations a stage, CUDA events around a replay, "
                     f"best of {REPLAYS}; full_step: --iters graphed steps of one MultiStep call"
                     if device.type == "cuda" else
                     f"host clock around --iters calls, best of {REPLAYS} (CPU)"),
        "ceilings": measure_ceilings(device),
        "batches": {},
    }
    print(json.dumps({"ceilings": report["ceilings"], "card": card}), flush=True)
    for bs in [int(b) for b in args.batches.split(",")]:
        entry = batch_entry(bs, args.iters, device)
        report["batches"][str(bs)] = entry
        print(json.dumps({str(bs): entry, "card": card}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
