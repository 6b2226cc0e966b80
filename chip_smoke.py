#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):
  1. card: name and power limit, torch version, build of every hand-written
     kernel from the sources in this checkout (one nvcc per source, all
     started together);
  2. kernels: each kernel against its plain PyTorch version on the card at
     the serving shape and at larger shapes (the forward also against a
     float64 numpy oracle), with times, the plain version's time and the
     bound; OscillatorBank's gradients (both kernels) against autograd
     through the plain forward at the training shape;
  3. streaming: make_streaming_synth on the full-width violin bundle streams
     64 blocks of a glide on the card and on the CPU (plain versions); the
     two agree, the kernel's launch counter rose by one per block, and the
     per-block render time is reported against the realtime budget;
  4. server: StreamServer on the card answers two clients' block-sized
     requests (phase continues across requests, sessions are independent,
     deterministic sessions repeat);
  5. training at configs/config.yaml's full width: one train step on the
     card against the same step on the CPU (loss and every gradient); then
     Trainer.fit on a fresh model for a few tens of steps (batch 16 × 375
     frames, six scales, Adam 1e-3, reverb on) on a 16-item cache of glides
     whose targets the violin bundle renders on the card: every loss finite,
     no skipped update, the loss falls, one launch of each kernel per step;
  6. report: one JSON line {"kernels": [...]}, the card's name and power
     limit, and last {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and ddsp_pytorch_tpu_torch only.
Exits nonzero when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import serve
from ddsp_pytorch_tpu_torch.bundle import read_meta
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule
from ddsp_pytorch_tpu_torch.export import load_bundle, make_streaming_synth
from ddsp_pytorch_tpu_torch.models import DDSPDecoder, init_params
from ddsp_pytorch_tpu_torch.ops import kernels
from ddsp_pytorch_tpu_torch.ops import oscillator as osc
from ddsp_pytorch_tpu_torch.profile_serving import glide
from ddsp_pytorch_tpu_torch.profile_training import glide_controls
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.train import loss_and_grads, make_train_step, to_device

BUNDLE = "pretrained/ddsp_violin_bundle"
SEED = 0
# H100 SXM published peaks (dense): FP32 without tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Pallas-vs-XLA bound of the JAX suite (tests/test_oscillator.py:156) and the
# 64-harmonic recurrence-vs-f64 bound (tests/test_oscillator.py:165).
KERNEL_VS_PLAIN_ATOL = 5e-4
KERNEL_VS_F64_ATOL = 1e-3
# GPU vs CPU streaming: the same arithmetic, summed in other orders by
# cuBLAS and the CPU BLAS, over 64 carried GRU steps.
STREAM_GPU_VS_CPU_ATOL = 1e-4
# Backward kernel vs its plain version, each output relative to its largest
# magnitude: f32 sums over S = 64–512 samples in other orders (domega's
# terms carry the factor i+1 and reach 10^4–10^5).
BWD_VS_PLAIN_REL = 1e-4
# GPU vs CPU train step at full width, from fresh init_params weights.
# Loss: a sum of means over every STFT bin, two FFT libraries: 1e-4
# relative.  Gradients: the whole gradient within STEP_GRAD_REL relative L2
# error; every leaf's error within STEP_LEAF_OF_WHOLE of the whole
# gradient's norm; harmonic_proj.weight, which the two kernels feed, within
# STEP_HARMONIC_REL of its own norm.  A tighter rule per leaf would test
# f32 conditioning, not the port: the loss's log term differentiates to
# 1/(S + 1e-7) on near-silent bins, where the reconstruction is the noise
# branch (~1e-5 at its -5 bias) plus the bank's rounding residue.  Measured
# on the card's host at this step's input: a 1e-7 relative change of the
# injected noise or of the loudness moves noise_proj's gradient by 17-29 %;
# loudness_mlp.Dense_0.bias is carried by one frame whose normalized
# loudness is 0.0019, where LayerNorm_0's 1/sigma is ~460; and rounding the
# bank's recurrence once (the kernel's FMA) instead of twice moves the
# whole gradient by 1.1e-2 on the CPU.
STEP_LOSS_REL = 1e-4
STEP_GRAD_REL = 2e-2
STEP_LEAF_OF_WHOLE = 1e-2
STEP_HARMONIC_REL = 0.1
CONFIG = "configs/config.yaml"
N_TRAIN_STEPS = 40
# The mean of the first 5 losses over that of the last 5 in the 40-step
# fresh-init run: 1.66 on the first full run (NVIDIA H100 80GB HBM3,
# 700.00 W); the check asks for 1.3.
LOSS_FALL_FACTOR = 1.3
N_TRAIN_ITEMS, N_VAL_ITEMS = 16, 4
N_BLOCKS = 64
N_REQUESTS = 8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sleep_cycles_per_ms() -> float:
    """Calibrate torch.cuda._sleep (a spin of N clock cycles) against CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)  # warm-up
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, iters: int, cycles_per_ms: float, warmup: int = 3):
    """(device ms, host ms) per fn() call over `iters` back-to-back calls.

    Host ms is wall time per call with a synchronize at the end: what a
    caller waits for when the host, not the card, is the limit.  Device ms
    comes from CUDA events around the same calls queued behind a GPU sleep
    longer than the host needs to enqueue them all, so the gaps between
    launches that host overhead would leave are not timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (1.5 * host_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms / iters


def oscillator_bound(rows: int, k: int, s: int):
    """(bound_ms, bound_by): each input read once, each output written once;
    two FMAs (4 flops) per harmonic per sample (the sincosf per sample is
    not counted)."""
    nbytes = 4 * rows * (2 + k) + 4 * rows * s
    flops = 4 * rows * s * k
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def oscillator_bwd_bound(rows: int, k: int, s: int):
    """(bound_ms, bound_by) of the backward: reads phi, omega, amp and the
    (R, S) cotangent once, writes dphi, domega, damp once; two recurrences,
    the dA product and the dθ FMA, 8 flops per harmonic per sample."""
    nbytes = 4 * rows * (s + 2 * k + 4)
    flops = 8 * rows * s * k
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def oscillator_inputs(rng, rows: int, k: int, sample_rate: float = 48000.0):
    phi = rng.uniform(0.0, 2 * math.pi, rows).astype(np.float32)
    f0 = rng.uniform(50.0, 2000.0, rows).astype(np.float32)
    omega = ((2.0 * math.pi / sample_rate) * f0).astype(np.float32)
    amp = (rng.random((rows, k)) / k).astype(np.float32)
    return phi, omega, amp


def oscillator_f64(phi, omega, amp, s: int) -> np.ndarray:
    """Literal y = Σ_k A_k sin(k θ), θ = φ + (i+1) ω, in float64."""
    theta = phi.astype(np.float64)[:, None] + omega.astype(np.float64)[:, None] * np.arange(1, s + 1)
    out = np.zeros_like(theta)
    for j in range(amp.shape[1]):
        out += amp[:, j : j + 1].astype(np.float64) * np.sin((j + 1) * theta)
    return out


def phase_kernels(device) -> dict:
    """Phase 2: the oscillator kernel against its plain version and the
    float64 oracle; times at every shape.  Returns the serving-shape entry."""
    rng = np.random.default_rng(SEED)
    cycles_per_ms = sleep_cycles_per_ms()
    entry = None
    for rows, k, s in ((1, 64, 512), (6000, 64, 512), (37, 100, 512), (5, 1, 64)):
        phi, omega, amp = oscillator_inputs(rng, rows, k)
        args = [torch.tensor(x, device=device) for x in (phi, omega, amp)]
        got = osc.oscillator_bank(*args, s)
        plain = osc.oscillator_bank_plain(*args, s)
        torch.cuda.synchronize()
        check(got.shape == (rows, s) and bool(torch.isfinite(got).all()), "kernel output")
        err = float((got - plain).abs().max())
        check(err <= KERNEL_VS_PLAIN_ATOL, f"kernel vs plain {err} at R={rows} K={k} S={s}")
        err64 = None
        if k == 64:
            err64 = float(np.abs(got.cpu().numpy() - oscillator_f64(phi, omega, amp, s)).max())
            check(err64 <= KERNEL_VS_F64_ATOL, f"kernel vs f64 {err64} at R={rows}")
        # at most ~1000 queued launches (the plain version makes ~4K + 8 per
        # call), so the host never waits on a full launch queue while timing
        ms, call_ms = time_ms(lambda: osc.oscillator_bank(*args, s), 200, cycles_per_ms)
        plain_ms, plain_call_ms = time_ms(
            lambda: osc.oscillator_bank_plain(*args, s), max(1, min(20, 1000 // (4 * k + 8))),
            cycles_per_ms,
        )
        bound_ms, bound_by = oscillator_bound(rows, k, s)
        print(
            f"oscillator_fwd R={rows} K={k} S={s}: max|kernel-plain|={err:.3e} "
            f"max|kernel-f64|={err64 if err64 is None else f'{err64:.3e}'} "
            f"kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
            f"host_call_ms: kernel={call_ms:.6f} plain={plain_call_ms:.6f}",
            flush=True,
        )
        if (rows, k, s) == (1, 64, 512):
            entry = {
                "name": "oscillator_fwd",
                "route": "cuda",
                "source": "ddsp_pytorch_tpu_torch/ops/kernels/oscillator_fwd.cu",
                "replaces": "ddsp_pytorch_tpu/ops/pallas_kernels/oscillator.py:41",
                "launches": None,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes this bank
            }
    return entry


def phase_bwd_kernel(device) -> dict:
    """Phase 2, backward: the kernel against its plain version at every
    shape, timed by the forward's method; OscillatorBank's gradients
    against autograd through the plain forward at the training shape.
    Returns the training-shape entry."""
    rng = np.random.default_rng(SEED + 1)
    cycles_per_ms = sleep_cycles_per_ms()
    entry = None
    for rows, k, s in ((1, 64, 512), (6000, 64, 512), (37, 100, 512), (5, 1, 64)):
        phi, omega, amp = oscillator_inputs(rng, rows, k)
        g = rng.standard_normal((rows, s)).astype(np.float32)
        args = [torch.tensor(x, device=device) for x in (phi, omega, amp, g)]
        got = osc.oscillator_bank_bwd(*args, s)
        plain = osc.oscillator_bank_bwd_plain(*args, s)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("dphi", "domega", "damp"), got, plain):
            check(a.shape == b.shape and bool(torch.isfinite(a).all()), f"bwd {name} output")
            errs[name] = (float((a - b).abs().max()), rel_err(a, b))
            check(errs[name][1] <= BWD_VS_PLAIN_REL,
                  f"bwd kernel vs plain {name} rel {errs[name][1]} at R={rows} K={k} S={s}")
        ms, call_ms = time_ms(lambda: osc.oscillator_bank_bwd(*args, s), 200, cycles_per_ms)
        plain_ms, plain_call_ms = time_ms(
            lambda: osc.oscillator_bank_bwd_plain(*args, s), max(1, min(20, 1000 // (8 * k + 8))),
            cycles_per_ms,
        )
        bound_ms, bound_by = oscillator_bwd_bound(rows, k, s)
        print(
            f"oscillator_bwd R={rows} K={k} S={s}: "
            + " ".join(f"{n}: max|Δ|={a:.3e} rel={r:.3e}" for n, (a, r) in errs.items())
            + f" kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
            f"host_call_ms: kernel={call_ms:.6f} plain={plain_call_ms:.6f}",
            flush=True,
        )
        if (rows, k, s) == (6000, 64, 512):
            entry = {
                "name": "oscillator_bwd",
                "route": "cuda",
                "source": "ddsp_pytorch_tpu_torch/ops/kernels/oscillator_bwd.cu",
                "replaces": "ddsp_pytorch_tpu/ops/pallas_kernels/oscillator.py:60",
                "launches": None,
                "max_abs_err": max(a for a, _ in errs.values()),
                "max_rel_err": max(r for _, r in errs.values()),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes this backward
            }

    # the autograd function (both kernels) against autograd through the
    # plain forward, at the training shape
    rows, k, s = 6000, 64, 512
    phi, omega, amp = oscillator_inputs(rng, rows, k)
    g = torch.tensor(rng.standard_normal((rows, s)).astype(np.float32), device=device)
    ins = [torch.tensor(x, device=device, requires_grad=True) for x in (phi, omega, amp)]
    ref = [torch.tensor(x, device=device, requires_grad=True) for x in (phi, omega, amp)]
    before = (osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
    osc.OscillatorBank.apply(*ins, s).backward(g)
    check((osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
          == (before[0] + 1, before[1] + 1), "OscillatorBank did not launch both kernels once")
    osc.oscillator_bank_plain(*ref, s).backward(g)
    torch.cuda.synchronize()
    errs = {n: rel_err(a.grad, b.grad) for n, a, b in zip(("dphi", "domega", "damp"), ins, ref)}
    print(f"OscillatorBank grads vs autograd through the plain forward R={rows} K={k} S={s}: "
          + " ".join(f"{n} rel={e:.3e}" for n, e in errs.items()), flush=True)
    for n, e in errs.items():
        check(e <= BWD_VS_PLAIN_REL, f"OscillatorBank {n} vs plain autograd rel {e}")
    del ins, ref
    torch.cuda.empty_cache()
    return entry


def phase_streaming(device) -> None:
    """Phase 3: 64 streamed blocks on the card vs the CPU."""
    gpu = make_streaming_synth(BUNDLE, device=device, noise_deterministic=True)
    cpu = make_streaming_synth(BUNDLE, device="cpu", noise_deterministic=True)
    block = gpu.block_size
    pitch, loud = glide(N_BLOCKS, block)
    for i in range(4):  # warm-up on a throwaway state (cuBLAS handles, caches)
        gpu.step_samples(pitch[:, i * block : (i + 1) * block], loud[:, i * block : (i + 1) * block])
    gpu.reset()
    torch.cuda.synchronize()

    osc.oscillator_bank.launches = 0
    render_ms, outs = [], []
    for i in range(N_BLOCKS):
        sl = slice(i * block, (i + 1) * block)
        t0 = time.perf_counter()
        audio = gpu.step_samples(pitch[:, sl], loud[:, sl])
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(audio)
    launches = osc.oscillator_bank.launches

    got = torch.cat(outs, dim=-1).cpu().numpy()
    want = torch.cat(
        [cpu.step_samples(pitch[:, i * block : (i + 1) * block], loud[:, i * block : (i + 1) * block])
         for i in range(N_BLOCKS)],
        dim=-1,
    ).numpy()
    err = float(np.abs(got - want).max())
    peak = float(np.abs(got).max())
    budget_ms = 1e3 * block / gpu.sample_rate
    p50, p99 = np.percentile(render_ms, [50, 99])
    print(
        f"streaming {N_BLOCKS} blocks: launches={launches} max|gpu-cpu|={err:.3e} "
        f"peak={peak:.4f} render_ms p50={p50:.4f} p99={p99:.4f} max={max(render_ms):.4f} "
        f"budget_ms={budget_ms:.4f}",
        flush=True,
    )
    check(got.shape == (1, N_BLOCKS * block), "streamed shape")
    check(bool(np.isfinite(got).all()), "streamed audio not finite")
    check(peak > 1e-3, f"streamed audio silent (peak {peak})")
    check(err <= STREAM_GPU_VS_CPU_ATOL, f"gpu vs cpu streaming {err}")
    check(launches == N_BLOCKS, f"oscillator kernel launched {launches}x for {N_BLOCKS} blocks")


def phase_server(device) -> int:
    """Phase 4: the socket server on the card.  Returns the kernel launches
    made while it answered; the counter is reset just before the requests."""
    server = serve.StreamServer(BUNDLE, port=0, device=device)
    det = serve.StreamServer(BUNDLE, port=0, device=device, noise_deterministic=True)
    server.start()
    det.start()
    try:
        block = server.block_size
        pitch, loud = glide(N_REQUESTS, block)
        pitch, loud = pitch[0], loud[0]
        host, port = server.address
        clients = [serve.StreamClient(host, port) for _ in range(2)]
        check(all(c.sample_rate == server.sample_rate and c.block_size == block for c in clients), "hello")
        results = {}

        def run(idx):
            c = clients[idx]
            results[idx] = [
                c.render(pitch[i * block : (i + 1) * block], loud[i * block : (i + 1) * block])
                for i in range(N_REQUESTS)
            ]

        osc.oscillator_bank.launches = 0
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        d_host, d_port = det.address
        d1 = serve.StreamClient(d_host, d_port)
        first = d1.render(pitch[:block], loud[:block])
        second = d1.render(pitch[:block], loud[:block])
        d2 = serve.StreamClient(d_host, d_port)
        fresh = d2.render(pitch[:block], loud[:block])
        launches = osc.oscillator_bank.launches
        for c in (*clients, d1, d2):
            c.close()

        check(set(results) == {0, 1}, "a client thread did not finish")
        for idx in (0, 1):
            for a in results[idx]:
                check(a.shape == (block,) and bool(np.isfinite(a).all()), "response shape/finite")
        a0, b0 = results[0][0], results[1][0]
        check(not np.allclose(first, second), "phase did not continue across requests")
        check(np.array_equal(fresh, first), "deterministic fresh session differs from the first")
        check(bool(np.allclose(a0, b0, atol=1e-2)) and not np.array_equal(a0, b0),
              "sessions' noise streams not independent")
        check(launches == 2 * N_REQUESTS + 3, f"server launched the kernel {launches}x")
        print(
            f"server: 2 clients x {N_REQUESTS} requests + 3 deterministic: launches={launches} "
            f"max|session0-session1| first block={float(np.abs(a0 - b0).max()):.3e}",
            flush=True,
        )
        return launches
    finally:
        server.stop()
        det.stop()


def _full_kwargs():
    return dict(Config.from_yaml(CONFIG).model.kwargs)


def _grad_errors(got: dict, want: dict):
    """(whole-gradient relative L2 error, {leaf: (‖Δ‖, ‖g_leaf‖)}, ‖g‖)."""
    leaf = {n: (float((got[n] - w).norm()), float(w.norm())) for n, w in want.items()}
    a = torch.cat([got[n].flatten() for n in want])
    b = torch.cat([want[n].flatten() for n in want])
    return float((a - b).norm() / b.norm()), leaf, float(b.norm())


def phase_train_step(device) -> None:
    """Phase 5a: one full-width train step on the card against the CPU from
    the same init_params weights, batch and injected noise."""
    kw = _full_kwargs()
    block, sr = kw["block_size"], kw["sample_rate"]
    frames, batch_size = 48, 2  # 24 576 samples: longer than the 4096 scale
    cfg = Config.from_yaml(CONFIG)
    meta = read_meta(BUNDLE)
    meta_mean, meta_std = meta["mean_loudness"], meta["std_loudness"]
    pitch, loud = glide_controls(batch_size, frames, block, sr, seed=SEED + 2,
                                 mean_loudness=meta_mean, std_loudness=meta_std)
    rng = np.random.default_rng(SEED + 3)
    t = np.arange(frames * block) / sr
    sig = (0.3 * np.sin(2 * np.pi * 330.0 * t)[None] + 0.01 * rng.standard_normal((batch_size, t.size)))
    noise = rng.uniform(-1.0, 1.0, (batch_size, frames, block)).astype(np.float32)
    batch = {"pitch": pitch[..., None], "loudness": loud[..., None], "sig": sig.astype(np.float32)}

    def step(model, dev):
        tb = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(model, tb, meta_mean, meta_std, cfg.train.scales,
                                     cfg.train.overlap, noise=torch.tensor(noise, device=dev))
        names = [n for n, _ in model.named_parameters()]
        return float(loss), {n: g.detach().cpu().double() for n, g in zip(names, grads)}

    cpu_model = init_params(DDSPDecoder(**kw), torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    before = (osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
    gpu_loss, gpu_grads = step(gpu_model, device)
    launched = (osc.oscillator_bank.launches - before[0], osc.oscillator_bank_bwd.launches - before[1])
    cpu_loss, cpu_grads = step(cpu_model, "cpu")
    whole, leaf, norm = _grad_errors(gpu_grads, cpu_grads)
    of_whole = {n: d / norm for n, (d, _) in leaf.items()}
    rel = {n: d / max(w, 1e-30) for n, (d, w) in leaf.items()}
    worst = sorted(of_whole, key=of_whole.get, reverse=True)[:4]
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"train step GPU vs CPU (full width, batch {batch_size} x {frames} frames, init_params "
          f"weights): loss gpu={gpu_loss:.7f} cpu={cpu_loss:.7f} rel={loss_rel:.3e}; whole-gradient "
          f"rel L2={whole:.3e} (|g|={norm:.4e}); harmonic_proj.weight rel L2="
          f"{rel['harmonic_proj.weight']:.3e}; largest leaf errors (|Δ|/|g|, own rel L2): " + ", ".join(
              f"{n}={of_whole[n]:.3e} ({rel[n]:.3e})" for n in worst)
          + f"; launches fwd={launched[0]} bwd={launched[1]}", flush=True)
    check(np.isfinite(gpu_loss), "GPU step loss not finite")
    check(launched == (1, 1), f"GPU step launched the kernels {launched}, expected (1, 1)")
    check(leaf["harmonic_proj.weight"][1] > 0, "no gradient reaches harmonic_proj on the card")
    check(loss_rel <= STEP_LOSS_REL, f"GPU vs CPU loss rel {loss_rel}")
    check(whole <= STEP_GRAD_REL, f"GPU vs CPU whole-gradient rel L2 {whole}")
    check(rel["harmonic_proj.weight"] <= STEP_HARMONIC_REL,
          f"GPU vs CPU harmonic_proj.weight rel L2 {rel['harmonic_proj.weight']}")
    for n, e in of_whole.items():
        check(e <= STEP_LEAF_OF_WHOLE, f"GPU vs CPU gradient of {n}: |Δ|/|g| {e}")


def write_cache(out_dir: str, device) -> None:
    """A feature cache of 4 s glides with vibrato (train: N_TRAIN_ITEMS,
    validation: N_VAL_ITEMS), whose targets the violin bundle renders on the
    card through DDSPDecoder.forward (reverb on)."""
    bundle, meta = load_bundle(BUNDLE, device=device)
    mean, std = meta["mean_loudness"], meta["std_loudness"]
    block, sr = bundle.block_size, bundle.sample_rate
    frames = Config.from_yaml(CONFIG).n_frames
    generator = torch.Generator(device).manual_seed(SEED)
    for part, n, seed in (("train", N_TRAIN_ITEMS, SEED + 10), ("validation", N_VAL_ITEMS, SEED + 11)):
        pitch, loud = glide_controls(n, frames, block, sr, seed=seed,
                                     mean_loudness=mean, std_loudness=std)
        with torch.no_grad():
            sig = bundle({
                "pitch": torch.tensor(pitch[..., None], device=device),
                "loudness": (torch.tensor(loud[..., None], device=device) - mean) / std,
            }, generator=generator)["signal"]
        sig = sig.cpu().numpy()
        check(sig.shape == (n, frames * block) and bool(np.isfinite(sig).all()), "rendered targets")
        os.makedirs(os.path.join(out_dir, part))
        for name, arr in (("signals", sig), ("pitchs", pitch), ("loudness", loud)):
            np.save(os.path.join(out_dir, part, f"{name}.npy"), arr.astype(np.float32))
    del bundle
    torch.cuda.empty_cache()


def phase_training(device) -> tuple:
    """Phase 5b: Trainer.fit at configs/config.yaml on the violin-rendered
    cache.  Returns (forward launches, backward launches) of the fit."""
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_") as tmp:
        cache = os.path.join(tmp, "cache")
        write_cache(cache, device)
        cfg = Config.from_yaml(CONFIG)
        cfg.apply_overrides([
            f"preprocess.out_dir={cache}", f"train.steps={N_TRAIN_STEPS}",
            "train.val_interval_epochs=10", "train.log_interval_epochs=10",
            "train.checkpoint_every_steps=0", "train.metrics_flush_steps=10",
        ])
        dm = Datamodule(cfg)
        dm.setup()
        run_dir = os.path.join(tmp, "run")
        trainer = Trainer(cfg, run_dir, device=device)
        osc.oscillator_bank.launches = 0
        osc.oscillator_bank_bwd.launches = 0
        t0 = time.perf_counter()
        state = trainer.fit(dm)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fwd, bwd = osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches
        steps_run = state.step
        trainer.close()
        losses = [v for _, v in read_metrics(run_dir, "loss")]
        skipped = [v for _, v in read_metrics(run_dir, "update_skipped")]
        val = read_metrics(run_dir, "loss/val")
        window = read_metrics(run_dir, "train_window_steps_per_s")

        # ms per step on the host clock, each step ending in a synchronize
        # (after the counted run: these launches are not the main path's)
        batch = next(iter(dm.train_dataloader()))
        step = make_train_step(trainer.model, trainer.tx, cfg)
        tb = to_device(batch, device)
        step_ms = []
        for _ in range(6):
            t1 = time.perf_counter()
            step(state, tb)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        step_ms = step_ms[1:]

    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(
        f"training: {steps_run} steps (batch {cfg.train.batch} x {cfg.n_frames} frames, "
        f"scales {cfg.train.scales}, reverb on) in {fit_s:.2f} s, train window "
        f"{window[-1][1] if window else float('nan'):.4f} steps/s; ms/step (host, synced) "
        f"median={float(np.median(step_ms)):.3f} min={min(step_ms):.3f} max={max(step_ms):.3f}; "
        f"loss first5={first5:.5f} last5={last5:.5f} factor={first5 / last5:.4f}; "
        f"loss[0]={losses[0]:.5f} loss[-1]={losses[-1]:.5f}; val={[round(v, 5) for _, v in val]}; "
        f"launches fwd={fwd} bwd={bwd} eval_forwards={trainer.eval_forwards}",
        flush=True,
    )
    print("loss curve: " + " ".join(f"{v:.5f}" for v in losses), flush=True)
    check(steps_run == N_TRAIN_STEPS and len(losses) == N_TRAIN_STEPS, "steps run")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(sum(skipped) == 0, f"{int(sum(skipped))} updates skipped")
    check(first5 >= LOSS_FALL_FACTOR * last5,
          f"loss did not fall by {LOSS_FALL_FACTOR}x: first5 {first5} last5 {last5}")
    check(bwd == N_TRAIN_STEPS, f"oscillator_bwd launched {bwd}x in {N_TRAIN_STEPS} steps")
    check(fwd == N_TRAIN_STEPS + trainer.eval_forwards,
          f"oscillator_fwd launched {fwd}x: {N_TRAIN_STEPS} steps + {trainer.eval_forwards} eval")
    return fwd, bwd


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    # parity settings: full-precision f32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    report = kernels.build()
    print(f"kernel build wall s={time.perf_counter() - t0:.2f}", flush=True)
    for name, (secs, log) in report.items():
        print(f"built {name} in {secs:.2f} s\n{log.strip()}", flush=True)

    fwd_entry = phase_kernels(device)
    bwd_entry = phase_bwd_kernel(device)
    phase_streaming(device)
    serving_fwd = phase_server(device)
    check(serving_fwd > 0, "oscillator_fwd not launched on the serving path")
    phase_train_step(device)
    train_fwd, train_bwd = phase_training(device)
    check(train_fwd > 0 and train_bwd > 0, "a kernel was not launched on the training path")
    fwd_entry["launches"] = train_fwd
    fwd_entry["launches_by_path"] = {"serving": serving_fwd, "training": train_fwd}
    bwd_entry["launches"] = train_bwd
    bwd_entry["launches_by_path"] = {"serving": 0, "training": train_bwd}

    print(json.dumps({"kernels": [fwd_entry, bwd_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
