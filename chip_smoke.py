#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):
  1. card: name and power limit, torch version, build of every hand-written
     kernel from the sources in this checkout (one nvcc per source, all
     started together);
  2. kernels: each kernel against its plain PyTorch version on the card at
     the serving shape and at larger shapes, and against a float64 numpy
     oracle, with times, the plain version's time and the bound;
  3. streaming: make_streaming_synth on the full-width violin bundle streams
     64 blocks of a glide on the card and on the CPU (plain versions); the
     two agree, the kernel's launch counter rose by one per block, and the
     per-block render time is reported against the realtime budget;
  4. server: StreamServer on the card answers two clients' block-sized
     requests (phase continues across requests, sessions are independent,
     deterministic sessions repeat);
  5. report: one JSON line {"kernels": [...]}, the card's name and power
     limit, and last {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and ddsp_pytorch_tpu_torch only.
Exits nonzero when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import serve
from ddsp_pytorch_tpu_torch.export import make_streaming_synth
from ddsp_pytorch_tpu_torch.ops import kernels
from ddsp_pytorch_tpu_torch.ops import oscillator as osc
from ddsp_pytorch_tpu_torch.profile_serving import glide

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

    entry = phase_kernels(device)
    phase_streaming(device)
    entry["launches"] = phase_server(device)
    check(entry["launches"] > 0, "oscillator kernel not launched on the main path")

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
