"""Device time of the hand-written kernels against their bounds, and against
another build of the same kernels.

    python -m ddsp_pytorch_tpu_torch.kernel_bench [--baseline DIR] [--out FILE]

For each kernel (oscillator_fwd, oscillator_bwd), each variant the
launchers choose (K = 64 template or runtime K; few or many rows) and each
shape of the main path (R = 1 serving, R = 37, R = 6000 = 16 × 375 training
rows; S = 512), it times this checkout's kernel with CUDA events around 200
launches queued behind a GPU sleep, and reports the bound (the larger of
bytes over 3.35 TB/s and FP32 flops over 67 TFLOP/s) and the share of it
reached.  With --baseline, DIR is the `ops/kernels` directory of another
checkout (e.g. an unpacked `git archive` of an earlier commit): its kernels
build there and are timed in turns with this checkout's (baseline, current,
current, baseline), on the same inputs, after both are checked against the
plain PyTorch versions.  Prints one JSON object, with the card's name and
power limit, and writes it to --out if given.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import threading
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): FP32 without tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SHAPES = ((1, 64, 512), (37, 64, 512), (6000, 64, 512),
          (1, 100, 512), (37, 100, 512), (6000, 100, 512))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def clocks_under_load(fn, seconds: float) -> dict:
    """The card's SM clock and power draw while fn() runs back to back on it
    for `seconds`: a thread polls nvidia-smi during the window, and only
    the samples taken wholly inside it, after a settling quarter second,
    are kept.  Returns each sample (SM MHz, max SM MHz, power W,
    temperature C) and the range of the SM clock and power."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits"]
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            t0 = time.perf_counter()
            out = subprocess.run(query, capture_output=True, text=True, timeout=60, check=True)
            samples.append((t0, time.perf_counter(), out.stdout.strip().splitlines()[0]))

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    while time.perf_counter() - start < seconds:
        fn()  # the launch queue fills and the host waits on it: the card stays busy
    torch.cuda.synchronize()
    end = time.perf_counter()
    stop.set()
    poller.join()
    rows = [[float(v) for v in line.split(",")] for t0, t1, line in samples
            if t0 >= start + 0.25 and t1 <= end]
    if not rows:
        return {"samples": [], "window_s": end - start}
    sm, power = [r[0] for r in rows], [r[2] for r in rows]
    return {"samples": rows, "window_s": end - start,
            "sm_mhz_min": min(sm), "sm_mhz_max": max(sm), "sm_mhz_limit": rows[0][1],
            "power_w_min": min(power), "power_w_max": max(power)}


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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of `nbytes` over the HBM rate and
    `flops` over the FP32 rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def oscillator_bound(rows: int, k: int, s: int):
    """(bound_ms, bound_by) of the forward: each input read once, each
    output written once; two FMAs (4 flops) per harmonic per sample (the
    sincosf per sample is not counted)."""
    return bound(4 * rows * (2 + k) + 4 * rows * s, 4 * rows * s * k)


def oscillator_bwd_bound(rows: int, k: int, s: int):
    """(bound_ms, bound_by) of the backward: reads phi, omega, amp and the
    (R, S) cotangent once, writes dphi, domega, damp once; two recurrences,
    the dA product and the dθ FMA, 8 flops per harmonic per sample."""
    return bound(4 * rows * (s + 2 * k + 4), 8 * rows * s * k)


def oscillator_inputs(rng, rows: int, k: int, sample_rate: float = 48000.0):
    """Random rows: φ in [0, 2π), f0 in 50–2000 Hz, amplitudes summing to
    at most 1, all float32 numpy."""
    phi = rng.uniform(0.0, 2 * math.pi, rows).astype(np.float32)
    f0 = rng.uniform(50.0, 2000.0, rows).astype(np.float32)
    omega = ((2.0 * math.pi / sample_rate) * f0).astype(np.float32)
    amp = (rng.random((rows, k)) / k).astype(np.float32)
    return phi, omega, amp


def _load_baseline(kernels_dir: str):
    """The `ops/kernels` package of another checkout, as a module of its own
    (it imports only the standard library); its kernels build in its own
    `_build/`."""
    spec = importlib.util.spec_from_file_location(
        "baseline_kernels", os.path.join(kernels_dir, "__init__.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _raw_fwd(launch, phi, omega, amp, s):
    out = torch.empty((phi.shape[0], s), dtype=torch.float32, device=phi.device)
    err = launch(phi.data_ptr(), omega.data_ptr(), amp.data_ptr(), out.data_ptr(),
                 phi.shape[0], amp.shape[1], s, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline oscillator_fwd launch failed: cudaError {err}")
    return out


def _raw_bwd(launch, phi, omega, amp, g, s):
    rows, k = amp.shape
    outs = [torch.empty(rows, device=phi.device), torch.empty(rows, device=phi.device),
            torch.empty(rows, k, device=phi.device)]
    err = launch(phi.data_ptr(), omega.data_ptr(), amp.data_ptr(), g.data_ptr(),
                 *[o.data_ptr() for o in outs], rows, k, s,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline oscillator_bwd launch failed: cudaError {err}")
    return outs


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def main(argv=None) -> dict:
    from ddsp_pytorch_tpu_torch.ops import kernels
    from ddsp_pytorch_tpu_torch.ops import oscillator as osc

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None,
                   help="ops/kernels directory of another checkout to time against")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA card")
    device = torch.device("cuda", 0)
    kernels.build()
    base = None
    if args.baseline:
        base = _load_baseline(args.baseline)
        base.build()
        base_fwd, base_bwd = base.launcher("oscillator_fwd"), base.launcher("oscillator_bwd")
    cycles_per_ms = sleep_cycles_per_ms()
    rng = np.random.default_rng(0)
    rows_out = []
    for rows, k, s in SHAPES:
        phi, omega, amp = (torch.tensor(x, device=device) for x in oscillator_inputs(rng, rows, k))
        g = torch.tensor(rng.standard_normal((rows, s)).astype(np.float32), device=device)
        cases = {
            "oscillator_fwd": (
                lambda: osc.oscillator_bank(phi, omega, amp, s),
                base and (lambda: _raw_fwd(base_fwd, phi, omega, amp, s)),
                oscillator_bound(rows, k, s),
                [osc.oscillator_bank_plain(phi, omega, amp, s)],
            ),
            "oscillator_bwd": (
                lambda: osc.oscillator_bank_bwd(phi, omega, amp, g, s),
                base and (lambda: _raw_bwd(base_bwd, phi, omega, amp, g, s)),
                oscillator_bwd_bound(rows, k, s),
                list(osc.oscillator_bank_bwd_plain(phi, omega, amp, g, s)),
            ),
        }
        for name, (current, baseline, (bound_ms, bound_by), plain) in cases.items():
            entry = {"kernel": name, "rows": rows, "k": k, "s": s,
                     "variant": osc.kernel_variant(k),
                     "bound_us": bound_ms * 1e3, "bound_by": bound_by}
            for tag, fn in (("current", current), ("baseline", baseline)):
                if fn is None:
                    continue
                got = fn()
                got = got if isinstance(got, (list, tuple)) else [got]
                torch.cuda.synchronize()
                entry[f"{tag}_max_rel_err_vs_plain"] = max(_rel_err(a, b) for a, b in zip(got, plain))
            order = ("baseline", "current", "current", "baseline") if baseline else ("current",) * 2
            for tag in order:
                fn = current if tag == "current" else baseline
                entry.setdefault(f"{tag}_us", []).append(time_ms(fn, 200, cycles_per_ms)[0] * 1e3)
            entry["current_share_of_bound"] = entry["bound_us"] / min(entry["current_us"])
            rows_out.append(entry)
            print(json.dumps(entry), flush=True)
    result = {"card": card_line(), "torch": torch.__version__,
              "baseline": args.baseline, "kernels": rows_out}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return result


if __name__ == "__main__":
    main()
