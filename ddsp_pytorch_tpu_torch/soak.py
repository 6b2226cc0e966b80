"""Long-horizon streaming drift soak.

Port of scripts/stream_drift_soak.py:40-255.  Streams up to 10^8 samples
(~35 minutes of 48 kHz audio) through `StreamingSynth.step`, 16 frames a
call, and bounds the one unbounded piece of stream state, the oscillator's
phase carry, against a float64 oracle; and holds a long-lived VoicePool
slot against an independent batch-1 stream while its neighbours churn.
Everything else in the state has finite memory (the GRU's tanh carry, the
noise filter's one-block tail) and is covered by the streamed = offline
tests at shorter horizons.

    python -m ddsp_pytorch_tpu_torch.soak [--samples 1e8] [--pool-samples 1e7] \\
        [--device cuda] [--out FILE]

The soak model is the JAX script's: a single-inst-decoder at hidden 64, 8
harmonics, 9 noise bands, 48 kHz, block 512, no reverb, its weights drawn
by `init_params` from a CPU generator (so the card and the CPU stream the
same weights).

The oracle follows the port's arithmetic, not the JAX one.  The port
computes each frame's phase increment in float64 from the float32 f0,
mod(block·2π·f0/sr, 2π), sums a call's increments in float64 and rounds the
carried phase to float32 once a call (ops/oscillator.py
phase_accumulate_frames).  The oracle is the float64 sum of the same
increments over the whole stream: the exact phase of the float32 controls.
So the error is a walk of one float32 rounding a call (at most 2.4e-7 rad
below 2π).  The JAX script's oracle instead sums JAX's float32 increments
in float64 (`_f32_dphi_mod`); its JAX phase can be held to this oracle too.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth
from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool

TWO_PI = 2.0 * math.pi
SOAK_KWARGS = dict(hidden_size=64, n_harmonic=8, n_bands=9, sample_rate=48000, block_size=512,
                   has_reverb=False)
FRAMES_PER_CALL = 16


def controls(rng, frames: int) -> tuple:
    """Slow log-space random-walk f0 in [100, 600] Hz and a loudness
    wobble, float32 (the JAX script's `_controls`, draw for draw)."""
    steps = rng.standard_normal(frames) * 0.01
    logf0 = np.clip(np.log(220.0) + np.cumsum(steps), np.log(100.0), np.log(600.0))
    f0 = np.exp(logf0).astype(np.float32)
    loud = (rng.standard_normal(frames) * 0.3).astype(np.float32)
    return f0, loud


def phase_increments(f0, block: int, sr: int) -> np.ndarray:
    """Each frame's wrapped phase increment as the port computes it: in
    float64 from the float32 f0, mod(block·(2π·f0/sr), 2π)."""
    omega = 2.0 * math.pi * np.asarray(f0, np.float32).astype(np.float64) / sr
    return np.mod(block * omega, TWO_PI)


def circular_err(a: float, b: float) -> float:
    d = (float(a) - float(b)) % TWO_PI
    return min(d, TWO_PI - d)


def soak_model(seed: int = 0, **overrides):
    """The soak's decoder with fresh weights from a seeded CPU generator."""
    model = load_model("single-inst-decoder", dict(SOAK_KWARGS, **overrides))
    return init_params(model, torch.Generator().manual_seed(seed)).eval()


def phase_drift_soak(total_samples: int, *, model=None, device="cuda",
                     frames_per_call: int = FRAMES_PER_CALL, n_checkpoints: int = 16,
                     seed: int = 0) -> dict:
    """Stream `total_samples` (whole calls) through StreamingSynth.step with
    controls from default_rng(seed); at checkpoints, compare the float32
    phase carry against the float64 oracle.  `model` defaults to
    soak_model(seed); it is copied to `device`."""
    device = resolve_device(device)
    model = soak_model(seed) if model is None else model
    synth = StreamingSynth(copy.deepcopy(model), batch=1, seed=seed, device=device)
    block, sr, frames = synth.block_size, synth.sample_rate, frames_per_call
    n_calls = total_samples // (frames * block)
    ck_every = max(1, n_calls // n_checkpoints)
    rng = np.random.default_rng(seed)
    phi64 = 0.0
    checkpoints, peak = [], 0.0
    t0 = time.monotonic()
    for call in range(n_calls):
        f0, loud = controls(rng, frames)
        audio = synth.step(f0[None, :, None], loud[None, :, None])
        phi64 = (phi64 + float(np.sum(phase_increments(f0, block, sr)))) % TWO_PI
        if (call + 1) % ck_every == 0 or call == n_calls - 1:
            a = audio.cpu().numpy()
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"non-finite audio at call {call}")
            peak = max(peak, float(np.max(np.abs(a))))
            phase32 = float(synth.state.phase[0])
            checkpoints.append({
                "samples": (call + 1) * frames * block,
                "phase_f32": phase32,
                "phase_oracle_f64": phi64,
                "abs_err_rad": circular_err(phase32, phi64),
            })
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "total_samples": n_calls * frames * block,
        "hours_at_sr": n_calls * frames * block / sr / 3600.0,
        "frames_per_call": frames,
        "block_size": block,
        "sample_rate": sr,
        "checkpoints": checkpoints,
        "max_abs_err_rad": max(c["abs_err_rad"] for c in checkpoints),
        "final_abs_err_rad": checkpoints[-1]["abs_err_rad"],
        "audio_peak": peak,
        "gru_carry_max_abs": float(synth.state.gru.abs().max()),
        "wall_s": time.monotonic() - t0,
        "device": str(device),
    }


def pool_churn_soak(total_samples: int, *, model=None, device="cuda",
                    frames_per_call: int = FRAMES_PER_CALL, voices: int = 4, churn_every: int = 50,
                    seed: int = 0) -> dict:
    """A long-lived VoicePool slot against an independent batch-1 stream of
    the same controls while neighbour slots churn (every `churn_every`
    calls: release all, acquire 1 … voices−1 fresh ones, each streaming
    unrelated controls).  Deterministic noise, so the comparison is
    numeric."""
    device = resolve_device(device)
    model = soak_model(seed) if model is None else model
    pool = VoicePool(StreamingSynth(copy.deepcopy(model), batch=voices, seed=seed,
                                    noise_deterministic=True, device=device))
    solo = StreamingSynth(copy.deepcopy(model), batch=1, seed=seed, noise_deterministic=True,
                          device=device)
    frames = frames_per_call
    hero = pool.acquire()
    rng = np.random.default_rng(seed)
    churn_rng = np.random.default_rng(seed + 1)
    n_calls = total_samples // (frames * solo.block_size)
    churn_slots, max_diff, churn_events = [], 0.0, 0
    for call in range(n_calls):
        f0, loud = controls(rng, frames)
        requests = {hero: (f0[:, None], loud[:, None])}
        for s in churn_slots:  # neighbours stream unrelated controls
            nf0 = churn_rng.uniform(100, 600, frames).astype(np.float32)
            nld = churn_rng.standard_normal(frames).astype(np.float32)
            requests[s] = (nf0[:, None], nld[:, None])
        got = pool.step(requests)[hero]
        want = solo.step(f0[None, :, None], loud[None, :, None])[0].cpu().numpy()
        max_diff = max(max_diff, float(np.max(np.abs(got - want))))
        if (call + 1) % churn_every == 0:
            for s in churn_slots:
                pool.release(s)
            churn_slots = []
            for _ in range(int(churn_rng.integers(1, voices))):
                s = pool.acquire()
                if s is not None:
                    churn_slots.append(s)
            churn_events += 1
    return {
        "total_samples": n_calls * frames * solo.block_size,
        "voices": voices,
        "churn_events": churn_events,
        "hero_vs_solo_max_abs_diff": max_diff,
        "device": str(device),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--samples", type=float, default=1e8)
    p.add_argument("--pool-samples", type=float, default=1e7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the JSON report here")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    report = {
        "phase_drift": phase_drift_soak(int(args.samples), device=device),
        "pool_churn": pool_churn_soak(int(args.pool_samples), device=device),
    }
    if device.type == "cuda":
        from ddsp_pytorch_tpu_torch.kernel_bench import card_line

        report["card"] = card_line()
    else:
        report["card"] = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    pd, pc = report["phase_drift"], report["pool_churn"]
    print(f"phase drift over {pd['total_samples']:.2e} samples ({pd['hours_at_sr']:.2f} h at "
          f"{pd['sample_rate']} Hz) on {pd['device']}: max {pd['max_abs_err_rad']:.3e} rad, final "
          f"{pd['final_abs_err_rad']:.3e} rad (wall {pd['wall_s']:.1f} s)")
    print(f"pool churn over {pc['total_samples']:.2e} samples, {pc['churn_events']} churns: "
          f"hero vs solo max diff {pc['hero_vs_solo_max_abs_diff']:.3e}")
    if args.out:
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
