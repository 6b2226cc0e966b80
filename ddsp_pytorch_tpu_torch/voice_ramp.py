"""The VoicePool serving ramp at the JAX script's own protocol.

Port of scripts/voice_ramp.py.  A fresh single-inst-decoder (weights from
`init_params` with a CPU generator seeded 0; --harmonics, --hidden, 65
noise bands, no reverb) streams through one `StreamingSynth` of batch
--pool (noise_deterministic) behind a `VoicePool`.  For each V of --ramp
the pool holds V voices, each asking for --frames frames a step (8 frames
of block 512 = 4096 samples, 85.3 ms at 48 kHz); V gets one warm step,
then --n-run timed steps.  A step is timed end to end: dispatch, the
render and the pull of the audio to the host (`VoicePool.step` returns
host audio), with no other synchronization, as in the JAX script.  A row
is realtime when its best step takes no longer than the audio it renders.

    python -m ddsp_pytorch_tpu_torch.voice_ramp [--device cuda] [--pool 32] \\
        [--ramp 1,2,4,8,16,32] [--frames 8] [--n-run 6] [--out FILE]

Prints one JSON line a row, then writes the report (the JAX script's keys
plus `card`, the card's name and power limit as nvidia-smi prints them,
null on the CPU) to --out, by default reports/voice_ramp_<device>.json in
the checkout (git-ignored).  `profile_serving.py --voices` is another
protocol (a bundle, one frame a block, p99 against 10.67 ms).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.bench_headline import card_of, device_name
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth
from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BANDS = 65
WHAT = ("VoicePool ramp, honest per-block accounting (host audio pulled every step; "
        "no synchronize anywhere)")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--pool", type=int, default=32)
    p.add_argument("--ramp", default="1,2,4,8,16,32")
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--block-size", type=int, default=512)
    p.add_argument("--harmonics", type=int, default=100)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--frames", type=int, default=8, help="frames per block step (8 → 4096 samples ≈ 85 ms)")
    p.add_argument("--n-run", type=int, default=6)
    p.add_argument("--out", default=None, help="report path (default reports/voice_ramp_<device>.json)")
    return p


def make_pool(args, device) -> VoicePool:
    """The fresh model (init_params, CPU generator seeded 0) in a pool of
    args.pool voices on `device`."""
    model = load_model("single-inst-decoder", dict(
        hidden_size=args.hidden, n_harmonic=args.harmonics, n_bands=N_BANDS,
        sample_rate=args.sample_rate, block_size=args.block_size, has_reverb=False))
    init_params(model, torch.Generator().manual_seed(0))
    synth = StreamingSynth(model, batch=args.pool, noise_deterministic=True, device=device)
    return VoicePool(synth)


def ramp(pool: VoicePool, voices, frames: int, n_run: int, block_ms: float, emit=None) -> list:
    """One row a V in `voices` (ascending, at most the pool's size): the
    best and mean ms of n_run timed steps after a warm one."""
    rng = np.random.default_rng(0)
    rows, slots = [], []
    for v in voices:
        while len(slots) < v:
            slot = pool.acquire()
            if slot is None:
                raise ValueError(f"the pool holds {pool.voices} voices; the ramp asks for {v}")
            slots.append(slot)
        reqs = {s: (np.full((frames, 1), 220.0 + 5 * i, np.float32),
                    (-0.5 + 0.05 * rng.standard_normal((frames, 1))).astype(np.float32))
                for i, s in enumerate(slots)}
        pool.step(reqs)  # warm
        times = []
        for _ in range(n_run):
            t0 = time.perf_counter()
            out = pool.step(reqs)
            times.append(time.perf_counter() - t0)
        samples = frames * pool.block_size
        if len(out) != v or any(o.shape != (samples,) for o in out.values()):
            raise RuntimeError(f"V={v}: the pool returned {len(out)} voices of "
                               f"{sorted({o.shape for o in out.values()})} samples")
        ms = 1000.0 * min(times)
        rows.append({
            "voices": v,
            "block_ms_best": round(ms, 2),
            "block_ms_mean": round(1000.0 * sum(times) / len(times), 2),
            "per_voice_ms": round(ms / v, 3),
            "x_realtime_aggregate": round(v * block_ms / ms, 1),
            "realtime_ok": ms <= block_ms,
        })
        if emit is not None:
            emit(rows[-1])
    return rows


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    voices = [int(x) for x in args.ramp.split(",") if x]
    if voices != sorted(voices) or not voices or voices[-1] > args.pool:
        raise ValueError(f"--ramp must ascend to at most --pool {args.pool}, got {args.ramp!r}")
    sr, block, frames = args.sample_rate, args.block_size, args.frames
    pool = make_pool(args, device)
    budget_ms = 2 * block / sr * 1000.0  # the engine's block budget
    block_ms = frames * block / sr * 1000.0
    rows = ramp(pool, voices, frames, args.n_run, block_ms,
                emit=lambda row: print(json.dumps(row), flush=True))
    report = {
        "what": WHAT,
        "platform": {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "device_kind": device_name(device)},
        "pool": args.pool,
        "block_samples": frames * block,
        "block_ms": round(block_ms, 1),
        "engine_budget_ms": round(budget_ms, 1),
        "voice": f"{args.harmonics} harmonics, hidden {args.hidden}, {sr} Hz",
        "rows": rows,
        "card": card_of(device),
    }
    out = args.out or os.path.join(REPO, "reports", f"voice_ramp_{device.type}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}", flush=True)
    return report


if __name__ == "__main__":
    main()
