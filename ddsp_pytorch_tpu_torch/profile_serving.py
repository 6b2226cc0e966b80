"""Where a served block's time goes on the GPU, and how many voices a card
serves.

    python -m ddsp_pytorch_tpu_torch.profile_serving \\
        [--bundle pretrained/ddsp_violin_bundle] [--blocks 64] [--out FILE]
    python -m ddsp_pytorch_tpu_torch.profile_serving \\
        --voices 1,8,64,256,512,768,1024,1536,2048 [--blocks 200] [--reverb] [--out FILE]

Without --voices: streams `--blocks` blocks of a pitch glide through
make_streaming_synth on CUDA twice after a warm-up: once untraced
(per-block render time on the host clock, each block ending in
torch.cuda.synchronize()), then under torch.profiler.  From the trace it
reports the device-busy time (the union of kernel intervals) against the
traced wall time, the kernels launched per block, and every kernel ranked
by device time.

With --voices: the voice ramp, the counterpart of scripts/voice_ramp.py.
For each V, a VoicePool of V slots, all active, at the bundle's width,
dispatched one frame a block as the pooled server dispatches it; each
block's `VoicePool.step` is timed on the host clock, the device→host pull
of the audio included (the step returns host audio).  It reports per-block
p50/p99/max, the aggregate × realtime (V × block time over p50), and
voices per card: the largest V below the first V whose p99 is not under
the block's 512 / 48 000 = 10.67 ms (a failure at a small V counts).  Where
no V fails, the top of the grid is only a lower bound, and the result says
so.  (The JAX script runs 8 frames a step against a two-block budget; this
ramp runs the server's one frame a block against one block.)
--reverb adds the in-stream reverb.

Prints one JSON object with the card's name and power limit and writes it
to --out if given.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.kernel_bench import card_line
from ddsp_pytorch_tpu_torch.training.profiling import device_kernels


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


# the ramp's grid: steps of at most 2× up to the forward kernel's many-row
# switch (528 rows), then of 1.5× or less, past where the host-bound pool
# runs out of budget
RAMP_VOICES = (1, 8, 64, 256, 512, 768, 1024, 1536, 2048)
RAMP_WARMUP = 8  # blocks before the timed ones (cuBLAS handles, cuFFT plans)
RAMP_TRACED = 20  # blocks traced after the timed ones


def voice_ramp(bundle: str, voices, blocks: int = 200, include_reverb: bool = False,
               device="cuda") -> dict:
    """The voice ramp (module docstring) at each V in `voices`.  On a card,
    RAMP_TRACED more blocks run under torch.profiler after the timed ones,
    for the device-busy time and the kernel launches a block."""
    from ddsp_pytorch_tpu_torch.export import make_streaming_synth
    from ddsp_pytorch_tpu_torch.ops import kernels
    from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool

    on_card = torch.device(device).type == "cuda"
    rows = []
    budget_ms = None
    for v in sorted(voices):
        pool = VoicePool(make_streaming_synth(bundle, batch=v, device=device,
                                              include_reverb=include_reverb))
        budget_ms = 1e3 * pool.block_size / pool.sample_rate
        slots = [pool.acquire() for _ in range(v)]
        rng = np.random.default_rng(v)
        f0 = rng.uniform(196.0, 1568.0, v).astype(np.float32)
        loud = rng.uniform(-9.0, -6.0, v).astype(np.float32)

        def requests(i):
            # a slow vibrato per voice, one frame a block
            mod = np.float32(1.0 + 0.01 * np.sin(0.3 * i))
            return {s: (np.full((1, 1), f0[j] * mod, np.float32), np.full((1, 1), loud[j], np.float32))
                    for j, s in enumerate(slots)}

        for i in range(RAMP_WARMUP):
            pool.step(requests(i))
        launches = kernels.counts()["oscillator_fwd"]["launches"]
        times = []
        for i in range(blocks):
            reqs = requests(RAMP_WARMUP + i)
            t0 = time.perf_counter()
            out = pool.step(reqs)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.counts()["oscillator_fwd"]["launches"] - launches
        traced = {}
        if on_card:
            with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
                t0 = time.perf_counter()
                for i in range(RAMP_TRACED):
                    pool.step(requests(RAMP_WARMUP + blocks + i))
                wall_ms = (time.perf_counter() - t0) * 1e3
            events, busy_ms = device_kernels(prof)
            traced = {"traced_block_ms": wall_ms / RAMP_TRACED,
                      "device_busy_ms_per_block": busy_ms / RAMP_TRACED,
                      "device_idle_share": 1.0 - busy_ms / wall_ms,
                      "kernel_launches_per_block": len(events) / RAMP_TRACED}
        peak = max(float(np.abs(a).max()) for a in out.values())
        if len(out) != v or not all(a.shape == (pool.block_size,) and np.isfinite(a).all()
                                    for a in out.values()):
            raise RuntimeError(f"voice ramp: bad output at V={v}")
        p50, p99 = (float(x) for x in np.percentile(times, [50, 99]))
        rows.append({
            "voices": v, "block_ms_p50": p50, "block_ms_p99": p99, "block_ms_max": float(max(times)),
            "per_voice_ms_p50": p50 / v, "x_realtime_aggregate": v * budget_ms / p50,
            "realtime_ok_p99": p99 < budget_ms, "oscillator_fwd_launches": launches, "peak": peak,
            **traced,
        })
        print(json.dumps(rows[-1]), flush=True)
        del pool, out
        if on_card:
            torch.cuda.empty_cache()
    return {"budget_ms": budget_ms, "blocks": blocks, "include_reverb": include_reverb,
            "rows": rows, **voices_per_card(rows)}


def voices_per_card(rows) -> dict:
    """The ramp's reading from its rows (ascending V): the largest V below
    the first V whose p99 failed the budget, that V, and whether no V
    failed (then the top of the grid is only a lower bound)."""
    first_failed = next((r["voices"] for r in rows if not r["realtime_ok_p99"]), None)
    passed = [r["voices"] for r in rows if first_failed is None or r["voices"] < first_failed]
    return {"voices_per_card": passed[-1] if passed else 0,
            "first_failed_voices": first_failed,
            "voices_per_card_is_lower_bound": first_failed is None}


def voices_per_card_text(ramp: dict) -> str:
    """The ramp's voices per card as it reads: '≥ V' where no V failed."""
    v = ramp["voices_per_card"]
    if ramp["voices_per_card_is_lower_bound"]:
        return f"≥ {v} (no V on the grid failed)"
    return f"{v} (first failure at V={ramp['first_failed_voices']})"


PROFILER_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def main(argv=None) -> dict:
    from ddsp_pytorch_tpu_torch.export import make_streaming_synth

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bundle", default="pretrained/ddsp_violin_bundle")
    p.add_argument("--blocks", type=int, default=None,
                   help="blocks streamed (default 64; 200 a V in the voice ramp)")
    p.add_argument("--voices", default=None,
                   help="comma-separated voice counts: run the voice ramp (the grid chip_smoke.py "
                        "runs: " + ",".join(map(str, RAMP_VOICES)) + ")")
    p.add_argument("--reverb", action="store_true", help="voice ramp with the in-stream reverb")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.voices:
        result = {"card": card_line(), "torch": torch.__version__, "bundle": args.bundle,
                  **voice_ramp(args.bundle, [int(x) for x in args.voices.split(",") if x],
                               blocks=args.blocks or 200, include_reverb=args.reverb)}
        return _emit(result, args.out)
    args.blocks = args.blocks or 64

    synth = make_streaming_synth(args.bundle, device="cuda")
    pitch, loud = glide(args.blocks, synth.block_size)
    _stream(synth, pitch, loud, min(8, args.blocks))  # warm-up
    synth.reset()
    untraced = _stream(synth, pitch, loud, args.blocks)

    synth.reset()
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        _stream(synth, pitch, loud, args.blocks)
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms = device_kernels(prof)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    result = {
        "card": card_line(),
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
    return _emit(result, args.out)


def _emit(result: dict, out) -> dict:
    text = json.dumps(result, indent=1)
    print(text)
    if out:
        with open(out, "w") as f:
            f.write(text)
    return result


if __name__ == "__main__":
    main()
