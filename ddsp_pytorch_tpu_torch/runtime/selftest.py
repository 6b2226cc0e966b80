"""End-to-end runtime selftest: the port's model rendering through the C++
engine.

Port of ddsp_pytorch_tpu/runtime/selftest.py:1-267.

    python -m ddsp_pytorch_tpu_torch.runtime.selftest [--device cuda]

builds the native runtime if needed, makes a small fresh model (hidden 64,
16 harmonics, 16 kHz, block 256), streams pitch/loudness ticks through the
double-buffered engine (4 frames an engine block) and checks the pipeline
invariant: the output is the direct render delayed by exactly 2 engine
blocks (1e-4).  The engine's underruns are printed, not asserted: this run
paces its ticks loosely.

    python -m ddsp_pytorch_tpu_torch.runtime.selftest --soak 30 [--device cuda]

drives the engine at realtime pacing (deadline-scheduled 64-sample ticks,
like a Pd audio callback) for N seconds of audio through the flagship
shape (48 kHz, 100 harmonics, hidden 512, 65 noise bands, no reverb;
engine block 2 × 512, as `ddsp~` uses) and asserts that the engine
counted no underrun.  Prints one JSON line: latency, render p50/p99/max
against the engine block's budget, late ticks, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.runtime import StreamEngine
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth

PIPELINE_ATOL = 1e-4  # block-wise vs one-shot GRU steps reorder f32 sums
FLAGSHIP = dict(hidden_size=512, n_harmonic=100, n_bands=65, sample_rate=48000, block_size=512,
                has_reverb=False)


def _fresh_synth(kwargs: dict, device) -> StreamingSynth:
    """A decoder at `kwargs` with fresh weights from a CPU generator seeded 0
    (the same weights on every device), its noise off."""
    model = load_model("single-inst-decoder", kwargs)
    init_params(model, torch.Generator().manual_seed(0))
    return StreamingSynth(model, noise_deterministic=True, device=device)


def main(device="cuda") -> int:
    """The pipeline-invariant selftest; returns 0 on PASS."""
    device = resolve_device(device)
    kwargs = dict(hidden_size=64, n_harmonic=16, n_bands=17, sample_rate=16000, block_size=256,
                  has_reverb=False)
    synth = _fresh_synth(kwargs, device)
    twin = _fresh_synth(kwargs, device)  # the direct render, from the same weights
    block_samples = 4 * kwargs["block_size"]  # 4 frames an engine block

    def render(pitch, loud):
        return synth.step_samples(pitch[None, :], loud[None, :])[0].cpu().numpy()

    tick, n_ticks = 256, 24
    rng = np.random.default_rng(0)
    pitch_sig = rng.uniform(150, 400, (n_ticks * tick,)).astype(np.float32)
    loud_sig = np.zeros(n_ticks * tick, np.float32)
    out = np.zeros(n_ticks * tick, np.float32)
    with StreamEngine(block_samples, render) as engine:
        if engine.latency != 2 * block_samples:
            raise AssertionError(f"latency {engine.latency} != {2 * block_samples}")
        for t in range(n_ticks):
            sl = slice(t * tick, (t + 1) * tick)
            out[sl] = engine.process(pitch_sig[sl], loud_sig[sl])
            time.sleep(0.002)  # audio-thread pacing
        blocks, underruns = engine.blocks_rendered, engine.underruns

    n_direct = n_ticks * tick - 2 * block_samples
    direct = twin.step_samples(pitch_sig[None, :n_direct], loud_sig[None, :n_direct])[0].cpu().numpy()
    err = float(np.abs(out[2 * block_samples :] - direct).max())
    print(f"blocks rendered: {blocks}, underruns: {underruns}")
    print(f"pipeline-delay equivalence max err: {err:.2e} (device {device})")
    ok = err < PIPELINE_ATOL and np.all(out[: 2 * block_samples] == 0.0) and \
        blocks >= n_ticks * tick // block_samples - 1
    print("runtime selftest:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def soak(seconds: float = 30.0, *, device="cuda", tick: int = 64) -> dict:
    """Paced realtime soak: `seconds` of audio at deadline-scheduled ticks
    through the flagship shape, engine block 2 × block_size.  Returns the
    report (printed as one JSON line by the CLI); its `underruns` must be
    0."""
    device = resolve_device(device)
    synth = _fresh_synth(FLAGSHIP, device)
    sample_rate, block_size = synth.sample_rate, synth.block_size
    render_times = []

    def render(pitch, loud):
        t0 = time.perf_counter()
        out = synth.step_samples(pitch[None, :], loud[None, :])[0].cpu().numpy()
        render_times.append(time.perf_counter() - t0)
        return out

    engine_block = 2 * block_size
    n_ticks = int(seconds * sample_rate) // tick
    tick_s = tick / sample_rate
    rng = np.random.default_rng(0)
    # warm up outside the paced loop (a user meets this at `load`)
    for _ in range(3):
        render(np.full(engine_block, 220.0, np.float32), np.zeros(engine_block, np.float32))
    render_times.clear()

    late_ticks = 0
    with StreamEngine(engine_block, render) as engine:
        latency_ms = engine.latency / sample_rate * 1000.0
        start = time.perf_counter()
        offset = 0.0  # resync accumulator (see below)
        for i in range(n_ticks):
            deadline = start + offset + i * tick_s
            now = time.perf_counter()
            if now < deadline:
                time.sleep(deadline - now)
            elif now - deadline > tick_s:
                # The pacer stalled (host scheduling), not the model.  A real
                # audio device never delivers a burst of catch-up callbacks:
                # it xruns at the driver and resumes on its clock.  So the
                # deadline base moves on instead of bursting ticks at the
                # engine, which would cross block boundaries in ~0 wall time
                # and charge the worker with underruns it did not cause.
                late_ticks += 1
                offset += now - deadline
            pitch = np.full(tick, 220.0 + 50.0 * np.sin(i * 0.01), np.float32)
            loud = np.full(tick, -0.5 + 0.1 * rng.standard_normal(), np.float32)
            engine.process(pitch, loud)
        wall = time.perf_counter() - start
        underruns, blocks = engine.underruns, engine.blocks_rendered

    rt = np.asarray(render_times) * 1000.0
    card = None
    if device.type == "cuda":
        from ddsp_pytorch_tpu_torch.kernel_bench import card_line

        card = card_line()
    return {
        "metric": "realtime_soak",
        "audio_seconds": n_ticks * tick_s,
        "wall_seconds": wall,
        "underruns": int(underruns),
        "late_ticks": int(late_ticks),
        "blocks_rendered": int(blocks),
        "latency_ms": latency_ms,
        "render_ms_p50": float(np.percentile(rt, 50)) if rt.size else None,
        "render_ms_p99": float(np.percentile(rt, 99)) if rt.size else None,
        "render_ms_max": float(rt.max()) if rt.size else None,
        "budget_ms": engine_block / sample_rate * 1000.0,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card,
    }


def _cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--soak", type=float, default=None, metavar="SECONDS",
                   help="paced realtime soak instead of the pipeline test")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.soak is None:
        return main(args.device)
    result = soak(args.soak, device=args.device)
    print(json.dumps(result), flush=True)
    ok = result["underruns"] == 0
    print("realtime soak:", "PASS (zero underruns)" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(_cli())
