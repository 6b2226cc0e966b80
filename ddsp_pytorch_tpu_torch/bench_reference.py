"""Head-to-head against the reference's own formulation, on one device.

Port of scripts/bench_reference_cpu.py (its record: REFBENCH_r05.json).
The reference publishes no numbers, so this produces the baseline: the
reference decoder's forward restated in torch from its equations
(`ReferenceDecoder`: the MLPs with nn.LayerNorm's ε, a torch.nn.GRU,
nearest upsample, the O(T) phase cumsum, the materialized (B, T, K) sine
bank, frame-FIR noise; the formulation of the JAX package's
utils/torch_reference.py:91-191, restated here on this package's
state_dict), timed by the reference's protocol (its performance.py:21-41:
2^⌈log₂ sr⌉ samples of random controls, the mean wall clock of --n-run
calls, the best of --protocol-runs such means), beside this package's
streaming forward timed by the same protocol
(`performance.run_benchmark`), on the same device and the same weights
(`init_params` from a CPU generator seeded 0).

    python -m ddsp_pytorch_tpu_torch.bench_reference [--device cuda] \\
        [--n-run 10] [--protocol-runs 3] [--out FILE]

--device cpu runs both sides on the CPU, and the report has
REFBENCH_r05.json's keys (`torch_reference`, `ours_cpu`,
`speedup_same_cpu`, ...); --device cuda runs both on the card (`ours_cuda`,
`speedup_same_cuda`), where each call ends in a synchronize and the port's
side launches the forward oscillator kernel.  Both add `card` (the card's
name and power limit as nvidia-smi prints them, null on the CPU).  The
restated GRU and products run with TF32 off, so the card computes what the
CPU does.  The report goes to --out, by default
reports/bench_reference_<device>.json in the checkout (git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time

import torch
import torch.fft as tfft
import torch.nn.functional as F

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.bench_headline import card_of
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.performance import n_samples, protocol_controls, run_benchmark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [
    # the reference training default voice (config.yaml:5-28)
    dict(name="reference-default-48k-64harm", sample_rate=48000,
         block_size=512, hidden_size=512, n_harmonic=64, n_bands=65),
    # the headline voice
    dict(name="headline-48k-100harm", sample_rate=48000,
         block_size=512, hidden_size=512, n_harmonic=100, n_bands=65),
]
PROTOCOL = ("reference performance.py:21-41 (mean of n_run, best of protocol_runs), batch 1, "
            "no reverb, frame controls staged outside the timed loop")
MLPS = ("f0_mlp", "loudness_mlp", "out_mlp")


@contextlib.contextmanager
def reference_precision():
    """TF32 off for the restated products and the cuDNN GRU, whatever the
    global flags say (cuDNN's default allows TF32)."""
    matmul = torch.backends.cuda.matmul
    previous = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = previous


def _scale(x: torch.Tensor) -> torch.Tensor:
    """Exponentiated sigmoid (reference core.py:77-78)."""
    return 2.0 * torch.sigmoid(x) ** math.log(10.0) + 1e-7


def _amp_to_ir(amp: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-phase magnitudes → windowed linear-phase FIR (reference
    core.py:144-166)."""
    amp = torch.view_as_complex(torch.stack([amp, torch.zeros_like(amp)], -1))
    impulse = tfft.irfft(amp)
    fs = impulse.shape[-1]
    impulse = torch.roll(impulse, fs // 2, -1) * torch.hann_window(fs, device=amp.device)
    impulse = F.pad(impulse, (0, target - fs))
    return torch.roll(impulse, -fs // 2, -1)


def _fft_convolve(signal: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Centered fast convolution (reference core.py:169-175)."""
    signal = F.pad(signal, (0, signal.shape[-1]))
    kernel = F.pad(kernel, (kernel.shape[-1], 0))
    out = tfft.irfft(tfft.rfft(signal) * tfft.rfft(kernel))
    return out[..., out.shape[-1] // 2:]


class ReferenceDecoder:
    """The reference's single-inst decoder forward, dry (no reverb: its
    realtime contract leaves the reverb out), on a DDSPDecoder's
    state_dict.  The tensors are taken once, on `device`, so no conversion
    lands inside a timed call.

    __call__(f0, loudness, noise=None) → (B, T) audio; `noise` is the
    uniform [-1, 1) frame noise (B, F, block), drawn fresh a call when
    omitted, as the reference forward draws it (modules.py:119-123)."""

    def __init__(self, state_dict: dict, *, sample_rate: int, block_size: int, n_harmonic: int,
                 hidden_size: int, device="cpu"):
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.device = resolve_device(device)
        sd = {k: v.detach().to(self.device, torch.float32) for k, v in state_dict.items()}
        self._mlps = {m: [(sd[f"decoder.{m}.Dense_{i}.weight"].T, sd[f"decoder.{m}.Dense_{i}.bias"],
                           sd[f"decoder.{m}.LayerNorm_{i}.weight"], sd[f"decoder.{m}.LayerNorm_{i}.bias"])
                          for i in range(3)] for m in MLPS}
        self.gru = torch.nn.GRU(2 * hidden_size, hidden_size, batch_first=True).to(self.device)
        with torch.no_grad():
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(self.gru, f"{name}_l0").copy_(sd[f"decoder.gru.{name}"])
        self.hw, self.hb = sd["harmonic_proj.weight"].T, sd["harmonic_proj.bias"]
        self.nw, self.nb = sd["noise_proj.weight"].T, sd["noise_proj.bias"]
        self.harmonics = torch.arange(1, n_harmonic + 1, device=self.device)

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """3 × [Linear → LayerNorm → LeakyReLU] (reference core.py:122-129)."""
        for kernel, bias, scale, shift in self._mlps[name]:
            x = x @ kernel + bias
            x = F.leaky_relu(F.layer_norm(x, (x.shape[-1],), scale, shift))
        return x

    @torch.no_grad()
    def __call__(self, f0: torch.Tensor, loudness: torch.Tensor, noise=None) -> torch.Tensor:
        b, frames, _ = f0.shape
        t = frames * self.block_size
        sr = self.sample_rate
        with reference_precision():
            hidden = torch.cat([self._mlp("f0_mlp", f0), self._mlp("loudness_mlp", loudness)], -1)
            gru_out, _ = self.gru(hidden)
            hidden = self._mlp("out_mlp", torch.cat([gru_out, f0, loudness], -1))
            param = hidden @ self.hw + self.hb
            magnitudes = hidden @ self.nw + self.nb
        amplitudes = _scale(param[..., :1])
        dist = _scale(param[..., 1:])
        dist = dist * ((f0 * self.harmonics < sr / 2).float() + 1e-4)
        dist = dist / dist.sum(-1, keepdim=True)
        harm_amps = dist * amplitudes  # (B, F, K)

        # the oscillator, literally (reference core.py:64-67, 136-141)
        f0_up = F.interpolate(f0.permute(0, 2, 1), size=t).permute(0, 2, 1)
        amp_up = F.interpolate(harm_amps.permute(0, 2, 1), size=t).permute(0, 2, 1)
        omega = torch.cumsum(2 * math.pi * f0_up / sr, 1)
        harmonic = (torch.sin(omega * self.harmonics) * amp_up).sum(-1)

        # filtered noise (modules.py:101-146, initial_bias −5)
        impulse = _amp_to_ir(_scale(magnitudes - 5.0), self.block_size)
        if noise is None:
            noise = torch.rand(b, frames, self.block_size, device=self.device) * 2.0 - 1.0
        return harmonic + _fft_convolve(noise, impulse).reshape(b, -1)


def fresh_model(cfg: dict):
    """The config's decoder with init_params weights from a CPU generator
    seeded 0: the weights `performance.make_synth` draws for the port's
    side."""
    model = load_model("single-inst-decoder", dict(
        hidden_size=cfg["hidden_size"], n_harmonic=cfg["n_harmonic"], n_bands=cfg["n_bands"],
        sample_rate=cfg["sample_rate"], block_size=cfg["block_size"], has_reverb=False))
    return init_params(model, torch.Generator().manual_seed(0))


def bench_reference(cfg: dict, n_run: int, protocol_runs: int, device) -> dict:
    ref = ReferenceDecoder(fresh_model(cfg).state_dict(), sample_rate=cfg["sample_rate"],
                           block_size=cfg["block_size"], n_harmonic=cfg["n_harmonic"],
                           hidden_size=cfg["hidden_size"], device=device)
    f0, lo = protocol_controls(cfg["sample_rate"], cfg["block_size"], 1, ref.device)

    def call():
        ref(f0, lo)
        if ref.device.type == "cuda":
            torch.cuda.synchronize(ref.device)

    call()  # warm-up

    def protocol_mean() -> float:
        mean = 0.0
        for i in range(n_run):
            st = time.perf_counter()
            call()
            mean += (time.perf_counter() - st - mean) / (i + 1)
        return mean

    mean = min(protocol_mean() for _ in range(protocol_runs))
    n = n_samples(cfg["sample_rate"], cfg["block_size"])
    return {"mean_ms": 1000 * mean, "n_samples": n, "x_realtime": n / (mean * cfg["sample_rate"])}


def bench_ours(cfg: dict, n_run: int, protocol_runs: int, device) -> dict:
    config = Config()
    config.preprocess.sample_rate = cfg["sample_rate"]
    config.preprocess.block_size = cfg["block_size"]
    config.model.kwargs.update(hidden_size=cfg["hidden_size"], n_harmonic=cfg["n_harmonic"],
                               n_bands=cfg["n_bands"], sample_rate=cfg["sample_rate"],
                               block_size=cfg["block_size"])
    r = run_benchmark(config=config, n_run=n_run, protocol_runs=protocol_runs, discard_first=False,
                      device=device)
    return {"mean_ms": r["mean_ms"], "x_realtime": r["x_realtime"]}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="report path (default reports/bench_reference_<device>.json)")
    p.add_argument("--n-run", type=int, default=10)
    p.add_argument("--protocol-runs", type=int, default=3)
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    side = f"ours_{device.type}"
    speedup = f"speedup_same_{device.type}"
    rows = []
    for cfg in CONFIGS:
        ref = bench_reference(cfg, args.n_run, args.protocol_runs, device)
        ours = bench_ours(cfg, args.n_run, args.protocol_runs, device)
        rows.append({**cfg, "torch_reference": ref, side: ours, speedup: ref["mean_ms"] / ours["mean_ms"]})
        print(f"{cfg['name']}: reference (torch, {device.type}) {ref['mean_ms']:.3f} ms "
              f"({ref['x_realtime']:.1f}x rt)  ours ({device.type}) {ours['mean_ms']:.3f} ms "
              f"({ours['x_realtime']:.1f}x rt)  speedup {rows[-1][speedup]:.2f}x", flush=True)
    report = {
        "protocol": PROTOCOL,
        "host_cpus": os.cpu_count(),
        "torch_threads": torch.get_num_threads(),
        "n_run": args.n_run,
        "protocol_runs": args.protocol_runs,
        "configs": rows,
        "card": card_of(device),
    }
    out = args.out or os.path.join(REPO, "reports", f"bench_reference_{device.type}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}", flush=True)
    return report


if __name__ == "__main__":
    main()
