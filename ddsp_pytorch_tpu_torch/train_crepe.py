"""Train the CREPE-architecture pitch tracker on synthesized frames with
exact f0 labels (port of scripts/train_crepe.py):

    python -m ddsp_pytorch_tpu_torch.train_crepe --capacity tiny --steps 3000 \\
        [--out runs/crepe_tiny.msgpack] [--robust] [--device cuda]
    python -m ddsp_pytorch_tpu_torch.train_crepe --capacity full --robust
        # CREPE's published capacity (22.2 M parameters), to runs/crepe_full.msgpack

CREPE's recipe: 360 bins 20 cents apart, targets blurred by a Gaussian of
σ = 25 cents, binary cross-entropy with the positive bins up-weighted
(--pos-weight: only ~1 % of the bins are positive), Adam at 2e-3.  Each
step draws a fresh batch of harmonic frames on the device: random rolloff,
a formant, phase-coherent or random partials, vibrato and noise, and with
--robust room smear, pink noise down to −2 dB SNR and soft clipping.

`synth_batch` is a plain function of its random draws (`draw_synth_inputs`
makes them from a torch.Generator on the device; a test can feed it the
JAX script's), computed in the draws' dtype.  `CrepeTrainer` is the step
the CLI, `train()` and the benchmark drive: each step draws the batch,
then one dropout mask a block in forward order, from the trainer's one
generator.  The saved `{params, batch_stats}` msgpack loads in the JAX
package (flax.serialization.msgpack_restore into models/crepe.py's CREPE)
and in the port (models/crepe.py `load_crepe`), and plugs into
preprocessing as preprocess.crepe_params.  The device defaults to the GPU
and there is no fallback: --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Optional

import torch
import torch.nn.functional as F

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.bundle import msgpack_serialize
from ddsp_pytorch_tpu_torch.models.crepe import (
    CREPE,
    DROPOUT_RATE,
    FRAME_LENGTH,
    MODEL_SRATE,
    cents_grid,
    conv_precision,
    hz_to_cents,
    salience_to_cents,
)
from ddsp_pytorch_tpu_torch.models.decoder import _TRUNC_NORMAL_STD
from ddsp_pytorch_tpu_torch.ops import kernels
from ddsp_pytorch_tpu_torch.training import profiling
from ddsp_pytorch_tpu_torch.training.optim import Optimizer
from ddsp_pytorch_tpu_torch.weights import crepe_flax_from_state_dict

N_HARMONICS = 16
N_REFLECTIONS = 4  # taps of the robust batch's sparse room IR
F0_RANGE = (40.0, 1800.0)  # Hz, drawn log-uniform
EVAL_BATCH = 512
EVAL_SEED = 99
# the JAX script's cumulative sums run as XLA's CPU scan: sequential sums in
# blocks of this many, the blocks' totals scanned the same way, recursively
_SCAN_BLOCK = 16


def scan_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in x's dtype, associated as XLA's
    CPU reduce-window scan associates jnp.cumsum: sequential within blocks
    of _SCAN_BLOCK, each block offset by the scan of the block totals.  The
    same float32 additions run on any device (torch.cumsum accumulates
    float32 in float64 on the CPU, and in parallel on a card)."""
    n = x.shape[-1]
    n_blocks = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, n_blocks * _SCAN_BLOCK - n)).reshape(*x.shape[:-1], n_blocks, _SCAN_BLOCK)
    cols = [blocks[..., 0]]
    for j in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + blocks[..., j])
    inner = torch.stack(cols, dim=-1)
    if n_blocks > 1:
        offsets = F.pad(scan_cumsum(inner[..., -1])[..., :-1], (1, 0))
        inner = inner + offsets[..., None]
    return inner.reshape(*x.shape[:-1], -1)[..., :n]


def draw_synth_inputs(batch: int, generator: torch.Generator, robust: bool = False) -> dict:
    """The random draws of one synthetic batch, on the generator's device,
    named and ranged as train_crepe.py's 19 keys draw them (f0 as the
    script makes it from its uniform draw: log-uniform in Hz)."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    def bernoulli(p, shape):
        return torch.rand(shape, generator=generator, device=dev) < p

    draws = {
        "f0": torch.exp(uniform((batch,), math.log(F0_RANGE[0]), math.log(F0_RANGE[1]))),
        "alpha": uniform((batch, 1), 0.5, 2.5),
        "formant_pos": uniform((batch, 1), 2.0, 8.0),
        "formant_gain_exp": uniform((batch, 1), 0.0, 1.1),
        "formant_width": uniform((batch, 1), 0.8, 2.5),
        "phases": uniform((batch, N_HARMONICS), 0.0, 2.0 * math.pi),
        "coherent": bernoulli(0.5, (batch, 1)),
        "vib_depth": uniform((batch, 1), 0.0, 0.01),
        "vib_phase": uniform((batch, 1), 0.0, 2.0 * math.pi),
        "noise": torch.randn((batch, FRAME_LENGTH), generator=generator, device=dev),
        "snr_db": uniform((batch, 1), -2.0, 40.0) if robust else uniform((batch, 1), 5.0, 40.0),
        "gain_exp": uniform((batch, 1), -2.0, 0.0),
    }
    if robust:
        draws.update({
            "delays": torch.randint(16, 500, (batch, N_REFLECTIONS), generator=generator, device=dev),
            "signs": torch.where(bernoulli(0.5, (batch, N_REFLECTIONS)), 1.0, -1.0),
            "tap_gains": uniform((batch, N_REFLECTIONS), 0.15, 0.5),
            "use_rev": bernoulli(0.5, (batch, 1)),
            "use_pink": bernoulli(0.5, (batch, 1)),
            "drive": uniform((batch, 1), 1.5, 4.0),
            "use_clip": bernoulli(0.3, (batch, 1)),
        })
    return draws


def synth_batch(draws: dict, robust: bool = False) -> tuple:
    """Random harmonic frames with exact f0 labels (train_crepe.py:40-169),
    a function of `draw_synth_inputs`' draws: → (frames (B, 1024) at 16
    kHz, f0 (B,) Hz), in the dtype of the draws (float32 as drawn)."""
    f0 = draws["f0"]
    dev, dt = f0.device, f0.dtype
    t = torch.arange(FRAME_LENGTH, device=dev, dtype=dt) / MODEL_SRATE
    k = torch.arange(1, N_HARMONICS + 1, device=dev, dtype=dt)[None, :]
    # spectral rolloff amp_k ∝ k^-α, and a formant boosting the harmonics
    # around formant_pos, so the fundamental need not be the strongest
    amps = k ** (-draws["alpha"])
    formant_gain = 10.0 ** draws["formant_gain_exp"]
    amps = amps * (1.0 + formant_gain * torch.exp(
        -0.5 * torch.square((k - draws["formant_pos"]) / draws["formant_width"])))
    amps = torch.where(k * f0[:, None] < MODEL_SRATE / 2, amps, torch.zeros_like(amps))
    amps = amps / torch.sum(amps, dim=-1, keepdim=True)
    phases = torch.where(draws["coherent"], torch.zeros_like(draws["phases"]), draws["phases"])
    vib = 1.0 + draws["vib_depth"] * torch.sin(2.0 * math.pi * 5.0 * t[None, :] + draws["vib_phase"])
    inst_f = f0[:, None] * vib  # (B, T)
    phase = 2.0 * math.pi * scan_cumsum(inst_f) / MODEL_SRATE
    sig = torch.sum(amps[:, None, :] * torch.sin(phase[:, :, None] * k[None, :, :] + phases[:, None, :]),
                    dim=-1)
    white = draws["noise"]
    if robust:
        # room smear: circular convolution with a sparse IR (a unit direct
        # tap and N_REFLECTIONS reflections within ~31 ms)
        ir = torch.zeros_like(sig).scatter_add_(1, draws["delays"], draws["signs"] * draws["tap_gains"])
        ir[:, 0] = 1.0
        smeared = torch.fft.irfft(torch.fft.rfft(sig, dim=-1) * torch.fft.rfft(ir, dim=-1),
                                  FRAME_LENGTH, dim=-1)
        sig = torch.where(draws["use_rev"], smeared, sig)
        # pink or white noise down to below 0 dB SNR
        fbin = torch.clamp(torch.arange(FRAME_LENGTH // 2 + 1, device=dev, dtype=dt), min=1.0)
        pink = torch.fft.irfft(torch.fft.rfft(white, dim=-1) / torch.sqrt(fbin)[None, :], FRAME_LENGTH,
                               dim=-1)
        pink = pink / (torch.std(pink, dim=-1, keepdim=True, correction=0) + 1e-9)
        unit_noise = torch.where(draws["use_pink"], pink, white)
        noise = unit_noise * torch.sqrt(torch.mean(torch.square(sig), dim=-1, keepdim=True)) \
            * 10.0 ** (-draws["snr_db"] / 20.0)
        out = sig + noise
        # tanh soft clipping (mic-chain saturation)
        drive = draws["drive"]
        peak = torch.amax(torch.abs(out), dim=-1, keepdim=True) + 1e-9
        clipped = torch.tanh(drive * out / peak) * peak / torch.tanh(drive)
        out = torch.where(draws["use_clip"], clipped, out)
    else:
        noise = white * torch.sqrt(torch.mean(torch.square(sig), dim=-1, keepdim=True)) \
            * 10.0 ** (-draws["snr_db"] / 20.0)
        out = sig + noise
    gain = 10.0 ** draws["gain_exp"]
    return out * gain, f0


def f0_to_target(f0: torch.Tensor) -> torch.Tensor:
    """(B,) Hz → (B, 360) bin targets blurred by a Gaussian of σ = 25 cents."""
    grid = torch.tensor(cents_grid(), dtype=f0.dtype, device=f0.device)
    cents = hz_to_cents(f0)[:, None]
    return torch.exp(-0.5 * torch.square((grid[None, :] - cents) / 25.0))


def weighted_bce(logits: torch.Tensor, target: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """mean(pos_weight · y · softplus(−z) + (1 − y) · softplus(z))."""
    bce = pos_weight * target * F.softplus(-logits) + (1.0 - target) * F.softplus(logits)
    return torch.mean(bce)


@torch.no_grad()
def init_crepe(model: CREPE, generator: torch.Generator) -> CREPE:
    """Fresh weights with flax's initializers, in distribution: conv and
    dense kernels lecun_normal (truncated normal, std 1/√fan_in, cut at
    ±2σ), biases zeros, BatchNorm scale ones and bias zeros, running mean 0
    and variance 1.  `generator` lives on the model's device."""
    for name, module in model.named_children():
        weight = module.weight
        if name.startswith("bn"):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            continue
        fan_in = weight[0].numel()
        std = (1.0 / fan_in) ** 0.5 / _TRUNC_NORMAL_STD
        torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        module.bias.zero_()
    return model


def train_step(model: CREPE, tx: Optimizer, opt_state: dict, frames: torch.Tensor, target: torch.Tensor,
               pos_weight: float, dropout_masks=None, generator: Optional[torch.Generator] = None) -> tuple:
    """One Adam step of the weighted BCE in train mode (train_crepe.py:
    208-233): BatchNorm's running statistics move, dropout keeps
    `dropout_masks` or draws from `generator`.  The forward and the
    backward run in models/crepe.py's conv_precision (cuDNN, no TF32).
    Returns (loss, gradients, optimizer state); the parameters and the
    optimizer state are updated in place (`Optimizer.apply_`, no NaN
    guard: on the card, Adam's kernel).  Stamps the CREPE step's marks 2
    (the loss ready) and 3 (the gradients returned) inside
    `profiling.marking`."""
    params = list(model.parameters())
    with conv_precision():
        logits = model(frames, train=True, dropout_masks=dropout_masks, generator=generator)
        loss = weighted_bce(logits, target, pos_weight)
        profiling.mark(2)
        grads = torch.autograd.grad(loss, params)
        profiling.mark(3)
    tx.apply_(params, grads, opt_state)
    return loss.detach(), grads, opt_state


@torch.no_grad()
def eval_rpa(model: CREPE, frames: torch.Tensor, f0: torch.Tensor) -> float:
    """Raw pitch accuracy (±50 cents) of the eval-mode net on a batch."""
    with conv_precision():
        logits = model(frames)
    cents = salience_to_cents(torch.sigmoid(logits))
    return float(torch.mean((torch.abs(cents - hz_to_cents(f0)) < 50.0).float()))


def crepe_bytes(model: CREPE) -> bytes:
    """The `{params, batch_stats}` msgpack of the net (flax's layout)."""
    return msgpack_serialize(crepe_flax_from_state_dict(model.state_dict()))


class CrepeTrainer:
    """A fresh CREPE and its Adam state on `device`, trained one step at a
    time: the step the CLI, `train()` and the benchmark drive.

    `seed` seeds the one generator the trainer draws from: the weights
    (`init_crepe`), then each step's batch (`draw_synth_inputs`, then
    `synth_batch`) and its dropout masks (one `rand` a block, in forward
    order).  `step()` stamps the CREPE step's marks (training/profiling.py
    `CREPE_PHASES`) in a call record of its own, inside the host span
    `crepe.step`, and leaves the loss on the device; `pull(loss)` reads it
    (span `crepe.pull`).  `metrics` counts the steps and frames trained
    (`crepe/steps`, `crepe/frames`) and the optimizer kernels' launches
    since the trainer was made (`kernel_launches/<name>`, ops/kernels
    OPTIMIZER_KERNELS: the path its Adam took, 0 on the plain path)."""

    def __init__(self, capacity: str = "tiny", batch: int = 256, lr: float = 2e-3,
                 pos_weight: float = 20.0, robust: bool = False, seed: int = 0, *,
                 dropout: float = DROPOUT_RATE, dtype: Optional[str] = "float32", device="cuda"):
        device = resolve_device(device)
        self.device = device
        self.batch = batch
        self.pos_weight = pos_weight
        self.robust = robust
        self.generator = torch.Generator(device).manual_seed(seed)
        self.model = init_crepe(CREPE(capacity, dropout, dtype).to(device), self.generator)
        self.tx = Optimizer("adam", lr)
        self.opt_state = self.tx.init(list(self.model.parameters()))
        self.metrics = {"crepe/steps": 0, "crepe/frames": 0}
        self._counts0 = kernels.counts()
        self._count_launches()
        self._marks = profiling.StepMarks(1, device, phases=profiling.CREPE_PHASES)
        self._eval = None

    def draw_batch(self) -> tuple:
        """The next step's (frames, f0) from the trainer's generator."""
        return synth_batch(draw_synth_inputs(self.batch, self.generator, self.robust), self.robust)

    def step(self) -> torch.Tensor:
        """One train step; returns its loss, on the device."""
        with profiling.call(1) as rec, profiling.annotate("crepe.step"):
            rec.marks = self._marks
            with profiling.marking(self._marks):
                profiling.mark(0)
                frames, f0 = self.draw_batch()
                profiling.mark(1)
                loss, _, self.opt_state = train_step(self.model, self.tx, self.opt_state, frames,
                                                     f0_to_target(f0), self.pos_weight,
                                                     generator=self.generator)
                profiling.mark(4)
        self.metrics["crepe/steps"] += 1
        self.metrics["crepe/frames"] += self.batch
        self._count_launches()
        return loss

    def _count_launches(self) -> None:
        now = kernels.counts()
        for name in kernels.OPTIMIZER_KERNELS:
            self.metrics[f"kernel_launches/{name}"] = now[name]["launches"] - self._counts0[name]["launches"]

    def pull(self, loss: torch.Tensor) -> float:
        with profiling.annotate("crepe.pull"):
            return float(loss)

    def evaluate(self) -> float:
        """RPA50 of the eval-mode net on the fixed eval batch (EVAL_BATCH
        clean frames from EVAL_SEED, made at the first call)."""
        if self._eval is None:
            eval_gen = torch.Generator(self.device).manual_seed(EVAL_SEED)
            self._eval = synth_batch(draw_synth_inputs(EVAL_BATCH, eval_gen))
        return eval_rpa(self.model, *self._eval)


def train(capacity: str = "tiny", steps: int = 3000, batch: int = 256, lr: float = 2e-3,
          pos_weight: float = 20.0, robust: bool = False, seed: int = 0, log_every: int = 200, *,
          device="cuda") -> tuple:
    """Train a fresh CREPE for `steps` steps on `device` (`CrepeTrainer`).
    Returns (model, log): one {"step", "loss", "rpa50", "steps_per_s"}
    record at step 1 and every `log_every` steps after, rpa50 on the fixed
    eval batch."""
    trainer = CrepeTrainer(capacity, batch, lr, pos_weight, robust, seed, device=device)
    log = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        loss = trainer.step()
        if step % log_every == 0 or step == 1:
            rec = {"step": step, "loss": trainer.pull(loss), "rpa50": trainer.evaluate(),
                   "steps_per_s": step / (time.perf_counter() - t0)}
            log.append(rec)
            print(f"step {step:6d}  loss {rec['loss']:.5f}  RPA50 {rec['rpa50']:.3f}  "
                  f"({rec['steps_per_s']:.1f} steps/s)", flush=True)
    return trainer.model, log


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--capacity", default="tiny")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--pos-weight", type=float, default=20.0)
    p.add_argument("--robust", action="store_true",
                   help="noise-, reverb- and clip-augmented frames (synth_batch robust=True)")
    p.add_argument("--out", default=None, help="default runs/crepe_<capacity>.msgpack")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    out = args.out or f"runs/crepe_{args.capacity}.msgpack"
    model, _ = train(args.capacity, args.steps, args.batch, args.lr, args.pos_weight, args.robust,
                     args.seed, device=args.device)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        f.write(crepe_bytes(model))
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB) {{'capacity': {args.capacity!r}}}")
    return out


if __name__ == "__main__":
    main()
