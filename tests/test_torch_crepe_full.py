"""CREPE at its published full capacity, the training step object, and the
benchmark's plain reference (benchmark/reference/crepe.py) against the
port's CREPE step, on the CPU without the JAX package.

Tolerances:
  * float64, the same draws and dropout masks on both sides (micro and
    tiny, batch 4–8, robust and clean frames, the benchmark's weights and
    statistics from lib/crepe_weights.py): the frames, loss, every
    gradient leaf, BatchNorm's running statistics and the norm of each
    leaf's Adam update within 1e-10 of their scale (the same arithmetic in
    another order: cumulative sums, FFT sizes, the normalization's
    association; measured ≤ 5.1e-12).  The update element by element within
    1e-7 of its norm: near a zero gradient Adam's update moves by lr/ε
    times the gradient's rounding (measured ≤ 2.2e-9; 2.3e-9 from
    init_crepe's weights, at a classifier weight whose gradient, 4e-9, is a
    sum that cancels);
  * float32 port against the float64 reference: the frames within 2e-3 of
    their peak (float32 phases reach ~3 000 rad at 1.8 kHz × 16 harmonics,
    whose ulp is 2.4e-4 rad; measured ≤ 1.0e-4), the loss within 1e-4
    relative (measured ≤ 4.8e-6), each gradient leaf within 1e-3 of its
    norm (measured ≤ 4.4e-4) but conv1's weight within 3e-2 (measured ≤
    1.4e-4, and 9.1e-3 from init_crepe's zero biases: conv1's outputs at
    stride 4 over a smooth frame lie so close that max-pool's choice
    between neighbours flips with float32's rounding, and the gradient goes
    to another 512-sample window), the running statistics' change within
    1e-3 of its norm (measured ≤ 2.1e-5), and the norm of each leaf's first
    update within 1e-3 (measured ≤ 1.4e-4; element by element Adam's ±lr
    flips sign where a gradient is near 0);
  * a reference with torch's unbiased running variance, or a dropout that
    keeps the unscaled activation, reads far outside the float64 tolerance.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import crepe_flops, crepe_weights, judge
from benchmark.reference import crepe as R
from ddsp_pytorch_tpu_torch import train_crepe as T
from ddsp_pytorch_tpu_torch.models import crepe as P
from ddsp_pytorch_tpu_torch.training import profiling
from ddsp_pytorch_tpu_torch.training.optim import Optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_TOL = 1e-10
F32_FRAMES = 2e-3
F32_LOSS = 1e-4
F32_GRAD = 1e-3
F32_GRAD_CONV1 = 3e-2
F64_UPDATE_ELEMENTS = 1e-7
F32_STATS = 1e-3
F32_UPDATE = 1e-3
CASES = [("micro", 8, True), ("micro", 4, False), ("tiny", 4, True), ("tiny", 6, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def _cfg(capacity: str, batch: int, robust: bool) -> dict:
    """The benchmark's crepe-full configuration at another capacity and
    batch (the widths follow the capacity multiplier)."""
    with open(os.path.join(REPO, "benchmark", "configs", "crepe-full.json")) as f:
        cfg = json.load(f)
    mult = P.CAPACITIES[capacity]
    cfg["model"].update(capacity=capacity, filters=[f // 32 * mult for f in cfg["model"]["filters"]])
    cfg["train"].update(batch=batch, robust=robust)
    return cfg


def _port_step(cfg: dict, dtype: torch.dtype, seed: int = 3) -> dict:
    """One port train step in `dtype` from the benchmark's weights and
    statistics of `seed` (lib/crepe_weights.py: no scale at 1, no offset or
    running mean at 0), and what the reference needs to follow it (that
    state and the generator's state after the program drew its own)."""
    m, tc = cfg["model"], cfg["train"]
    gen = torch.Generator().manual_seed(seed)
    model = T.init_crepe(P.CREPE(m["capacity"]), gen)
    state0 = crepe_weights.make_weights(cfg, seed, "cpu")
    model.load_state_dict(state0)
    gen0 = gen.get_state()
    model = model.to(dtype)
    tx = Optimizer("adam", tc["lr"])
    draws = T.draw_synth_inputs(tc["batch"], gen, tc["robust"])
    draws = {k: v.to(dtype) if v.is_floating_point() else v for k, v in draws.items()}
    frames, f0 = T.synth_batch(draws, tc["robust"])
    loss, grads, _ = T.train_step(model, tx, tx.init(list(model.parameters())), frames, T.f0_to_target(f0),
                                  tc["pos_weight"], generator=gen)
    names = [n for n, _ in model.named_parameters()]
    return {"state0": state0, "gen0": gen0, "frames": frames, "loss": float(loss),
            "grads": dict(zip(names, grads)), "state": model.state_dict()}


def _reference(cfg: dict, port: dict, dtype=torch.float64) -> dict:
    gen = torch.Generator()
    gen.set_state(port["gen0"])
    return R.train_steps(port["state0"], gen, cfg, 1, dtype)


def _gaps(port: dict, ref: dict) -> dict:
    """Each compared quantity's gap, relative to its scale."""
    def rel(a, b):
        return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))

    s0, s1, r1 = port["state0"], port["state"], ref["states"][0]
    stats = [k for k in s0 if ".running_" in k]
    params = [k for k in s0 if ".running_" not in k]
    return {
        "frames": float((port["frames"].double() - ref["frames"]).abs().max() / ref["frames"].abs().max()),
        "loss": abs(port["loss"] - ref["losses"][0]) / abs(ref["losses"][0]),
        "grad": max(rel(port["grads"][k], ref["grads"][k]) for k in params if k != "conv1.weight"),
        "grad_conv1": rel(port["grads"]["conv1.weight"], ref["grads"]["conv1.weight"]),
        "stats": max(rel(s1[k].double() - s0[k].double(), r1[k] - s0[k].double()) for k in stats),
        "update": max(rel(s1[k].double() - s0[k].double(), r1[k] - s0[k].double()) for k in params),
        "update_norms": judge.leaf_gap({k: s1[k].double() - s0[k].double() for k in params},
                                       {k: r1[k] - s0[k].double() for k in params}, params),
    }


@pytest.mark.parametrize("capacity,batch,robust", CASES)
def test_the_reference_is_the_port_in_float64(capacity, batch, robust):
    cfg = _cfg(capacity, batch, robust)
    port = _port_step(cfg, torch.float64)
    gaps = _gaps(port, _reference(cfg, port))
    assert all(gaps[k] <= F64_TOL for k in ("frames", "loss", "grad", "grad_conv1", "stats", "update_norms")), gaps
    assert gaps["update"] <= F64_UPDATE_ELEMENTS, gaps


@pytest.mark.parametrize("capacity,batch,robust", CASES)
def test_the_float32_port_is_near_the_float64_reference(capacity, batch, robust):
    cfg = _cfg(capacity, batch, robust)
    port = _port_step(cfg, torch.float32)
    gaps = _gaps(port, _reference(cfg, port))
    assert gaps["frames"] <= F32_FRAMES and gaps["loss"] <= F32_LOSS, gaps
    assert gaps["grad"] <= F32_GRAD and gaps["grad_conv1"] <= F32_GRAD_CONV1, gaps
    assert gaps["stats"] <= F32_STATS, gaps
    assert gaps["update_norms"] <= F32_UPDATE, gaps


REAL_BN = R.batch_norm_train


def _unbiased_running_var(x, weight, bias, running_mean, running_var):
    y, new_mean, new_var = REAL_BN(x, weight, bias, running_mean, running_var)
    n = x.shape[0] * x.shape[2]
    batch_var = (new_var - R.BN_MOMENTUM * running_var) / (1 - R.BN_MOMENTUM)
    return y, new_mean, R.BN_MOMENTUM * running_var + (1 - R.BN_MOMENTUM) * batch_var * n / (n - 1)


def _unscaled_dropout(x, keep_mask, rate):
    return torch.where(keep_mask, x, torch.zeros_like(x))


@pytest.mark.parametrize("name,mutant,gap", [("batch_norm_train", _unbiased_running_var, "stats"),
                                             ("dropout", _unscaled_dropout, "loss")],
                         ids=["unbiased-running-variance", "unscaled-dropout"])
def test_a_mutated_reference_fails_the_comparison(monkeypatch, name, mutant, gap):
    cfg = _cfg("micro", 8, True)
    port = _port_step(cfg, torch.float64)
    monkeypatch.setattr(R, name, mutant)
    gaps = _gaps(port, _reference(cfg, port))
    assert gaps[gap] > 1e3 * F64_TOL, gaps


def test_full_capacity_has_the_published_shape():
    model = P.CREPE("full")
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == 22_239_976 and len(params) == 26
    shapes = [(256, 1024, 128), (256, 128, 64), (256, 128, 32), (256, 128, 16), (256, 256, 8), (256, 512, 4)]
    assert model.block_shapes(256) == shapes
    cfg = _cfg("full", 256, True)
    assert R.block_shapes(cfg["model"], 256) == shapes
    assert [getattr(model, f"conv{i + 1}").kernel_size[0] for i in range(6)] == cfg["model"]["widths"]
    assert model.classifier.in_features == 512 * 4 == crepe_flops.layers(cfg["model"])[-1][1]


@pytest.mark.parametrize("capacity", ["micro", "tiny"])
def test_crepe_flops_count_what_torch_counts(capacity):
    cfg = _cfg(capacity, 4, True)
    gen = torch.Generator().manual_seed(0)
    model = T.init_crepe(P.CREPE(capacity), gen)
    frames, _ = T.synth_batch(T.draw_synth_inputs(4, gen, True), True)
    with FlopCounterMode(display=False) as counter:
        logits = model(frames, train=True, generator=gen)
        torch.autograd.grad(logits.square().mean(), list(model.parameters()))
    assert counter.get_total_flops() == crepe_flops.train_step_flops(cfg)["products"]
    full = crepe_flops.train_step_flops(_cfg("full", 256, True))["products"]
    assert full == pytest.approx(2.097e12, rel=1e-3)  # 8.19 GFLOP a frame × 256


def _manual_steps(n, **kw):
    """n steps of the plain loop the trainer replaced, from the same seed."""
    gen = torch.Generator().manual_seed(kw["seed"])
    model = T.init_crepe(P.CREPE(kw["capacity"]), gen)
    tx = Optimizer("adam", 2e-3)
    opt = tx.init(list(model.parameters()))
    losses = []
    for _ in range(n):
        frames, f0 = T.synth_batch(T.draw_synth_inputs(kw["batch"], gen, kw["robust"]), kw["robust"])
        loss, _, opt = T.train_step(model, tx, opt, frames, T.f0_to_target(f0), 20.0, generator=gen)
        losses.append(loss)
    return torch.stack(losses), model.state_dict()


def _trainer_steps(n, **kw):
    trainer = T.CrepeTrainer(kw["capacity"], kw["batch"], robust=kw["robust"], seed=kw["seed"], device="cpu")
    losses = torch.stack([trainer.step() for _ in range(n)])
    return losses, trainer.model.state_dict(), trainer


def test_the_trainer_is_the_plain_loop_bitwise_with_marks_on_and_off(monkeypatch):
    kw = dict(capacity="micro", batch=4, robust=True, seed=7)
    want_losses, want_state = _manual_steps(3, **kw)
    marked_losses, marked_state, _ = _trainer_steps(3, **kw)
    monkeypatch.setattr(profiling, "mark", lambda i: None)
    monkeypatch.setattr(profiling.StepMarks, "mark", lambda self, i, step=None: None)
    plain_losses, plain_state, _ = _trainer_steps(3, **kw)
    for losses, state in ((marked_losses, marked_state), (plain_losses, plain_state)):
        torch.testing.assert_close(losses, want_losses, rtol=0, atol=0)
        for k, v in want_state.items():
            torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_the_trainer_counts_marks_and_spans_its_steps():
    t0 = time.monotonic()
    losses, _, trainer = _trainer_steps(2, capacity="micro", batch=4, robust=False, seed=1)
    assert trainer.metrics == {"crepe/steps": 2, "crepe/frames": 8, "kernel_launches/adam_norm": 0,
                               "kernel_launches/adam_update": 0}  # the CPU's plain Adam
    assert trainer.pull(losses[-1]) == float(losses[-1])
    records = profiling.calls()
    assert len(records) == 2 and all(r.steps == 1 and t0 <= r.start <= r.end for r in records)
    for rec in records:
        assert set(rec.phase_ms) == set(profiling.CREPE_PHASES) == {"synth", "forward", "backward", "optimizer"}
        assert all(v is not None and v >= 0 for v in rec.phase_ms.values()), rec.phase_ms
        assert set(rec.host_ms) == {"crepe.step"}
        assert sum(rec.phase_ms.values()) <= rec.host_ms["crepe.step"]
    names = [s[0] for s in profiling.spans()]
    assert names == ["crepe.step", "crepe.step", "crepe.pull"]
    assert 0.0 <= trainer.evaluate() <= 1.0


def test_the_cli_trains_full_capacity_to_its_default_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = T.main(["--capacity", "full", "--batch", "2", "--steps", "1", "--device", "cpu", "--robust"])
    assert out == "runs/crepe_full.msgpack"
    model = P.load_crepe(str(tmp_path / out), device="cpu")
    assert model.capacity == "full" and np.isfinite(
        sum(float(v.abs().sum()) for v in model.state_dict().values()))
