"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have; the same run unbroken comes out correct.
Driven on the CPU at a tiny size (the card's check is skipped)."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import SERVE_LIMITS, TRAIN_LIMITS, bench_dir, serve_params

CPU = torch.device("cpu")


def _train_run(tmp_path):
    d, spec = bench_dir(str(tmp_path / "b"), "train", "single-inst-decoder", {"corpus_items": 6, "settle_s": 0.0},
                        TRAIN_LIMITS)
    return harness.run_cell(spec, "tiny.cell", 4242, 0.5, False, CPU, time.monotonic(), bench_dir=d)


def _serve_run(tmp_path, model, sessions):
    d, spec = bench_dir(str(tmp_path / "b"), "serve", model, serve_params(sessions, compared=sessions),
                        SERVE_LIMITS)
    return harness.run_cell(spec, "tiny.cell", 2**33 + 5, 1.5, False, CPU, time.monotonic(), bench_dir=d)


def test_train_sound(tmp_path):
    assert _train_run(tmp_path).correct


def test_train_state_left_unchanged(tmp_path, monkeypatch):
    from ddsp_pytorch_tpu_torch.training import train
    from ddsp_pytorch_tpu_torch.training.optim import global_norm

    def no_update(state, tx, loss, grads):
        return {"loss": loss, "grad_norm": global_norm(grads),
                "update_skipped": torch.zeros((), dtype=torch.int32)}

    monkeypatch.setattr(train, "_update_in_place", no_update)
    run = _train_run(tmp_path)
    assert not run.correct and run.checks["update_gap"][0] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(tmp_path, monkeypatch):
    from ddsp_pytorch_tpu_torch.training import train

    real = train.loss_and_grads

    def half(model, batch, *args, noise=None, **kwargs):
        h = next(iter(batch.values())).shape[0] // 2
        return real(model, {k: v[:h] for k, v in batch.items()}, *args, noise=noise[:h], **kwargs)

    monkeypatch.setattr(train, "loss_and_grads", half)
    run = _train_run(tmp_path)
    assert not run.correct and run.checks["loss_gap"][0] > run.checks["loss_gap"][1]


@pytest.mark.parametrize("model,sessions", [("single-inst-decoder", 2), ("mfcc-autoencoder", 1)])
def test_serve_sound(tmp_path, model, sessions):
    run = _serve_run(tmp_path, model, sessions)
    assert run.correct, run.checks
    assert run.e2e["block_p50_ms"] <= run.e2e["block_p99_ms"]


def _patch_step(monkeypatch, make):
    from ddsp_pytorch_tpu_torch.streaming import StreamingSynth

    for name in ("step_stateless", "step_stateless_masked"):
        monkeypatch.setattr(StreamingSynth, name, make(getattr(StreamingSynth, name)))


@pytest.mark.parametrize("model,sessions", [("single-inst-decoder", 2), ("mfcc-autoencoder", 1)])
def test_serve_answer_altered_where_produced(tmp_path, monkeypatch, model, sessions):
    def make(orig):
        def step(self, state, *args, **kwargs):
            audio, new = orig(self, state, *args, **kwargs)
            return audio + 1e-2 * audio.abs().max(), new
        return step

    _patch_step(monkeypatch, make)
    assert not _serve_run(tmp_path, model, sessions).correct


@pytest.mark.parametrize("model,sessions", [("single-inst-decoder", 2), ("mfcc-autoencoder", 1)])
def test_serve_step_returns_its_state_unchanged(tmp_path, monkeypatch, model, sessions):
    def make(orig):
        def step(self, state, *args, **kwargs):
            audio, _ = orig(self, state, *args, **kwargs)
            return audio, state
        return step

    _patch_step(monkeypatch, make)
    assert not _serve_run(tmp_path, model, sessions).correct

