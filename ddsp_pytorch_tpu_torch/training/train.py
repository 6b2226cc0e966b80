"""Train step, eval step and the Trainer loop, on one device.

Port of ddsp_pytorch_tpu/training/train.py:60-134, :198-218 and the single-
device Trainer of :220-905: the epoch loop sized to reach `steps`, loudness
normalized by the frozen dataset stats, the multiscale spectral loss of the
model's signal against the target, the optimizer update behind a NaN
guard, per-step metrics, validation every `val_interval_epochs`, the best
mean-train-loss params every `log_interval_epochs`, full-state checkpoints
every `checkpoint_every_steps` and exact resume from the newest one.

The harmonic branch runs through `ops.OscillatorBank`, so on the card a
step launches the hand-written forward kernel once and the backward kernel
once.  Waiting for later slices (ROADMAP.md): steps_per_call > 1 (the
scanned multi-step), the device-resident loader, segmented and preemption-
safe runs, audio and figure reports, the data-parallel and time-sharded
steps.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.ops import mean_std_loudness
from ddsp_pytorch_tpu_torch.training.loss import spectral_loss_from_signals
from ddsp_pytorch_tpu_torch.training.metrics import MetricsWriter
from ddsp_pytorch_tpu_torch.training.optim import Optimizer, global_norm, make_optimizer
from ddsp_pytorch_tpu_torch.training.state import Checkpointer, TrainState


def _normalize_loudness(batch, mean, std):
    batch = dict(batch)
    batch["loudness"] = (batch["loudness"] - mean) / std
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays → float32 tensors on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in batch.items()}


def loss_and_grads(
    model,
    batch: Dict[str, torch.Tensor],
    mean_loudness: float,
    std_loudness: float,
    scales,
    overlap: float,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """The train step's loss and the gradient of every parameter, in
    `model.named_parameters()` order (train.py:119-131).  The filtered
    noise is `noise` (B, F, block) if given, else drawn from `generator`."""
    model_batch = _normalize_loudness(batch, mean_loudness, std_loudness)
    out = model(model_batch, noise=noise, generator=generator)
    loss, _, _ = spectral_loss_from_signals(batch["sig"], out["signal"], scales, overlap)
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), list(grads)


def apply_gradient_update(state: TrainState, tx: Optimizer, loss, grads) -> Dict[str, torch.Tensor]:
    """Optimizer update behind the NaN guard (train.py:66-106), in place.

    A non-finite loss leaves the parameters and the optimizer state (Adam's
    count included) as they were, and the step still advances so the data
    order stays deterministic.  The choice is made on the device
    (torch.where), so the step does not wait for the loss.  Returns the
    step's metrics as 0-d device tensors."""
    updates, opt_state = tx.update(grads, state.opt_state)
    finite = torch.isfinite(loss)
    with torch.no_grad():
        for p, u in zip(state.params(), updates):
            p.copy_(torch.where(finite, p + u, p))
    state.opt_state = _select(finite, opt_state, state.opt_state)
    state.step += 1
    return {
        "loss": loss,
        "grad_norm": global_norm(grads),
        "update_skipped": torch.logical_not(finite).to(torch.int32),
    }


def _select(cond, new, old):
    if isinstance(new, dict):
        return {k: _select(cond, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [_select(cond, a, b) for a, b in zip(new, old)]
    return torch.where(cond, new, old)


def make_train_step(model, tx: Optimizer, config: Config) -> Callable:
    """train_step(state, batch, noise=None) → metrics: one optimizer step
    in place (train.py:109-134).  The noise is drawn from the state's
    generator on the device unless `noise` is injected."""
    scales = tuple(config.train.scales)
    overlap = config.train.overlap

    def train_step(state: TrainState, batch, noise: Optional[torch.Tensor] = None):
        loss, grads = loss_and_grads(
            model, batch, state.mean_loudness, state.std_loudness, scales, overlap,
            noise=noise, generator=None if noise is not None else state.generator,
        )
        return apply_gradient_update(state, tx, loss, grads)

    return train_step


def make_eval_step(model, config: Config) -> Callable:
    """eval_step(state, batch, generator) → the model's outputs plus the
    loss (train.py:198-217), without gradients; the spectrograms and audio
    the JAX step adds feed media reports, which wait."""
    scales = tuple(config.train.scales)
    overlap = config.train.overlap

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: torch.Generator):
        model_batch = _normalize_loudness(batch, state.mean_loudness, state.std_loudness)
        out = model(model_batch, generator=generator)
        out["loss"] = spectral_loss_from_signals(batch["sig"], out["signal"], scales, overlap)[0]
        return out

    return eval_step


class Trainer:
    """The training loop for one device: logging, validation, checkpoints and
    exact resume (train.py:220-905 without its mesh, scan and preemption
    paths).  `eval_forwards` counts the model forwards it ran outside the
    train steps (validation and the per-log-epoch eval)."""

    def __init__(self, config: Config, run_dir: str, *, device="cuda"):
        if config.mesh.time > 1 or config.mesh.data > 1:
            raise NotImplementedError(
                f"mesh {config.mesh}: the port trains on one device; the data-parallel "
                "and time-sharded steps wait for a later slice (ROADMAP.md)"
            )
        if config.train.steps_per_call != 1:
            raise NotImplementedError(
                f"train.steps_per_call={config.train.steps_per_call}: the port runs one "
                "step per call; the scanned multi-step waits (ROADMAP.md)"
            )
        self.config = config
        self.run_dir = run_dir
        self.device = resolve_device(device)
        os.makedirs(run_dir, exist_ok=True)
        self.model = load_model(config.model.name, config.model.kwargs).to(self.device)
        self.tx = make_optimizer(config)
        self.metrics = MetricsWriter(run_dir)
        self.checkpointer = Checkpointer(run_dir, max_to_keep=config.train.keep_checkpoints)
        self._train_step = make_train_step(self.model, self.tx, config)
        self._eval_step = make_eval_step(self.model, config)
        self.eval_forwards = 0

    # ------------------------------------------------------------ state
    def init_state(self, mean_loudness=0.0, std_loudness=1.0) -> TrainState:
        """Fresh weights (flax's initializers) and optimizer state; the
        generator that drew the weights then draws the noise."""
        generator = torch.Generator(self.device).manual_seed(self.config.train.seed)
        init_params(self.model, generator)
        return TrainState(
            step=0,
            model=self.model,
            opt_state=self.tx.init([p for _, p in self.model.named_parameters()]),
            generator=generator,
            mean_loudness=float(mean_loudness),
            std_loudness=float(std_loudness),
        )

    def resume_or_init(self, mean_loudness=0.0, std_loudness=1.0):
        """(state, resumed): the newest checkpoint if there is one, else a
        fresh state."""
        state = self.init_state(mean_loudness, std_loudness)
        restored = self.checkpointer.restore(state)
        return (state, False) if restored is None else (restored, True)

    def _loudness_stats(self, train_loader):
        """The config's stats; else those frozen in the run's config when
        there is a checkpoint to resume (a resumed run must not change its
        normalization); else computed over the train loader."""
        cfg = self.config
        mean_l, std_l = cfg.data.mean_loudness, cfg.data.std_loudness
        frozen = os.path.join(self.run_dir, "config.yaml")
        if (mean_l is None or std_l is None) and os.path.exists(frozen) \
                and self.checkpointer.latest_step() is not None:
            fcfg = Config.from_yaml(frozen)
            mean_l, std_l = fcfg.data.mean_loudness, fcfg.data.std_loudness
        if mean_l is None or std_l is None:
            mean_l, std_l = mean_std_loudness(train_loader)
        return mean_l, std_l

    # -------------------------------------------------------------- loop
    def fit(self, datamodule, total_steps: Optional[int] = None) -> TrainState:
        """Train to `total_steps` (default train.steps), resuming from the
        newest checkpoint in the run directory."""
        cfg = self.config
        if total_steps is None:
            total_steps = cfg.train.steps
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()

        mean_l, std_l = self._loudness_stats(train_loader)
        cfg.data.mean_loudness, cfg.data.std_loudness = mean_l, std_l
        cfg.to_yaml(os.path.join(self.run_dir, "config.yaml"))

        state, resumed = self.resume_or_init(mean_l, std_l)
        start_step = state.step if resumed else 0
        steps_per_epoch = max(1, len(train_loader))
        n_epochs = math.ceil(total_steps / steps_per_epoch)
        meta = self.checkpointer.best_meta()
        best_loss = meta["loss"] if meta is not None else float("inf")
        sample = next(iter(train_loader))  # the batch of the per-log-epoch eval

        pending = []  # (step, metrics) not yet written
        mean_loss, n_elem = 0.0, 0
        flush_every = max(1, cfg.train.metrics_flush_steps)
        last_flush = state.step

        def flush():
            nonlocal mean_loss, n_elem, last_flush
            last_flush = state.step
            if not pending:
                return
            values = torch.stack(
                [torch.stack([m["loss"].float(), m["grad_norm"].float(),
                              m["update_skipped"].float()]) for _, m in pending]
            ).tolist()
            for (step, _), (loss, grad_norm, skipped) in zip(pending, values):
                self.metrics.add_scalar("loss", loss, step)
                self.metrics.add_scalar("grad_norm", grad_norm, step)
                self.metrics.add_scalar("update_skipped", int(skipped), step)
                n_elem += 1
                mean_loss += (loss - mean_loss) / n_elem
            pending.clear()

        t_start = time.perf_counter()
        for epoch in range(start_step // steps_per_epoch, n_epochs):
            train_loader.set_epoch(epoch)
            # a resume mid-epoch skips the batches already trained, so the
            # step → batch mapping matches an uninterrupted run
            skip = start_step % steps_per_epoch if epoch == start_step // steps_per_epoch else 0
            for batch_index, batch in enumerate(train_loader):
                if batch_index < skip:
                    continue
                prev_step = state.step
                metrics = self._train_step(state, to_device(batch, self.device))
                pending.append((state.step, metrics))
                if state.step - last_flush >= flush_every:
                    flush()
                every = cfg.train.checkpoint_every_steps
                if every > 0 and state.step // every > prev_step // every:
                    self.checkpointer.save(state)
                if state.step >= total_steps:
                    break
            if state.step - last_flush >= flush_every:
                flush()
            if cfg.train.val_interval_epochs > 0 and epoch % cfg.train.val_interval_epochs == 0:
                self._run_validation(state, val_loader)
            if cfg.train.log_interval_epochs > 0 and epoch % cfg.train.log_interval_epochs == 0:
                flush()
                if n_elem > 0 and mean_loss < best_loss:
                    best_loss = mean_loss
                    self.checkpointer.save_best(self.model.state_dict(), state.step, mean_loss)
                mean_loss, n_elem = 0.0, 0
                self._log_eval(state, sample)
            if state.step >= total_steps:
                break

        flush()
        if state.step > start_step:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            window = time.perf_counter() - t_start
            self.metrics.add_scalar("train_window_s", window, state.step)
            self.metrics.add_scalar(
                "train_window_steps_per_s", (state.step - start_step) / max(window, 1e-9), state.step
            )
        self.checkpointer.save(state)
        return state

    def _eval(self, state, batch, seed: int):
        self.eval_forwards += 1
        generator = torch.Generator(self.device).manual_seed(seed)
        return self._eval_step(state, to_device(batch, self.device), generator)

    def _run_validation(self, state, val_loader) -> None:
        losses = [float(self._eval(state, batch, 0)["loss"]) for batch in val_loader]
        if losses:
            self.metrics.add_scalar("loss/val", float(np.mean(losses)), state.step)

    def _log_eval(self, state, sample_batch) -> None:
        out = self._eval(state, sample_batch, 1)
        self.metrics.add_scalar("loss/train", float(out["loss"]), state.step)
        reverb = getattr(self.model, "reverb", None)
        if reverb is not None:
            self.metrics.add_scalar("reverb_decay", float(reverb.decay.detach()), state.step)
            self.metrics.add_scalar("reverb_wet", float(reverb.wet.detach()), state.step)

    def close(self) -> None:
        self.metrics.close()
