"""Train state and checkpoints (port of ddsp_pytorch_tpu/training/state.py
:102-237, on torch.save instead of Orbax).

A checkpoint is the whole train state — step, model state_dict, optimizer
state, the noise generator's state and the loudness stats — so a resumed
run continues exactly where the saved one stopped.  Layout under run_dir:

  checkpoints/<step>.pt   full train state, the newest `max_to_keep` kept
  best/params.pt          the best-(train)-loss model state_dict
  best/meta.json          step and loss of that snapshot
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """Everything needed to resume training exactly.  `model` holds the
    parameters; `generator` (on the model's device) draws the noise of
    every train step."""

    step: int
    model: nn.Module
    opt_state: dict
    generator: torch.Generator
    mean_loudness: float
    std_loudness: float

    def params(self):
        return [p for _, p in self.model.named_parameters()]

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "params": {k: v.detach().clone() for k, v in self.model.state_dict().items()},
            "param_names": [name for name, _ in self.model.named_parameters()],
            "opt_state": self.opt_state,
            "generator": self.generator.get_state(),
            "mean_loudness": self.mean_loudness,
            "std_loudness": self.std_loudness,
        }

    def load_state_dict(self, saved: dict) -> None:
        names = [name for name, _ in self.model.named_parameters()]
        if saved["param_names"] != names:
            raise ValueError("checkpoint parameters do not match the model's")
        device = next(self.model.parameters()).device
        self.step = int(saved["step"])
        self.model.load_state_dict(saved["params"])
        self.opt_state = _to_device(saved["opt_state"], device)
        self.generator.set_state(saved["generator"])
        self.mean_loudness = float(saved["mean_loudness"])
        self.std_loudness = float(saved["std_loudness"])


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _save_atomic(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Checkpointer:
    """Full-state checkpoints with retention, and the best-loss params.

    Under a mesh across processes (parallel/mesh.py) the state is
    replicated: rank 0 writes, every rank waits at a barrier after the
    write, and every rank restores from the shared run directory
    (state.py:207-214)."""

    _CKPT = re.compile(r"^(\d+)\.pt$")

    def __init__(self, run_dir: str, max_to_keep: int = 3, mesh=None):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        self.best_dir = os.path.join(self.run_dir, "best")
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.primary = mesh is None or mesh.is_primary
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _steps(self):
        found = (self._CKPT.match(name) for name in os.listdir(self.ckpt_dir))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, state: TrainState) -> None:
        if self.primary:
            _save_atomic(state.state_dict(), os.path.join(self.ckpt_dir, f"{state.step}.pt"))
            steps = self._steps()
            if self.max_to_keep > 0:
                for step in steps[: -self.max_to_keep]:
                    os.remove(os.path.join(self.ckpt_dir, f"{step}.pt"))
        if self.mesh is not None:
            self.mesh.barrier()

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState) -> Optional[TrainState]:
        """Load the newest checkpoint into `state` (built by the Trainer's
        init_state); None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(
            os.path.join(self.ckpt_dir, f"{step}.pt"), map_location="cpu", weights_only=True
        )
        state.load_state_dict(saved)
        return state

    def save_best(self, params: dict, step: int, loss: float) -> None:
        if not self.primary:
            return
        os.makedirs(self.best_dir, exist_ok=True)
        _save_atomic(
            {k: v.detach().to("cpu") for k, v in params.items()},
            os.path.join(self.best_dir, "params.pt"),
        )
        with open(os.path.join(self.best_dir, "meta.json"), "w") as f:
            json.dump({"step": step, "loss": loss}, f)

    def best_meta(self) -> Optional[dict]:
        path = os.path.join(self.best_dir, "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
