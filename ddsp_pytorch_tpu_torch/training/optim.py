"""Optimizers with optax's arithmetic, as functions on lists of tensors.

Port of `make_optimizer` (ddsp_pytorch_tpu/training/train.py:32-49):
Adam or SGD, a constant learning rate or optax's linear schedule lr →
lr_stop over lr_decay_steps, and optionally optax's `clip_by_global_norm`
in front.  Written out rather than taken from torch.optim because the
train step's NaN guard must leave the optimizer state untouched, Adam's
step count included (torch.optim.Adam increments its step on every
`.step()`), and because optax's formulas differ in detail:

  adam     mu ← (1−b1)·g + b1·mu;  nu ← (1−b2)·g² + b2·nu;  n ← n + 1
           u = (mu / (1 − b1ⁿ)) / (√(nu / (1 − b2ⁿ)) + eps) · (−lr)
  sgd      u = g · (−lr)
  clip     g ← g if ‖g‖ < max_norm else (g / ‖g‖)·max_norm
           (not clip_grad_norm_'s max/(norm + 1e-6) scale, which always
           applies)

`update` returns the updates and a new state and changes nothing in
place, like an optax GradientTransformation, so the caller decides whether
to apply them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Tensors = List[torch.Tensor]
# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ_leaves Σ x²) (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """optax.linear_schedule: init → end over transition_steps counts, then
    constant; a constant init_value when transition_steps ≤ 0."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(count, 0, transition_steps)
        frac = 1 - count.float() / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _int32_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, saturating at the int32 maximum (optax safe_increment)."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


class Optimizer:
    """Adam or SGD, an optional schedule and an optional global-norm clip."""

    def __init__(self, name: str, lr: Union[float, Callable], grad_clip_norm: Optional[float] = None):
        if name not in ("adam", "sgd"):
            raise ValueError(f"unknown train.optimizer: {name!r}")
        self.name = name
        self.lr = lr
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        device = params[0].device
        state = {}
        if self.name == "adam":
            state["count"] = torch.zeros((), dtype=torch.int32, device=device)
            state["mu"] = [torch.zeros_like(p) for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        if callable(self.lr):
            state["schedule_count"] = torch.zeros((), dtype=torch.int32, device=device)
        return state

    def update(self, grads: Sequence[torch.Tensor], state: dict) -> Tuple[Tensors, dict]:
        """(updates to add to the params, new state)."""
        grads = list(grads)
        new = dict(state)
        if self.grad_clip_norm is not None:
            g_norm = global_norm(grads)
            trigger = g_norm < self.grad_clip_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.grad_clip_norm) for g in grads]
        if self.name == "adam":
            new["mu"] = [(1 - B1) * g + B1 * m for g, m in zip(grads, state["mu"])]
            new["nu"] = [(1 - B2) * (g * g) + B2 * v for g, v in zip(grads, state["nu"])]
            new["count"] = _int32_increment(state["count"])
            n = new["count"].float()
            c1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=n.device), n)
            c2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=n.device), n)
            updates = [(m / c1) / (torch.sqrt(v / c2) + EPS) for m, v in zip(new["mu"], new["nu"])]
        else:
            updates = grads
        if callable(self.lr):
            step_size = -self.lr(state["schedule_count"])
            new["schedule_count"] = _int32_increment(state["schedule_count"])
        else:
            step_size = -self.lr
        return [step_size * u for u in updates], new


def make_optimizer(config) -> Optimizer:
    """The optimizer of config.train (train.py:32-49)."""
    tc = config.train
    if tc.lr_stop is not None:
        lr = linear_schedule(tc.lr, tc.lr_stop, tc.lr_decay_steps or tc.steps)
    else:
        lr = tc.lr
    return Optimizer(tc.optimizer, lr, tc.grad_clip_norm)
