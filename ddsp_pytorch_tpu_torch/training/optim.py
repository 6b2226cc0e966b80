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
           (b1, b2 optax's 0.9 and 0.999 unless given: RAVE trains at
           0.5 and 0.9)
  sgd      u = g · (−lr)
  clip     g ← g if ‖g‖ < max_norm else (g / ‖g‖)·max_norm
           (not clip_grad_norm_'s max/(norm + 1e-6) scale, which always
           applies)

`update` returns the updates and a new state and changes nothing in
place, like an optax GradientTransformation.  `apply_` is the train
steps' one call: it writes the step into the existing tensors, whose
addresses a captured step reuses, behind the NaN guard where it is given
the loss.  On a card, Adam on float32 leaves is ops/adam.py's two kernel
launches a step; the CPU, float64 and SGD take `update` and the copies.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ddsp_pytorch_tpu_torch.ops import adam

Tensors = List[torch.Tensor]
# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ_leaves Σ x²) (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def tree_leaves(tree) -> Tensors:
    """The tensors of a nested dict/list tree, in its order."""
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in tree_leaves(value)]
    if isinstance(tree, (list, tuple)):
        return [leaf for value in tree for leaf in tree_leaves(value)]
    return [tree]


class LinearSchedule:
    """optax.linear_schedule: init → end over transition_steps counts, then
    constant; a constant init_value when transition_steps ≤ 0.  Its
    numbers are what the card's Adam kernel reads (ops/adam.py)."""

    def __init__(self, init_value: float, end_value: float, transition_steps: int):
        self.init_value = init_value
        self.end_value = end_value
        self.transition_steps = transition_steps

    def __call__(self, count: torch.Tensor) -> Union[float, torch.Tensor]:
        if self.transition_steps <= 0:
            return self.init_value
        count = torch.clamp(count, 0, self.transition_steps)
        frac = 1 - count.float() / self.transition_steps
        return (self.init_value - self.end_value) * frac + self.end_value


def _int32_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, saturating at the int32 maximum (optax safe_increment)."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


class Optimizer:
    """Adam or SGD, a constant rate or a `LinearSchedule`, and an optional
    global-norm clip."""

    def __init__(self, name: str, lr: Union[float, LinearSchedule], grad_clip_norm: Optional[float] = None,
                 b1: float = B1, b2: float = B2):
        if name not in ("adam", "sgd"):
            raise ValueError(f"unknown train.optimizer: {name!r}")
        self.name = name
        self.lr = lr
        self.grad_clip_norm = grad_clip_norm
        self.b1, self.b2 = b1, b2
        self._work: Dict[tuple, dict] = {}  # the Adam kernel's workspaces, by device and leaf sizes

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
            b1, b2 = self.b1, self.b2
            new["mu"] = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
            new["nu"] = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state["nu"])]
            new["count"] = _int32_increment(state["count"])
            n = new["count"].float()
            # a Python-float base: no host tensor to copy in, so the update
            # can be captured in a CUDA graph (same float32 values as a
            # float32 tensor base)
            c1 = 1 - torch.pow(b1, n)
            c2 = 1 - torch.pow(b2, n)
            updates = [(m / c1) / (torch.sqrt(v / c2) + EPS) for m, v in zip(new["mu"], new["nu"])]
        else:
            updates = grads
        if callable(self.lr):
            step_size = -self.lr(state["schedule_count"])
            new["schedule_count"] = _int32_increment(state["schedule_count"])
        else:
            step_size = -self.lr
        return [step_size * u for u in updates], new

    def apply_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: dict,
               loss: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The step in place: `params` and `state`'s tensors (the same
        tensors, which a captured step reads at fixed addresses) take the
        updated values.  Where `loss` is given, the train step's NaN guard:
        a non-finite loss leaves them all as they were, Adam's count
        included, and the step's metrics are returned as 0-d device tensors
        (loss, grad_norm, update_skipped); without a loss, no guard and no
        metrics.

        Adam on float32 leaves on a card runs ops/adam.py's kernels: two
        launches a step, whatever the number of leaves (one without a loss
        or a clip, which need no norm).  Everything else runs the plain
        path, `update` and the copies, in the same float32 operations."""
        params, grads = list(params), list(grads)
        if self.name == "adam" and params[0].is_cuda and params[0].dtype == torch.float32:
            norm = self._adam_kernel(params, grads, state, loss)
        else:
            updates, new = self.update(grads, state)
            finite = None if loss is None else torch.isfinite(loss)
            with torch.no_grad():
                for old, value in zip(params + tree_leaves(state),
                                      [p + u for p, u in zip(params, updates)] + tree_leaves(new)):
                    old.copy_(value if finite is None else torch.where(finite, value, old))
            norm = None if loss is None else global_norm(grads)
        if loss is None:
            return {}
        return {"loss": loss, "grad_norm": norm,
                "update_skipped": torch.logical_not(torch.isfinite(loss)).to(torch.int32)}

    def _adam_kernel(self, params: Tensors, grads: Tensors, state: dict, loss) -> Optional[torch.Tensor]:
        """ops/adam.py's step; returns the gradients' norm where `loss` is
        given."""
        numels = tuple(p.numel() for p in params)
        key = (params[0].device, numels)
        if key not in self._work:
            self._work[key] = adam.workspace(numels, params[0].device)
        lr, lr_end, steps = self.lr, 0.0, 0
        if isinstance(self.lr, LinearSchedule):
            s = self.lr
            lr, lr_end, steps = ((s.init_value - s.end_value, s.end_value, s.transition_steps)
                                 if s.transition_steps > 0 else (s.init_value, 0.0, 0))
        return adam.adam_(params, [g.contiguous() for g in grads], state["mu"], state["nu"], state["count"],
                          self._work[key], lr=lr, lr_end=lr_end, steps=steps,
                          schedule_count=state.get("schedule_count"), clip=self.grad_clip_norm, loss=loss,
                          norm=loss is not None, b1=self.b1, b2=self.b2)


def make_optimizer(config) -> Optimizer:
    """The optimizer of config.train (train.py:32-49); Adam's betas are
    optax's unless the model's recipe names its own
    (config.model.kwargs.optimizer_betas, models/rave.py)."""
    tc = config.train
    if tc.lr_stop is not None:
        lr = LinearSchedule(tc.lr, tc.lr_stop, tc.lr_decay_steps or tc.steps)
    else:
        lr = tc.lr
    b1, b2 = config.model.kwargs.get("optimizer_betas", (B1, B2))
    return Optimizer(tc.optimizer, lr, tc.grad_clip_norm, float(b1), float(b2))
