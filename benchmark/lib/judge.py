"""The numbers `correct` compares, each against a limit from the cell file.

Training (a leaf's gap: the gap between the program's norm of it and the
reference's, over the larger of the reference leaf's norm and the median
leaf's):
  loss_gap     |loss − loss_ref| / |loss_ref| of the first step: float32's
               own rounding reads ~1e-5 (the corpus's noise floor keeps
               every bin above it), the program's bf16 NN ~1e-3.  Later
               steps are not compared: Adam's first update is ±lr wherever
               a gradient is not small, so float32's rounding flips the
               sign of some and the later losses read that, not the program
  update_gap   the parameters' change after the compared steps, the worst
               leaf's gap, over the leaves whose first reference gradient
               is at least a thousandth of the median leaf's (the others
               move by round-off alone under Adam)
  grad_gap     the first gradient, the median leaf's gap: printed, not
               compared (the GRU's backward over 375 frames spreads
               float32's rounding into it as far as any control or fault
               reads; PERF.md gives them)
Serving:
  audio_rms_gap  ‖served − reference‖ / ‖reference‖ over every compared
               sample of every compared session.  The widest gap over the
               peak is printed, not compared: float32's phase carry drifts
               over a long stream (~1e-5 rad, times k for harmonic k), so
               the widest sound gap reads as high as TF32's (PERF.md)
  unanswered   requests sent and never answered (limit 0)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import ddsp

Tensors = Dict[str, torch.Tensor]
SILENT_LEAF = 1e-3  # of the median leaf's first-gradient norm


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: Tensors, ref: Tensors, names: List[str]) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)."""
    nr = {k: _norm(ref[k]) for k in names}
    median = float(np.median(list(nr.values())))
    return {k: abs(_norm(prog[k]) - nr[k]) / max(nr[k], median) for k in names}


def leaf_gap(prog: Tensors, ref: Tensors, names: List[str]) -> float:
    return max(leaf_gaps(prog, ref, names).values())


def reference_train(cfg, weights: Tensors, batches, noises, mean, std, dtype):
    """The reference's (losses, first gradient, parameters after the
    steps) in `dtype`."""
    p = {k: v.to(dtype) for k, v in weights.items()}
    batches = [{k: v.to(dtype) for k, v in b.items()} for b in batches]
    noises = [n.to(dtype) for n in noises]
    return ddsp.train_steps(p, cfg, batches, noises, mean, std)


def train_numbers(losses, g1: Tensors, p_end: Tensors, ref, weights: Tensors) -> dict:
    r_losses, r_g1, r_end = ref
    names = list(r_g1)
    loss_gap = abs(losses[0] - r_losses[0]) / abs(r_losses[0])
    norms = {k: _norm(r_g1[k]) for k in names}
    floor = SILENT_LEAF * float(np.median(list(norms.values())))
    moving = [k for k in names if norms[k] >= floor]
    p0 = {k: weights[k].double() for k in names}
    d_prog = {k: p_end[k].double() - p0[k] for k in moving}
    d_ref = {k: r_end[k].double() - p0[k] for k in moving}
    return {"loss_gap": loss_gap,
            "grad_gap": float(np.median(list(leaf_gaps(g1, r_g1, names).values()))),
            "update_gap": leaf_gap(d_prog, d_ref, moving)}


def worst(gaps: Dict[str, float], n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


def train_checks(cfg, weights, batches, noises, mean, std, losses, g1, p_end, limits, dtype):
    """(checks, detail): each number with its limit, and which leaves and
    steps read highest."""
    ref = reference_train(cfg, weights, batches, noises, mean, std, dtype)
    values = train_numbers(losses, g1, p_end, ref, weights)
    names = list(ref[1])
    detail = {"losses (program, reference)": list(zip(losses, ref[0])),
              "grad_gap (not compared)": values["grad_gap"],
              "worst first-gradient leaves": worst(leaf_gaps(g1, ref[1], names))}
    return {k: [values[k], float(limits[k])] for k in ("loss_gap", "update_gap")}, detail


def audio_gap(served: List[np.ndarray], reference: List[np.ndarray]) -> float:
    peak = max(float(np.max(np.abs(r))) for r in reference if r.size)
    return max(float(np.max(np.abs(s.astype(np.float64) - r))) for s, r in zip(served, reference)
               if r.size) / peak


def audio_rms_gap(served: List[np.ndarray], reference: List[np.ndarray]) -> float:
    num = sum(float(np.sum((s.astype(np.float64) - r) ** 2)) for s, r in zip(served, reference))
    den = sum(float(np.sum(r ** 2)) for r in reference)
    return (num / den) ** 0.5
