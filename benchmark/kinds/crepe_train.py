"""CREPE training cells: the program's CREPE step object, measured over
whole steps.

Set-up builds the program's `CrepeTrainer` (train_crepe.py) from the seed —
its Adam state and the generator every batch and dropout mask is drawn
from — loads the benchmark's weights and statistics from the seed into it
(lib/crepe_weights.py, not the program's initialiser), and runs its first
three steps (the ones compared), one
evaluation (`evaluate`: RPA50 on the fixed eval batch), then groups of
`pull_every` steps, each ended by the pull of its last loss, until
`settle_s` has passed and two groups in a row read within SETTLED.  The
window runs the same groups until `seconds` of untraced groups have
passed; `train_step_ms` is its time over the steps it completed.  A traced
run profiles the window's second group.

`correct`: the plain reference (benchmark/reference/crepe.py, float64, on
the same device, the whole batch: BatchNorm couples it) follows the first
three steps from the benchmark's weights and statistics, redrawing the
program's random numbers from a copy of the trainer's generator as it
stood before the first step: each step's synthesis draws, then one mask a
block in forward order.  Compared, each against the cell's limit:

  frames_gap   the first step's synthesized frames, the largest gap over
               the reference frames' peak
  loss_gap     the first step's loss, |loss − ref| / |ref|
  update_gap   the parameters' change after step 3: the worst leaf's gap
               of norms (lib/judge.py `leaf_gap`)
  stats_gap    BatchNorm's running statistics' change after step 1: the
               worst leaf's ‖Δ − Δ_ref‖ / ‖Δ_ref‖.  After step 3 (printed,
               not compared) the statistics read the batches of parameters
               that Adam's first update moved by ±lr wherever a gradient is
               not small, so float32's rounding, flipping some signs, reads
               there as high as any fault (up to 6e-2 at tiny capacity on
               the CPU), and a wrong running variance hides
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark.harness import Run
from benchmark.lib import crepe_weights, judge
from benchmark.lib.card import sm_clock
from benchmark.lib.crepe_flops import CONV_OPS
from benchmark.lib.op_trace import OpTrace
from benchmark.lib.weights import sub_seed
from benchmark.reference import crepe as reference

COMPARED_STEPS = 3
SETTLED = 0.01  # two groups' ms a step this close: the step has settled


def make_trainer(cfg, seed, device):
    """The program's step object of configuration `cfg` from run seed
    `seed`, holding the benchmark's weights and statistics from that seed;
    a dict that receives the first batch's frames; and those weights,
    copied to the host."""
    from ddsp_pytorch_tpu_torch.train_crepe import CrepeTrainer

    first = {}

    class Observed(CrepeTrainer):
        def draw_batch(self):
            frames, f0 = super().draw_batch()
            if "frames" not in first:
                first["frames"] = frames.detach().clone()
            return frames, f0

    m, tc = cfg["model"], cfg["train"]
    trainer = Observed(m["capacity"], tc["batch"], tc["lr"], tc["pos_weight"], tc["robust"],
                       sub_seed(seed, 0), dropout=m["dropout"], dtype=m["dtype"], device=device)
    weights = crepe_weights.make_weights(cfg, seed, device)
    trainer.model.load_state_dict(weights)
    return trainer, first, {k: v.cpu() for k, v in weights.items()}


def first_steps(trainer, first, weights) -> dict:
    """Run the trainer's first COMPARED_STEPS steps from `weights`; what the
    judge needs of them, copied to the host (the window's device holds what
    training does)."""
    def state():
        return {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}

    gen0 = trainer.generator.get_state()
    losses, states = [], []
    for _ in range(COMPARED_STEPS):
        losses.append(trainer.step())
        states.append(state())
    return {"state0": weights, "gen0": gen0, "states": states, "loss1": trainer.pull(losses[0]),
            "frames": first["frames"].cpu()}


def reference_steps(cfg, seen: dict, device, dtype=torch.float64, allow_tf32=False) -> dict:
    """The reference's steps from the benchmark's weights, on `device`; its
    frames and states copied to the host."""
    gen = torch.Generator(device)
    gen.set_state(seen["gen0"])
    state0 = {k: v.to(device) for k, v in seen["state0"].items()}
    ref = reference.train_steps(state0, gen, cfg, COMPARED_STEPS, dtype, allow_tf32)
    ref["frames"] = ref["frames"].cpu()
    ref["states"] = [{k: v.cpu() for k, v in s.items()} for s in ref["states"]]
    return ref


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _stats_gap(s0: dict, prog: dict, ref: dict) -> float:
    stats = [k for k in s0 if ".running_" in k]
    return max(_norm(prog[k].double() - ref[k].double()) / _norm(ref[k].double() - s0[k].double())
               for k in stats)


def numbers(seen: dict, ref: dict) -> dict:
    """The four compared numbers of the program's first steps `seen`
    against the reference's `ref`, and the statistics' gap after the last
    step (`stats_gap_end`, not compared)."""
    r_frames = ref["frames"].double()
    frames_gap = float((seen["frames"].double() - r_frames).abs().max() / r_frames.abs().max())
    loss_gap = abs(seen["loss1"] - ref["losses"][0]) / abs(ref["losses"][0])
    s0, s_end, r_end = seen["state0"], seen["states"][-1], ref["states"][-1]
    params = [k for k in s0 if ".running_" not in k]
    delta = {k: s_end[k].double() - s0[k].double() for k in params}
    r_delta = {k: r_end[k].double() - s0[k].double() for k in params}
    return {"frames_gap": frames_gap, "loss_gap": loss_gap,
            "update_gap": judge.leaf_gap(delta, r_delta, params),
            "stats_gap": _stats_gap(s0, seen["states"][0], ref["states"][0]),
            "stats_gap_end": _stats_gap(s0, s_end, r_end)}


def _group(trainer, n: int):
    """n steps and the pull of the last one's loss: (ms a step, loss)."""
    t = time.perf_counter()
    for _ in range(n):
        loss = trainer.step()
    value = trainer.pull(loss)
    return 1e3 * (time.perf_counter() - t) / n, value


def run(cfg, params, limits, seed, seconds, trace, device, mono_start) -> Run:
    group = int(params["pull_every"])
    trainer, first, weights = make_trainer(cfg, seed, device)
    seen = first_steps(trainer, first, weights)
    rpa50 = trainer.evaluate()
    settle_ms = []
    t0 = time.perf_counter()
    while True:
        settle_ms.append(round(_group(trainer, group)[0], 3))
        if (time.perf_counter() - t0 >= float(params["settle_s"]) and len(settle_ms) >= 2
                and abs(settle_ms[-1] - settle_ms[-2]) <= SETTLED * settle_ms[-2]):
            break

    # ---------------------------------------------------------- window
    tracer = OpTrace(device) if trace else None
    if tracer is not None:  # the profiler's first start initialises it: not in the window
        tracer.start()
        tracer.stop()
    trace_group = 1
    t_setup_end = time.monotonic()
    steps = groups = failed = untraced_steps = 0
    untraced_s = 0.0
    group_ms = []  # ms a step of each untraced group, in order
    t0 = time.perf_counter()
    while True:
        traced = tracer is not None and groups == trace_group
        if traced:
            tracer.start()
        t = time.perf_counter()
        ms, value = _group(trainer, group)
        if traced:
            tracer.stop()
        else:
            untraced_s += time.perf_counter() - t
            untraced_steps += group
            group_ms.append(round(ms, 3))
        groups += 1
        steps += group
        failed += 0 if math.isfinite(value) else group
        if untraced_s >= seconds and (tracer is None or groups > trace_group):
            break
    elapsed = time.perf_counter() - t0
    clock = sm_clock()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counters = dict(trainer.metrics)
    layer = {"step_s": untraced_s / untraced_steps, "traced_steps": group}
    info = {
        "window": f"{groups} groups, {steps} steps in {elapsed:.4f} s "
                  f"({1e3 * elapsed / steps:.4f} ms a step), non-finite losses' steps {failed}; "
                  f"ms a step by group {group_ms}",
        "set-up": f"{t_setup_end - mono_start:.4f} s, of which {len(settle_ms)} groups of {group} "
                  f"steps to settle, ms a step {settle_ms}",
        "sm_clock": clock,
        "eval": f"RPA50 {rpa50:.4f} after {COMPARED_STEPS} steps",
        "counters": counters,
    }
    if tracer is not None and device.type == "cuda":
        convs = tracer.launched_by(CONV_OPS)
        conv_s = sum(e - s for _, s, e in convs) / 1e9
        info["trace"] = (f"{len(tracer.device_ops)} device operations over {tracer.window_s:.4f} s "
                         f"(the profiler took {tracer.start_s:.4f} s to start); "
                         f"{len(convs)} kernels of {'/'.join(CONV_OPS)}: {1e3 * conv_s / group:.4f} ms "
                         f"a step, {100 * conv_s / max(tracer.busy_s(), 1e-12):.2f} % of device busy")

    # ---------------------------------------------------- correctness
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(cfg, seen, device)
    info["reference"] = (f"{COMPARED_STEPS} steps in float64 in {time.perf_counter() - t_ref:.3f} s; "
                         f"losses {ref['losses']}, program's first {seen['loss1']}")
    values = numbers(seen, ref)
    info["stats_gap after step 3 (not compared)"] = values["stats_gap_end"]
    checks = {k: [values[k], float(limits[k])] for k in ("frames_gap", "loss_gap", "update_gap", "stats_gap")}
    return Run(
        e2e={"train_step_ms": 1e3 * elapsed / steps, "setup_s": t_setup_end - mono_start},
        attempted=steps, failed=failed, checks=checks, memory_peak_bytes=memory_peak,
        info=info, trace=tracer, layer=layer,
    )
