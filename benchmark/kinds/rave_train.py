"""RAVE training cells: RAVE v1's phase-1 step on the program's graphed
trainer path, measured over whole calls.

Set-up builds the program's step object as its Trainer does — the model
(`rave-v1`) with the seed's weights and statistics (lib/rave_weights.py),
Adam's state at the configuration's betas, the program's `MultiStep` of
`steps_per_call` graphed steps over a `DeviceDataLoader` of the seed's
crops (lib/rave_corpus.py) — and drives it through its first call (which
captures the graph), then through whole calls until the step has settled
(`settle_s`, the cell's).  The window runs whole calls, each followed by
the pull of its metrics as the Trainer does, until `seconds` have passed;
`train_step_ms` is its time over the steps it completed.  A traced run
profiles the window's second call and, after the window, one eager run of
the step's bodies (the model's `loss_and_grads`, the BatchNorm statistics
put back after it) under lib/op_trace.py: a graph replay's kernels carry no
link to the operators that captured them, and the convolutions' roofline
reads that link.

`correct`: the plain reference (benchmark/reference/rave.py, float64, on
the same device) follows the first three steps of set-up's call from the
same weights, crops and draws (ε drawn again from a copy of the generator
the state carries: the program draws each step's ε from it, in step
order).  The graphed step returns no gradients, so the program's
first-step gradients come from one eager run of its step from the set-up
weights on step 1's crops and ε, before the first call (BatchNorm's
statistics put back after it).  Compared, each against the cell's limit:

  loss_gap     the first step's loss, |loss − ref| / |ref|
  grad_gap     the first step's gradients: the median over the trained
               leaves of ‖g − g_ref‖ / max(‖g_ref‖, the median leaf's
               ‖g_ref‖) (the floor for the biases in front of BatchNorm,
               whose gradient is rounding alone).  The median, not the
               worst leaf: the log term's weights 1/|S_y| on the near-silent
               bins of a fresh generator's output make a few leaves'
               float32 gradients (the convolutions in front of BatchNorm,
               the generator's first) differ from float64 by up to 1.5 of
               the median leaf's norm on a sound run, as much as under a
               wrong loss; a fault in the loss's backward moves every leaf
  update_gap   the parameters' change after step 3: the worst leaf's gap
               of norms (lib/judge.py `leaf_gap`) over the leaves whose
               first reference gradient is at least a thousandth of the
               median leaf's (the biases in front of BatchNorm have a
               gradient of rounding alone, and Adam at β₁ 0.5 moves them by
               ±lr on its sign)
  stats_gap    BatchNorm's running statistics' change after step 1: the
               worst leaf's ‖Δ − Δ_ref‖ / ‖Δ_ref‖

The program's RAVE modules are imported here, at the top: a program
without them fails this kind at once.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.models.rave import RAVE

from benchmark.harness import Run
from benchmark.kinds.train import _index_stream, _settle
from benchmark.lib import judge, rave_weights
from benchmark.lib.card import sm_clock
from benchmark.lib.op_trace import OpTrace
from benchmark.lib.rave_flops import CONV_OPS, LOSS_KERNELS
from benchmark.lib.rave_corpus import make_corpus
from benchmark.lib.weights import sub_seed
from benchmark.reference import rave as reference

COMPARED_STEPS = 3
# the configuration's model keys the program's RAVE takes
PROGRAM_KEYS = ("n_band", "capacity", "latent_size", "ratios", "loud_stride", "noise_ratios", "noise_bands",
                "sample_rate", "loudness_n_fft", "loudness_hop", "kl_beta")


def program_config(cfg: dict, steps_per_call: int):
    """The program's Config object for this configuration."""
    from ddsp_pytorch_tpu_torch.config import Config

    m, tc = cfg["model"], cfg["train"]
    kwargs = {k: m[k] for k in PROGRAM_KEYS}
    kwargs["optimizer_betas"] = list(tc["betas"])
    return Config.from_dict({
        "preprocess": dict(cfg["preprocess"]),
        "model": {"name": m["name"], "kwargs": kwargs},
        "train": {"scales": tc["scales"], "overlap": tc["overlap"], "batch": tc["batch"], "lr": tc["lr"],
                  "optimizer": tc["optimizer"], "steps_per_call": steps_per_call,
                  "scan_unroll": cfg["assumed"]["scan_unroll"]},
    })


def make_program(cfg: dict, seed: int, device, steps_per_call: int, corpus_items: int):
    """The program's step object from run seed `seed`: (multi, state,
    loader, weights copied to the host, the state's generator state
    before the first step, snapshots) — `snapshots` receives BatchNorm's
    statistics after step 1 and the parameters after step
    COMPARED_STEPS, taken on the host where the program advances
    `state.step` after each replay (in stream order: the state after that
    step)."""
    from ddsp_pytorch_tpu_torch.data.dataset import DeviceDataLoader
    from ddsp_pytorch_tpu_torch.models import load_model
    from ddsp_pytorch_tpu_torch.training.optim import make_optimizer
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import make_train_multi_step_indexed

    pconf = program_config(cfg, steps_per_call)
    weights = rave_weights.make_weights(cfg, seed, device)
    corpus = make_corpus(cfg, corpus_items, seed, device)
    model = load_model(pconf.model.name, pconf.model.kwargs).to(device)
    assert isinstance(model, RAVE)
    model.load_state_dict(weights, strict=True)
    loader = DeviceDataLoader(corpus, cfg["train"]["batch"], shuffle=True, drop_last=True,
                              seed=sub_seed(seed, 3) % 2**32, device=device)
    tx = make_optimizer(pconf)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    snaps = {}

    class Observed(TrainState):
        @property
        def step(self):
            return self.__dict__["_step"]

        @step.setter
        def step(self, value):
            self.__dict__["_step"] = value
            if "opt_state" not in self.__dict__:
                return
            if value == 1:
                snaps["stats1"] = {k: v.detach().clone() for k, v in model.state_dict().items() if ".running_" in k}
            if value == COMPARED_STEPS:
                snaps["p3"] = {k: v.detach().clone() for k, v in model.state_dict().items()}

    state = Observed(step=0, model=model, opt_state=tx.init(list(model.parameters())), generator=gen,
                     mean_loudness=0.0, std_loudness=1.0)
    multi = make_train_multi_step_indexed(model, tx, pconf, steps_per_call, cfg["assumed"]["scan_unroll"])
    return multi, state, loader, {k: v.cpu() for k, v in weights.items()}, gen.get_state(), snaps


def draws(cfg: dict, gen0, device) -> list:
    """The first COMPARED_STEPS steps' ε, drawn again from the generator's
    state before the first step, as the program draws them."""
    gen = torch.Generator(device)
    gen.set_state(gen0)
    m, b, t = cfg["model"], cfg["train"]["batch"], cfg["preprocess"]["signal_length"]
    hop = m["n_band"] * int(np.prod(m["ratios"]))
    return [torch.randn((b, m["latent_size"], t // hop), generator=gen, device=device) for _ in range(COMPARED_STEPS)]


def first_grads(model, cfg: dict, crops: torch.Tensor, eps: torch.Tensor) -> dict:
    """The program's gradients of one eager step on `crops` with `eps`,
    by name, on the host; BatchNorm's statistics put back after it."""
    buffers = [b.detach().clone() for b in model.buffers()]
    _, grads = model.loss_and_grads(None, {"sig": crops}, eps, cfg["train"]["scales"], cfg["train"]["overlap"])
    with torch.no_grad():
        for b, s in zip(model.buffers(), buffers):
            b.copy_(s)
    return {n: g.cpu() for (n, _), g in zip(model.named_parameters(), grads)}


def first_call(multi, state, loader, stream, weights, gen0, snaps, cfg: dict) -> tuple:
    """The first step's gradients (one eager step from the set-up
    weights), the first call (the capture), and what the judge needs of
    its first steps, copied to the host; and the call's metrics rows."""
    first_idx = next(stream)
    crops = [loader.device_data["sig"].index_select(0, torch.as_tensor(first_idx[j], device=loader.device))
             for j in range(COMPARED_STEPS)]
    grads1 = first_grads(state.model, cfg, crops[0], draws(cfg, gen0, loader.device)[0])
    rows = multi(state, loader.device_data, first_idx).cpu().numpy()
    seen = {"state0": weights, "gen0": gen0, "crops": [c.cpu() for c in crops], "loss1": float(rows[0, 0]),
            "grads1": grads1,
            "stats1": {k: v.cpu() for k, v in snaps["stats1"].items()},
            "p3": {k: v.cpu() for k, v in snaps["p3"].items()}}
    return seen, rows


def reference_steps(cfg: dict, seen: dict, device, dtype=torch.float64, allow_tf32: bool = False) -> dict:
    """The reference's steps from the same weights, crops and ε (drawn
    again from the generator's state before the first step), on
    `device`; its states copied to the host."""
    eps = draws(cfg, seen["gen0"], device)
    state0 = {k: v.to(device) for k, v in seen["state0"].items()}
    rcfg = {"model": cfg["model"], "train": cfg["train"]}
    ref = reference.train_steps(state0, rcfg, [c.to(device) for c in seen["crops"]], eps, dtype, allow_tf32)
    ref["states"] = [{k: v.cpu() for k, v in s.items()} for s in ref["states"]]
    ref["grads"] = {k: v.cpu() for k, v in ref["grads"].items()}
    return ref


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def numbers(seen: dict, ref: dict) -> dict:
    """The four compared numbers of the program's first steps `seen`
    against the reference's `ref`, and the worst leaves (not compared)."""
    loss_gap = abs(seen["loss1"] - ref["losses"][0]) / abs(ref["losses"][0])
    s0 = seen["state0"]
    norms = {k: _norm(g) for k, g in ref["grads"].items()}
    median = float(np.median(list(norms.values())))
    grad_gaps = {k: _norm(seen["grads1"][k].double() - g.double()) / max(norms[k], median)
                 for k, g in ref["grads"].items()}
    floor = judge.SILENT_LEAF * median
    moving = [k for k in norms if norms[k] >= floor]
    delta = {k: seen["p3"][k].double() - s0[k].double() for k in moving}
    r_delta = {k: ref["states"][-1][k].double() - s0[k].double() for k in moving}
    stats = list(seen["stats1"])
    stats_gaps = {k: _norm(seen["stats1"][k].double() - ref["states"][0][k].double())
                  / _norm(ref["states"][0][k].double() - s0[k].double()) for k in stats}
    return {"loss_gap": loss_gap, "grad_gap": float(np.median(list(grad_gaps.values()))),
            "update_gap": judge.leaf_gap(delta, r_delta, moving), "stats_gap": max(stats_gaps.values()),
            "worst gradient leaves": judge.worst(grad_gaps),
            "worst update leaves": judge.worst(judge.leaf_gaps(delta, r_delta, moving)),
            "worst statistics": judge.worst(stats_gaps)}


def eager_conv_trace(model, loader, cfg, seed: int, device) -> OpTrace:
    """One eager run of the step's bodies (loss and gradients) under
    lib/op_trace.py, BatchNorm's statistics put back after it."""
    buffers = [b.detach().clone() for b in model.buffers()]
    batch = {"sig": loader.device_data["sig"][:cfg["train"]["batch"]]}
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 9))
    eps = torch.randn(model.latent_shape(*batch["sig"].shape), generator=gen, device=device)
    tracer = OpTrace(device)
    scales, overlap = cfg["train"]["scales"], cfg["train"]["overlap"]
    model.loss_and_grads(None, batch, eps, scales, overlap)  # warm
    torch.cuda.synchronize(device)
    tracer.start()
    model.loss_and_grads(None, batch, eps, scales, overlap)
    tracer.stop()
    with torch.no_grad():
        for b, s in zip(model.buffers(), buffers):
            b.copy_(s)
    return tracer


def run(cfg, params, limits, seed, seconds, trace, device, mono_start) -> Run:
    spc = int(cfg["assumed"]["steps_per_call"])
    multi, state, loader, weights, gen0, snaps = make_program(cfg, seed, device, spc, int(params["corpus_items"]))
    stream = _index_stream(loader, spc)
    seen, first_rows = first_call(multi, state, loader, stream, weights, gen0, snaps, cfg)
    settle_ms = _settle(multi, state, loader, stream, spc, float(params["settle_s"]))

    # ---------------------------------------------------------- window
    tracer = OpTrace(device) if trace else None
    if tracer is not None:  # the profiler's first start initialises it: not in the window
        tracer.start()
        tracer.stop()
    trace_call = 1
    t_setup_end = time.monotonic()
    steps, calls, skipped = 0, 0, 0
    untraced_s = untraced_steps = 0
    call_ms = []
    t0 = time.perf_counter()
    while True:
        t_call = time.perf_counter()
        idx = next(stream)
        traced = tracer is not None and calls == trace_call
        if traced:
            tracer.start()
        rows = multi(state, loader.device_data, idx).cpu().numpy()
        if traced:
            tracer.stop()
        else:
            untraced_s += time.perf_counter() - t_call
            untraced_steps += spc
            call_ms.append(round(1e3 * (time.perf_counter() - t_call) / spc, 3))
        calls += 1
        steps += spc
        skipped += int(rows[:, 2].sum())
        if untraced_s >= seconds and (tracer is None or calls > trace_call):
            break
    elapsed = time.perf_counter() - t0
    clock = sm_clock()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    layer = {"step_s": untraced_s / untraced_steps, "traced_steps": spc}
    if tracer is not None and device.type == "cuda":
        layer["eager_trace"] = eager_conv_trace(state.model, loader, cfg, seed, device)

    # ---------------------------------------------------- correctness
    warmup_s, capture_s, nodes = multi.warmup_s or 0.0, multi.capture_s or 0.0, multi.graph_nodes
    del multi, state, loader, snaps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(cfg, seen, device)
    values = numbers(seen, ref)
    info = {
        "window": f"{calls} calls, {steps} steps in {elapsed:.4f} s "
                  f"({1e3 * elapsed / steps:.4f} ms a step), skipped updates {skipped}; "
                  f"ms a step by call {call_ms}",
        "set-up": f"{t_setup_end - mono_start:.4f} s, of which graph warm-up {warmup_s:.4f} s, "
                  f"capture {capture_s:.4f} s ({nodes} nodes a step), and {len(settle_ms)} calls to settle, "
                  f"ms a step {settle_ms}",
        "sm_clock": clock,
        "reference": f"{COMPARED_STEPS} steps in float64 in {time.perf_counter() - t_ref:.3f} s; losses "
                     f"{ref['losses']}, program's {[float(x) for x in first_rows[:COMPARED_STEPS, 0]]}; "
                     f"first step's terms {ref['terms']}",
        "worst gradient leaves (not compared)": values["worst gradient leaves"],
        "worst update leaves (not compared)": values["worst update leaves"],
        "worst statistics (not compared)": values["worst statistics"],
    }
    if tracer is not None:
        info["trace"] = (f"{len(tracer.device_ops)} device operations over {tracer.window_s:.4f} s "
                         f"(the profiler took {tracer.start_s:.4f} s to start)")
        if device.type == "cuda":
            ms = {name: sum(e - s for _, s, e in tracer.kernels(name)) / 1e6 / spc for name in LOSS_KERNELS}
            convs = layer["eager_trace"].launched_by(CONV_OPS)
            info["kernels, ms a step"] = (f"{', '.join(f'{k} {v:.4f}' for k, v in ms.items())} (traced call); "
                                          f"{len(convs)} kernels of {'/'.join(CONV_OPS)} "
                                          f"{sum(e - s for _, s, e in convs) / 1e6:.4f} (eager run)")
    checks = {k: [values[k], float(limits[k])] for k in ("loss_gap", "grad_gap", "update_gap", "stats_gap")}
    return Run(
        e2e={"train_step_ms": 1e3 * elapsed / steps, "setup_s": t_setup_end - mono_start},
        attempted=steps, failed=skipped, checks=checks, memory_peak_bytes=memory_peak,
        info=info, trace=tracer, layer=layer,
    )
