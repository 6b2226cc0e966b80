"""Training cells: the program's graphed trainer path, measured over whole calls.

Set-up builds one training step object — the model with the seed's
weights, Adam's state, the program's `MultiStep` of `steps_per_call`
graphed steps over a `DeviceDataLoader` of the seed's corpus — and drives
it through its first call (which captures the graph), then through whole
calls until the step has settled (`settle_s`, the cell's).  That same
object then runs the window: whole calls, each followed by the pull of its
metrics as the program's Trainer does, until `seconds` have passed.
`train_step_ms` is the window's time over the steps it completed.

`correct`: the plain reference (benchmark/reference/ddsp.py, float64)
follows the first three steps of set-up's call from the same weights,
batches and noise (the noise drawn again from a copy of the generator the
state carries: the program draws each step's noise from it, in step
order).  Compared: the first step's loss, and the parameters' change
after step 3, each leaf's norm against the reference's; the first
gradient, worked out from Adam's first moment after step 1, is printed
(benchmark/lib/judge.py).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.lib import judge
from benchmark.lib.card import sm_clock
from benchmark.lib.corpus import loudness_stats, make_corpus
from benchmark.lib.trace import Trace
from benchmark.lib.weights import make_weights, program_config, sub_seed
from benchmark.harness import Run

ADAM_B1 = 0.9
COMPARED_STEPS = 3
SETTLED = 0.01  # two calls' ms a step this close: the step has settled


def _observed_state(state_cls, on_step):
    """A TrainState whose `step` setter calls on_step(state, value): the
    program advances `step` after each replay, on the host, in stream
    order, so a snapshot taken there is the state after that step."""

    class Observed(state_cls):
        @property
        def step(self):
            return self.__dict__["_step"]

        @step.setter
        def step(self, value):
            self.__dict__["_step"] = value
            on_step(self, value)

    return Observed


def _index_stream(loader, n: int):
    """The loader's batches of item indices over epochs, n at a time."""
    epoch, buf = 0, []
    while True:
        loader.set_epoch(epoch)
        for idx in loader.index_batches():
            buf.append(idx)
            if len(buf) == n:
                yield np.stack(buf)
                buf = []
        epoch += 1


def _controls_fwd_bwd_s(model, batch, mean, std, seed, device, iters=4, replays=5) -> float:
    """Device seconds of one forward and backward of the frame-rate NN
    (`frame_controls`) against a fixed cotangent: CUDA events around
    replays of a graph of `iters` iterations; the median replay."""
    from ddsp_pytorch_tpu_torch.models.decoder import matmul_precision

    f0, loud = batch["pitch"], (batch["loudness"] - mean) / std
    args = (f0, loud, batch["mfcc"]) if "mfcc" in batch else (f0, loud)
    params = [p for p in model.parameters() if p.requires_grad]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 9))
    with torch.no_grad(), matmul_precision():
        h, n = model.frame_controls(*args)
    cot = [torch.randn(t.shape, generator=gen, device=device)
           for t in (h["harmonic_distribution"], h["amplitudes"], n["magnitudes"])]

    def body():
        with matmul_precision():
            hc, nc = model.frame_controls(*args)
            outs = [hc["harmonic_distribution"], hc["amplitudes"], nc["magnitudes"]]
            torch.autograd.grad(outs, params, cot, allow_unused=True)

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            body()
    graph.replay()
    times = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    del graph
    return float(np.median(times))


def _settle(multi, state, loader, stream, spc, settle_s) -> list:
    """Whole calls for at least `settle_s` seconds, then until two calls in
    a row read within SETTLED of each other; their ms a step, in order.

    A new process on the card's host starts in a slow mode: the host's
    graph launches run ~13 % slower for up to ~40 s, then fast for good
    (PERF.md).  A long training job pays that once; set-up pays it here,
    so the window holds the steady step."""
    out = []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        multi(state, loader.device_data, next(stream)).cpu()
        out.append(round(1e3 * (time.perf_counter() - t) / spc, 3))
        if (time.perf_counter() - t0 >= settle_s and len(out) >= 2
                and abs(out[-1] - out[-2]) <= SETTLED * out[-2]):
            return out


def run(cfg, params, limits, seed, seconds, trace, device, mono_start) -> Run:
    from ddsp_pytorch_tpu_torch.data.dataset import DeviceDataLoader
    from ddsp_pytorch_tpu_torch.models import load_model
    from ddsp_pytorch_tpu_torch.training.optim import make_optimizer
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import make_train_multi_step_indexed

    spc = int(cfg["assumed"]["steps_per_call"])
    unroll = int(cfg["assumed"]["scan_unroll"])
    tc, m = cfg["train"], cfg["model"]
    pconf = program_config(cfg, spc)
    weights = make_weights(cfg, seed, device)
    corpus = make_corpus(cfg, int(params["corpus_items"]), seed, device)
    mean, std = loudness_stats(corpus)
    model = load_model(m["name"], {k: v for k, v in m.items() if k != "name"}).to(device)
    model.load_state_dict(weights, strict=True)
    loader = DeviceDataLoader(corpus, tc["batch"], shuffle=True, drop_last=True,
                              seed=sub_seed(seed, 3) % 2**32, device=device)
    tx = make_optimizer(pconf)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    gen_state0 = gen.get_state()
    names = [n for n, _ in model.named_parameters()]
    snaps = {}

    def on_step(state, value):
        if "opt_state" not in state.__dict__:
            return
        if value == 1:
            snaps["g1"] = [mu.detach() / (1 - ADAM_B1) for mu in state.opt_state["mu"]]
        if value == COMPARED_STEPS:
            snaps["p3"] = [p.detach().clone() for p in state.params()]

    state_cls = _observed_state(TrainState, on_step)
    state = state_cls(step=0, model=model, opt_state=tx.init([p for p in model.parameters()]),
                      generator=gen, mean_loudness=mean, std_loudness=std)
    multi = make_train_multi_step_indexed(model, tx, pconf, spc, unroll)
    stream = _index_stream(loader, spc)
    first_idx = next(stream)
    first_rows = multi(state, loader.device_data, first_idx).cpu().numpy()
    settle_ms = _settle(multi, state, loader, stream, spc, float(params["settle_s"]))

    # ---------------------------------------------------------- window
    tracer = Trace(device) if trace else None
    if tracer is not None:  # the profiler's first start initialises it: not in the window
        tracer.start()
        tracer.stop()
    trace_call = 1
    t_setup_end = time.monotonic()
    steps, calls, skipped = 0, 0, 0
    untraced_s = untraced_steps = 0
    call_ms = []  # ms a step of each untraced call, in order
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
    layer = {"step_s": untraced_s / untraced_steps,
             "rows": tc["batch"] * (cfg["preprocess"]["signal_length"] // m["block_size"])}
    if tracer is not None and device.type == "cuda":
        batch = {k: v.index_select(0, torch.as_tensor(first_idx[0], device=device))
                 for k, v in loader.device_data.items()}
        layer["controls_fwd_bwd_s"] = _controls_fwd_bwd_s(model, batch, mean, std, seed, device)

    # ---------------------------------------------------- correctness
    g1 = dict(zip(names, snaps["g1"]))
    p3 = dict(zip(names, snaps["p3"]))
    losses = [float(x) for x in first_rows[:COMPARED_STEPS, 0]]
    warmup_s, capture_s = multi.warmup_s or 0.0, multi.capture_s or 0.0
    del multi, state, model, loader, snaps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_gen = torch.Generator(device=device)
    ref_gen.set_state(gen_state0)
    b, f, s = tc["batch"], cfg["preprocess"]["signal_length"] // m["block_size"], m["block_size"]
    noises = [torch.rand((b, f, s), generator=ref_gen, device=device) * 2.0 - 1.0
              for _ in range(COMPARED_STEPS)]
    data = {"sig": corpus.signals, "pitch": corpus.pitchs[..., None],
            "loudness": corpus.loudness[..., None]}
    if corpus.mfccs is not None:
        data["mfcc"] = corpus.mfccs[:, :-1]
    batches = [{k: torch.as_tensor(v[first_idx[j]], device=device) for k, v in data.items()}
               for j in range(COMPARED_STEPS)]
    t_ref = time.perf_counter()
    checks, detail = judge.train_checks(cfg, weights, batches, noises, mean, std, losses, g1, p3,
                                        limits, torch.float64)
    ref_s = time.perf_counter() - t_ref

    info = {
        "window": f"{calls} calls, {steps} steps in {elapsed:.4f} s "
                  f"({1e3 * elapsed / steps:.4f} ms a step), skipped updates {skipped}; "
                  f"ms a step by call {call_ms}",
        "set-up": f"{t_setup_end - mono_start:.4f} s, of which graph warm-up {warmup_s:.4f} s, "
                  f"capture {capture_s:.4f} s, and {len(settle_ms)} calls to settle, "
                  f"ms a step {settle_ms}",
        "sm_clock": clock,
        "reference": f"{COMPARED_STEPS} steps in {ref_s:.3f} s",
        **detail,
    }
    if tracer is not None:
        info["trace"] = (f"{len(tracer.device_ops)} device operations over {tracer.window_s:.4f} s "
                         f"(the profiler took {tracer.start_s:.4f} s to start)")
    return Run(
        e2e={"train_step_ms": 1e3 * elapsed / steps, "setup_s": t_setup_end - mono_start},
        attempted=steps, failed=skipped, checks=checks, memory_peak_bytes=memory_peak,
        info=info, trace=tracer, layer=layer,
    )
