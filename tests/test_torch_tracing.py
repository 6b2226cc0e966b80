"""The port's tracing (ddsp_pytorch_tpu_torch/training/profiling.py) and the
benchmark's readers of it (benchmark/metrics/), on the CPU at a tiny width.

  * a MultiStep call leaves one call record whose seven phases are present,
    non-negative, and sum to the span from mark 0 to mark 7 of each step
    (the host clock on the CPU; float rounding only);
  * outside a MultiStep the model's outputs carry no hook and no mark is
    stamped;
  * the span enters no profiler range without a profiler, yet adds to
    the call record; under torch.profiler its name is in the trace, as a
    host operation and on no device track;
  * each reader takes the median over the records that start at or after
    the traced call's end, and None without a trace, a record or (as at a
    commit without the call record) `profiling.calls`.

The `cuda`-marked tests skip without a card.  This file imports no JAX, so
on a card they run with

    DDSP_TEST_PLATFORM=cuda python -m pytest tests/test_torch_tracing.py -m cuda
"""

import importlib.util
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder, DDSPDecoder, init_params
from ddsp_pytorch_tpu_torch.training import Trainer, make_optimizer, profiling
from ddsp_pytorch_tpu_torch.training.state import TrainState
from ddsp_pytorch_tpu_torch.training.train import (
    loss_and_grads,
    make_train_multi_step,
    make_train_multi_step_indexed,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=32, n_harmonic=8, n_bands=9, sample_rate=16000, block_size=128, has_reverb=True)
FRAMES, BATCH = 16, 2
MODELS = {"single-inst-decoder": DDSPDecoder, "mfcc-autoencoder": DDSPAutoencoder}
# reader → (per-step value of a record, built from `phase` ms, launch ms and nodes)
READERS = {
    "model.step_fwd_ms": lambda ph, launch, nodes: ph["nn_fwd"],
    "model.step_bwd_ms": lambda ph, launch, nodes: ph["nn_bwd"],
    "dsp.synth_fwd_bwd_ms": lambda ph, launch, nodes: ph["synth_fwd"] + ph["synth_bwd"],
    "dsp.loss_fwd_bwd_ms": lambda ph, launch, nodes: ph["loss_fwd"] + ph["loss_bwd"],
    "trainer.optimizer_ms": lambda ph, launch, nodes: ph["optimizer"],
    "trainer.launch_ms": lambda ph, launch, nodes: launch,
    "trainer.graph_nodes": lambda ph, launch, nodes: nodes,
}


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _config(name="single-inst-decoder", frames=FRAMES, **train):
    return Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": frames * 128, "block_size": 128},
        "model": {"name": name, "kwargs": dict(TINY)},
        "train": {"scales": [512, 128], "overlap": 0.75, "batch": BATCH, "lr": 1e-3, **train},
    })


def _model(name, device, hidden=TINY["hidden_size"]):
    model = MODELS[name](**dict(TINY, hidden_size=hidden))
    return init_params(model, torch.Generator().manual_seed(0)).to(device)


def _data(name, device, n, frames=FRAMES, seed=11):
    rng = np.random.default_rng(seed)
    t = np.arange(frames * 128) / 16000
    f0 = rng.uniform(150, 400, (n, 1))
    data = {
        "pitch": np.repeat(f0, frames, 1)[..., None],
        "loudness": rng.standard_normal((n, frames, 1)),
        "sig": 0.3 * np.sin(2 * np.pi * f0 * t),
    }
    if name == "mfcc-autoencoder":
        data["mfcc"] = rng.standard_normal((n, frames, 30))
    return {k: torch.tensor(v.astype(np.float32), device=device) for k, v in data.items()}


def _state(model, tx, device):
    return TrainState(0, model, tx.init([p for _, p in model.named_parameters()]),
                      torch.Generator(device).manual_seed(5), -1.0, 1.5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_cpu_multistep_call_records_seven_phases(monkeypatch, name):
    """One call of 2 steps: one record, every phase present and ≥ 0, their
    sum the mean over the steps of mark 7 − mark 0."""
    stamps = {}
    mark = profiling.StepMarks.mark

    def spy(self, i, step=None):
        mark(self, i, step)
        s = self.step if step is None else step
        stamps[(s, i)] = self._ns[s][i]

    monkeypatch.setattr(profiling.StepMarks, "mark", spy)
    cfg = _config(name)
    model = _model(name, "cpu")
    tx = make_optimizer(cfg)
    state = _state(model, tx, "cpu")
    batches = {k: v.reshape(2, BATCH, *v.shape[1:]) for k, v in _data(name, "cpu", 2 * BATCH).items()}
    t0 = time.monotonic()
    rows = make_train_multi_step(model, tx, cfg, 2)(state, batches)
    assert rows.shape == (2, 3) and bool(torch.isfinite(rows).all())
    (rec,) = profiling.calls()
    assert rec.steps == 2 and t0 <= rec.start <= rec.end <= time.monotonic()
    assert rec.graph_nodes is None and rec.host_ms == {}
    assert set(rec.phase_ms) == set(profiling.PHASES)
    assert all(v is not None and v >= 0 for v in rec.phase_ms.values()), rec.phase_ms
    assert sorted(stamps) == [(s, i) for s in range(2) for i in range(profiling.N_MARKS)]
    span_ms = np.mean([stamps[(s, 7)] - stamps[(s, 0)] for s in range(2)]) / 1e6
    assert sum(rec.phase_ms.values()) == pytest.approx(span_ms, rel=1e-9)
    # marks 1–5 follow the step's order: forward, loss, then backward
    for s in range(2):
        assert [stamps[(s, i)] for i in range(profiling.N_MARKS)] == sorted(
            stamps[(s, i)] for i in range(profiling.N_MARKS))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_marks_are_inert_outside_a_multistep(monkeypatch, name):
    """An eager forward and loss_and_grads register no hook on the outputs
    and stamp no mark; the step leaves no call record."""
    stamped = []
    monkeypatch.setattr(profiling.StepMarks, "mark", lambda self, i, step=None: stamped.append(i))
    model = _model(name, "cpu")
    batch = {k: v[:BATCH] for k, v in _data(name, "cpu", BATCH).items()}
    out = model(batch, generator=torch.Generator().manual_seed(1))
    for t in (out["signal"], out["harmonic_ctrls"]["harmonic_distribution"],
              out["harmonic_ctrls"]["amplitudes"], out["noise_ctrls"]["magnitudes"]):
        assert t.requires_grad and not t._backward_hooks
    loss, grads = loss_and_grads(model, batch, -1.0, 1.5, [512, 128], 0.75,
                                 generator=torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(loss)) and len(grads) == len(list(model.parameters()))
    assert stamped == [] and profiling._marks is None and profiling.calls() == []


def test_phases_a_path_cannot_bound_read_none():
    """A mark a step never reaches leaves its two phases None; a phase the
    path names unbounded (the data-parallel optimizer) reads None."""
    marks = profiling.StepMarks(1, torch.device("cpu"), unbounded=("optimizer",))
    with profiling.marking(marks):
        for i in (0, 1, 2, 4, 5, 6, 7):  # mark 3 missed
            profiling.mark(i)
    ph = marks.phase_ms()
    assert ph["loss_fwd"] is None and ph["loss_bwd"] is None and ph["optimizer"] is None
    assert all(ph[p] is not None for p in ("nn_fwd", "synth_fwd", "synth_bwd", "nn_bwd"))


def test_step_marks_keep_the_ddsp_phases_and_take_others():
    """StepMarks' default phases are MultiStep's seven, in their mark
    order, eight marks a step; given other phases (the CREPE step's four)
    it takes one mark more than phases and reads them in their order."""
    assert profiling.PHASES == ("nn_fwd", "synth_fwd", "loss_fwd", "loss_bwd", "synth_bwd", "nn_bwd", "optimizer")
    assert profiling.N_MARKS == 8
    ddsp = profiling.StepMarks(2, torch.device("cpu"))
    assert ddsp.phases == profiling.PHASES and ddsp.n_marks == profiling.N_MARKS
    with profiling.marking(ddsp):
        for s in range(2):
            ddsp.step = s
            for i in range(profiling.N_MARKS):
                profiling.mark(i)
    assert list(ddsp.phase_ms()) == list(profiling.PHASES)
    crepe = profiling.StepMarks(1, torch.device("cpu"), phases=profiling.CREPE_PHASES)
    assert crepe.n_marks == 5 and profiling.CREPE_PHASES == ("synth", "forward", "backward", "optimizer")
    with profiling.marking(crepe):
        for i in range(crepe.n_marks):
            profiling.mark(i)
        with pytest.raises(IndexError):
            profiling.mark(crepe.n_marks)
    ph = crepe.phase_ms()
    assert list(ph) == list(profiling.CREPE_PHASES) and all(v is not None and v >= 0 for v in ph.values())


def test_a_time_sharded_multistep_records_no_split():
    """The time-sharded step reaches neither the model's nor the loss's
    marks: its call record holds every phase None, never a wrong split."""
    from ddsp_pytorch_tpu_torch.parallel import make_mesh

    cfg = Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 4096, "block_size": 64},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 16, "n_harmonic": 4, "n_bands": 5, "sample_rate": 16000,
            "block_size": 64, "has_reverb": True}},
        "train": {"scales": [512, 256], "overlap": 0.75, "batch": 4},
    })
    model = init_params(DDSPDecoder(16, 4, 5, 16000, 64, True), torch.Generator().manual_seed(0))
    tx = make_optimizer(cfg)
    rng = np.random.default_rng(0)
    batches = {"sig": torch.tensor(0.1 * rng.standard_normal((1, 4, 4096)), dtype=torch.float32),
               "pitch": torch.tensor(rng.uniform(100, 400, (1, 4, 64, 1)), dtype=torch.float32),
               "loudness": torch.tensor(rng.standard_normal((1, 4, 64, 1)), dtype=torch.float32)}
    rows = make_train_multi_step(model, tx, cfg, 1, mesh=make_mesh(1, 2))(_state(model, tx, "cpu"), batches)
    assert bool(torch.isfinite(rows).all())
    (rec,) = profiling.calls()
    assert rec.phase_ms == {p: None for p in profiling.PHASES}


def test_annotate_without_a_profiler_enters_no_range_and_records(monkeypatch):
    entered = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", lambda name: entered.append(name))
    with profiling.call(3) as rec:
        rec.replay = 1
        with profiling.annotate("multistep.launch"):
            time.sleep(0.002)
        with profiling.annotate("multistep.launch"):
            pass
    with profiling.annotate("outside"):
        pass
    assert entered == []
    (got,) = profiling.calls()
    assert got is rec and got.steps == 3 and set(got.host_ms) == {"multistep.launch"}
    assert got.host_ms["multistep.launch"] >= 2.0
    spans = profiling.spans()
    assert [(n, c, r) for n, c, r, _, _ in spans] == [
        ("multistep.launch", rec.index, 1), ("multistep.launch", rec.index, 1), ("outside", None, 0)]
    assert all(s <= e for _, _, _, s, e in spans)
    assert sum(e - s for n, _, _, s, e in spans if n == "multistep.launch") / 1e6 == pytest.approx(
        got.host_ms["multistep.launch"])


def test_annotate_under_the_profiler_lands_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace"), "cpu"):
        with profiling.call(1):
            with profiling.annotate("multistep.noise"):
                torch.rand(64).sum()
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"] if e.get("name") == "multistep.noise"}
    assert cats == {"cpu_op"}  # not a user annotation: no device-side copy of the range
    assert "multistep.noise" in profiling.calls()[0].host_ms


def test_the_trainer_logs_the_phase_medians(tmp_path):
    """A CPU fit with steps_per_call 2 writes step_phase_ms/<phase> (the
    host clock's on the CPU) beside the launch counts, which on the CPU
    count no launch of the fused loss's kernels (its four steps' losses take
    the plain path)."""
    from ddsp_pytorch_tpu_torch.data import Datamodule, make_synthetic_dataset
    from ddsp_pytorch_tpu_torch.training.metrics import read_metrics

    cache = str(tmp_path / "cache")
    make_synthetic_dataset(cache, n_items=4, sample_rate=16000, signal_length=FRAMES * 128,
                           block_size=128, n_harmonic=8, device="cpu")
    cfg = _config(steps=4, steps_per_call=2, val_interval_epochs=0, log_interval_epochs=0)
    cfg.preprocess.out_dir = cache
    dm = Datamodule(cfg, device="cpu")
    dm.setup()
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu", use_tensorboard=False)
    trainer.fit(dm)
    trainer.close()
    for phase in profiling.PHASES:
        ((step, ms),) = read_metrics(str(tmp_path / "run"), f"step_phase_ms/{phase}")
        assert step == 4 and ms >= 0
    assert len(profiling.calls()) == 2
    assert read_metrics(str(tmp_path / "run"), "host_launch_ms") == []  # no graph on the CPU
    for name in ("stft_frame", "stft_loss_grad", "stft_loss_sum", "stft_overlap_add"):
        for kind in ("launches", "replayed"):
            assert read_metrics(str(tmp_path / "run"), f"kernel_{kind}/{name}") == [(4, 0)]


# -------------------------------------------------------------- readers
def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _record(start, k):
    ph = {p: 1.0 + k + 0.1 * j for j, p in enumerate(profiling.PHASES)}
    return profiling.CallRecord(index=k, start=start, steps=50, end=start + 1.0,
                                host_ms={"multistep.launch": 50 * (20.0 + k)}, phase_ms=ph,
                                graph_nodes=15000.0 + k)


def _fake_run(t_stop=10.0, device="cuda"):
    return SimpleNamespace(trace=SimpleNamespace(t_stop=t_stop, device=torch.device(device)))


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_takes_the_median_after_the_traced_call(monkeypatch, name):
    read, value = _reader(name), READERS[name]
    # one record before the trace's end (the traced call), four after it;
    # a call whose phases were never read counts for the host metrics only
    records = [_record(9.0, 100), _record(10.0, 0), _record(11.0, 3), _record(12.0, 1), _record(13.0, 7)]
    unread = _record(14.0, 2)
    unread.phase_ms = None
    monkeypatch.setattr(profiling, "calls", lambda: records + [unread])
    got = read(_fake_run())
    per_step = [value(r.phase_ms, r.host_ms["multistep.launch"] / 50, r.graph_nodes)
                for r in records[1:] + ([unread] if name in ("trainer.launch_ms", "trainer.graph_nodes") else [])]
    assert got == pytest.approx(float(np.median(per_step)))
    assert read(SimpleNamespace(trace=None)) is None
    assert read(_fake_run(t_stop=20.0)) is None  # no call after the trace
    assert read(_fake_run(device="cpu")) is None  # never a CPU number under a card's metric
    monkeypatch.delattr(profiling, "calls")  # a program without the call record
    assert read(_fake_run()) is None


# ------------------------------------------------------------ on a card
def _cuda_multi(cuda, unroll=1, frames=64, hidden=64, n_steps=2):
    cfg = _config(frames=frames)
    model = _model("single-inst-decoder", cuda, hidden)
    tx = make_optimizer(cfg)
    state = _state(model, tx, cuda)
    data = _data("single-inst-decoder", cuda, 6, frames)
    idx2d = np.random.default_rng(3).integers(0, 6, (n_steps, BATCH))
    return make_train_multi_step_indexed(model, tx, cfg, n_steps, unroll), state, data, idx2d


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 2])
def test_the_phases_of_a_replay_sum_to_its_device_time_on_cuda(cuda, unroll):
    """The seven phases of each step of one replay, summed over its steps,
    within 2 % of CUDA events around `graph.replay()`.  256 frames: the
    events also time the graph's launch (~20 µs), which must stay well
    under 2 % of a replay."""
    multi, state, data, idx2d = _cuda_multi(cuda, unroll, frames=256)
    multi(state, data, idx2d).cpu()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        start.record()
        multi.graph.replay()
        end.record()
        end.synchronize()
        assert multi._marks.ready()
        phases = multi._marks.phase_ms()
        assert all(v is not None and v > 0 for v in phases.values()), phases
        outer = start.elapsed_time(end)
        assert sum(phases.values()) * unroll == pytest.approx(outer, rel=0.02)


@pytest.mark.cuda
def test_graph_nodes_are_counted_once_and_alike_on_cuda(cuda):
    a, state, data, idx2d = _cuda_multi(cuda)
    for _ in range(3):
        a(state, data, idx2d).cpu()
    b, state_b, _, _ = _cuda_multi(cuda, unroll=2, n_steps=2)
    b(state_b, data, idx2d).cpu()
    records = profiling.calls()
    assert len(records) == 4 and a.graph_nodes > 0
    assert [r.graph_nodes for r in records[:3]] == [a.graph_nodes] * 3
    assert records[3].graph_nodes == b.graph_nodes == a.graph_nodes  # nodes a step
    assert all(r.phase_ms is not None and None not in r.phase_ms.values() for r in records)
    assert all(r.host_ms["multistep.launch"] > 0 for r in records)


@pytest.mark.cuda
def test_the_launch_spans_sit_on_the_profilers_clock_on_cuda(cuda):
    """Each in-memory `multistep.launch` span within 50 µs of its range
    among the profiler's host operations (the profiler stamps the wall
    clock; the spans the monotonic one, a constant apart), and no copy of
    the range on the device's track."""
    multi, state, data, idx2d = _cuda_multi(cuda, n_steps=4)
    multi(state, data, idx2d).cpu()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # the first start initialises the profiler
        pass
    profiling.reset()
    with torch.profiler.profile(activities=acts) as prof:
        multi(state, data, idx2d).cpu()
    offset = time.time_ns() - time.monotonic_ns()
    ours = [(s + offset, e + offset) for n, _, _, s, e in profiling.spans() if n == "multistep.launch"]
    cpu = torch.autograd.DeviceType.CPU
    theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "multistep.launch" and e.device_type() == cpu)
    assert len(ours) == len(theirs) == 4
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("multistep.") and e.device_type() != cpu]
    for (s, e), (ks, ke) in zip(ours, theirs):
        assert abs(s - ks) <= 50_000 and abs(e - ke) <= 50_000, (s - ks, e - ke)
