"""The CREPE training kind at micro capacity on the CPU (the card's check
skipped): a sound run ends correct from the benchmark's own weights, and
each of the four compared numbers catches a fault planted in the program
under it; the harness finds the new cell's files by name and reports it
train_step_ms, setup_s, its five new per-layer metrics and the two shared
ones that read its step."""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark import harness
from benchmark.harness import HERE

CPU = torch.device("cpu")
CELL = "crepe.train_b256"
# float32 at micro capacity, batch 8, on the CPU: frames ≤ 2.3e-4, loss ≤
# 7.3e-6, update ≤ 0.09, stats ≤ 3.1e-5 over seeds
LIMITS = {"frames_gap": 2e-3, "loss_gap": 1e-4, "update_gap": 0.5, "stats_gap": 1e-3}
NEW_METRICS = {"crepe.synth_ms", "crepe.fwd_ms", "crepe.bwd_ms", "crepe.conv_roofline.train", "mfu.crepe_train"}
METRICS = NEW_METRICS | {"trainer.optimizer_ms", "device_idle_pct.train"}


def _micro(root):
    """A benchmark folder holding the cell at micro capacity, batch 8."""
    os.makedirs(os.path.join(root, "configs"))
    os.makedirs(os.path.join(root, "workloads"))
    shutil.copytree(os.path.join(HERE, "metrics"), os.path.join(root, "metrics"))
    cfg = harness.load_json(os.path.join(HERE, "configs", "crepe-full.json"))
    cfg["model"].update(capacity="micro", filters=[f // 32 for f in cfg["model"]["filters"]])
    cfg["train"]["batch"] = 8
    with open(os.path.join(root, "configs", "crepe-full.json"), "w") as f:
        json.dump(cfg, f)
    cell = harness.load_json(os.path.join(HERE, "workloads", CELL + ".json"))
    cell.update(params=dict(cell["params"], settle_s=0.0, pull_every=4), limits=LIMITS)
    with open(os.path.join(root, "workloads", CELL + ".json"), "w") as f:
        json.dump(cell, f)
    return root


def _run(tmp_path, trace=False, seed=2**33 + 21):
    d = _micro(str(tmp_path / "b"))
    return harness.run_cell(harness.benchmark_spec(), CELL, seed, 0.3, trace, CPU, time.monotonic(), bench_dir=d)


def test_the_cells_files_are_found_by_name():
    spec = harness.benchmark_spec()
    entry, cfg, cell = harness.load_cell(spec, CELL)
    assert entry["chips"] == 1 and cell["kind"] == "crepe_train" and cfg["model"]["capacity"] == "full"
    assert harness.load_kind(cell["kind"]).run
    assert set(cell["limits"]) == {"frames_gap", "loss_gap", "update_gap", "stats_gap"}
    for m in NEW_METRICS:
        assert os.path.exists(os.path.join(HERE, "metrics", m + ".py"))


def test_metrics_for_gives_the_cell_its_own_metrics():
    spec = harness.benchmark_spec()
    assert [m["name"] for m in harness.metrics_for(spec, CELL, "end_to_end")] == ["train_step_ms", "setup_s"]
    assert {m["name"] for m in harness.metrics_for(spec, CELL, "per_layer")} == METRICS
    for other in ("decoder.train_b16", "autoencoder.train_b16"):
        assert not NEW_METRICS & {m["name"] for m in harness.metrics_for(spec, other, "per_layer")}


def test_a_sound_run_is_correct_and_reports_its_line(tmp_path):
    run = _run(tmp_path, trace=True)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0 and run.info["counters"]["crepe/steps"] >= run.attempted
    line = harness.result_line(harness.benchmark_spec(), CELL, run, True, "cpu", bench_dir=str(tmp_path / "b"))
    # off a card the readers of the step marks and the kernels find nothing; the
    # host-clock share reads, and the shared idle reader finds no device operation
    assert set(line["metrics"]) == {"mfu.crepe_train", "device_idle_pct.train"} and list(line)[-1] == "checks"
    assert line["metrics"]["device_idle_pct.train"]["value"] == 100.0
    plain = harness.result_line(harness.benchmark_spec(), CELL, run, False, "cpu", bench_dir=str(tmp_path / "b"))
    assert set(plain["metrics"]) == {"train_step_ms", "setup_s"}


def _frames_off(monkeypatch):
    from benchmark.tools.crepe_control import synth_fault
    from ddsp_pytorch_tpu_torch import train_crepe

    with synth_fault():  # the control's planted synthesis, taken out of its scope
        synth = train_crepe.synth_batch
    monkeypatch.setattr(train_crepe, "synth_batch", synth)


def _pos_weight_off(monkeypatch):
    from ddsp_pytorch_tpu_torch import train_crepe

    real = train_crepe.weighted_bce
    monkeypatch.setattr(train_crepe, "weighted_bce", lambda z, y, pw: real(z, y, 1.01 * pw))


def _state_unchanged(monkeypatch):
    from benchmark.tools.crepe_control import state_unchanged
    from ddsp_pytorch_tpu_torch import train_crepe

    with state_unchanged():  # the control's patched step, taken out of its scope
        step = train_crepe.train_step
    monkeypatch.setattr(train_crepe, "train_step", step)


def _unbiased_running_var(monkeypatch):
    from ddsp_pytorch_tpu_torch.models import crepe

    real = crepe.BatchNorm.forward

    def forward(self, x, train=False):
        before = self.running_var.clone()
        y = real(self, x, train)
        if train:
            n = x.shape[0] * x.shape[2]
            batch = (self.running_var - self.momentum * before) / (1 - self.momentum)
            self.running_var.copy_(self.momentum * before + (1 - self.momentum) * batch * n / (n - 1))
        return y

    monkeypatch.setattr(crepe.BatchNorm, "forward", forward)


@pytest.mark.parametrize("plant,check", [(_frames_off, "frames_gap"), (_pos_weight_off, "loss_gap"),
                                         (_state_unchanged, "update_gap"),
                                         (_unbiased_running_var, "stats_gap")],
                         ids=["frames", "loss", "update", "stats"])
def test_each_check_catches_its_fault(tmp_path, monkeypatch, plant, check):
    plant(monkeypatch)
    run = _run(tmp_path)
    value, limit = run.checks[check]
    assert not run.correct and value > limit, run.checks


def test_the_runs_start_from_the_benchmarks_weights(tmp_path):
    from benchmark.kinds import crepe_train
    from benchmark.lib import crepe_weights
    from ddsp_pytorch_tpu_torch.models.crepe import CREPE

    cfg = harness.load_json(os.path.join(_micro(str(tmp_path / "b")), "configs", "crepe-full.json"))
    full = harness.load_json(os.path.join(HERE, "configs", "crepe-full.json"))
    for model in (cfg["model"], full["model"]):
        with torch.device("meta"):
            want = [(k, tuple(v.shape)) for k, v in CREPE(model["capacity"]).state_dict().items()]
        assert [(name, shape) for name, shape, _ in crepe_weights.param_spec(model)] == want
    trainer, _, weights = crepe_train.make_trainer(cfg, 5, CPU)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    # no leaf at the program's initial value: every scale, offset and statistic takes part
    for n in range(1, 7):
        assert (weights[f"bn{n}.weight"] != 1).all() and (weights[f"bn{n}.running_var"] != 1).all()
        assert (weights[f"bn{n}.bias"] != 0).all() and (weights[f"bn{n}.running_mean"] != 0).all()
        assert (weights[f"conv{n}.bias"] != 0).all()
    again = crepe_weights.make_weights(cfg, 5, CPU)
    other = crepe_weights.make_weights(cfg, 6, CPU)
    assert all(torch.equal(again[k], v) and not torch.equal(other[k], v) for k, v in weights.items())


def test_a_controls_verdict_is_a_runs():
    from benchmark.tools.crepe_control import verdict

    limits = {"frames_gap": 2e-3, "loss_gap": 4e-6}
    assert verdict({"frames_gap": 1e-3, "loss_gap": 1e-6, "stats_gap_end": 5.0}, limits)["correct"]
    bad = verdict({"frames_gap": 1e-2, "loss_gap": 1e-6}, limits)
    assert not bad["correct"] and bad["fails"] == ["frames_gap"]


class _Event:
    """The part of a profiler event that lib/op_trace.py reads."""

    def __init__(self, name, cuda, start, dur, corr, linked, thread=1):
        self._v = (name, cuda, start, dur, corr, linked, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def test_kernels_are_matched_to_the_operators_that_launched_them():
    from benchmark.lib.op_trace import launched_by

    events = [
        _Event("aten::cudnn_convolution", False, 0, 100, 1, 0),
        _Event("aten::empty", False, 10, 10, 2, 0),  # inside the convolution
        _Event("aten::add_", False, 200, 10, 3, 0),
        _Event("aten::convolution_backward", False, 300, 100, 4, 0, thread=2),
        _Event("aten::sum", False, 350, 10, 5, 0, thread=2),  # the bias's gradient
        _Event("aten::sum", False, 350, 10, 6, 0, thread=1),  # another thread, same time
        _Event("cudaLaunchKernel", False, 12, 1, 77, 2),  # a runtime call: linked, not an operator
        _Event("k_fwd", True, 1000, 50, 77, 2),
        _Event("k_direct", True, 1100, 40, 78, 1),
        _Event("k_bias_add", True, 1200, 5, 79, 3),
        _Event("k_bias_grad", True, 1300, 7, 80, 5),
        _Event("k_other_thread", True, 1400, 9, 81, 6),
        _Event("k_unlinked", True, 1500, 9, 82, 99),
        _Event("Memset (Device)", True, 1600, 3, 83, 1),
    ]
    got = launched_by(events, ("aten::cudnn_convolution", "aten::convolution_backward"))
    assert [k[0] for k in got] == ["k_fwd", "k_direct", "k_bias_grad"]
    assert got[0][1:] == (1000, 1050)
    assert launched_by(events, ("aten::mm",)) == []
