"""The port's ceiling sweep (ddsp_pytorch_tpu_torch/ceiling_probe.py, the port
of scripts/ceiling_probe.py) on the CPU at a small width (hidden 64, 16 kHz,
block 256, 8 harmonics, 17 bands, batch 2, a YIN-tracked fixture corpus of
2 + 1 notes made first, which the sweep reuses): two configs (2:1 and
1:1), 2 probe steps each.

Checked: every row has CEILING_r05.json's row keys plus the port's (the
repeat, both rates, the graph's warm-up and capture, the peak device
memory, the launches, the SM clock and the mode); every warm and measured
child is a fresh process (distinct pids, none of them this one); the
run's checkpoints advance by each child's steps; the report has that
file's keys plus the card's; parse_configs reads the JAX syntax.
"""

import json
import math
import os

import pytest
import torch

from ddsp_pytorch_tpu_torch import ceiling_probe, trainrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ["preprocess.sample_rate=16000", "preprocess.signal_length=8192", "preprocess.block_size=256",
        "preprocess.pitch_tracker=yin", "model.kwargs.sample_rate=16000", "model.kwargs.block_size=256",
        "model.kwargs.hidden_size=64", "model.kwargs.n_harmonic=8", "model.kwargs.n_bands=17",
        "train.scales=[512, 256]", "train.batch=2"]
NEW_ROW_KEYS = {"repeat", "warm_pid", "measured_pid", "steps_per_s_train_window", "train_window_ms_per_step",
                "steady_ms_per_step", "graph_warmup_s", "graph_capture_s", "max_memory_allocated_bytes",
                "kernel_launches", "kernel_replayed", "mode"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The sweep under a root whose corpus (2 + 1 notes, not the sweep's
    24 + 4) and cache trainrun.prep made first: the sweep reuses them."""
    root = tmp_path_factory.mktemp("ceiling")
    out = str(root / "ceiling.json")
    small = str(root / "small.yaml")
    trainrun.workload_config(str(root), steps=4, steps_per_call=1, overrides=SETS).to_yaml(small)
    trainrun.prep(small, 2, 1, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        report = ceiling_probe.main(["--device", "cpu", "--configs", "2:1,1:1", "--probe-steps", "2",
                                     "--root", str(root), "--out", out, *[a for kv in SETS for a in ("--set", kv)]])
    finally:
        mp.undo()
    return str(root), out, report


def test_rows_have_the_tpu_keys_and_both_rates(sweep):
    _, out, report = sweep
    with open(os.path.join(REPO, "CEILING_r05.json")) as f:
        tpu = json.load(f)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(tpu) | {"card", "platform", "repeats", "prime_wall_s", "mode_split_ms"} == set(report)
    assert [(r["steps_per_call"], r["unroll"]) for r in report["rows"]] == [(2, 1), (1, 1)]
    for row in report["rows"]:
        sm = {k for k in row if k.startswith("sm_clock")}
        assert set(row) - sm == set(tpu["rows"][0]) | NEW_ROW_KEYS
        assert row["status"] == "ok" and row["warm_steps"] == 8 and row["measured_steps"] == 2
        assert row["steps_per_s_wall"] > 0 and row["steps_per_s_train_window"] > 0
        assert math.isclose(row["s_per_step"], row["measured_wall_s"] / 2)
        assert row["graph_capture_s"] is None and row["max_memory_allocated_bytes"] is None  # the CPU
        assert row["mode"] is None
    assert report["prime_wall_s"] > 0


def test_each_child_is_a_fresh_process(sweep):
    root, _, report = sweep
    pids = [row[k] for row in report["rows"] for k in ("warm_pid", "measured_pid")]
    assert len(set(pids)) == 4 and os.getpid() not in pids
    ckpts = sorted(int(f[:-3]) for f in os.listdir(os.path.join(root, "runs", "ceiling", "checkpoints")))
    assert ckpts[-1] == 8 + 2 + 8 + 2  # each child resumed the one before it


def test_parse_configs_reads_the_jax_syntax():
    assert ceiling_probe.parse_configs("50:1,1:1,50:5,200:1,200:8") == [(50, 1), (1, 1), (50, 5), (200, 1), (200, 8)]
    assert ceiling_probe.parse_configs("4") == [(4, 1)]
