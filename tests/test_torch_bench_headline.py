"""The port's headline benchmarks (ddsp_torch bench_headline, the
counterpart of scripts/bench_headline.py) on the CPU at tiny widths: each
config prints one JSON line with the JAX script's keys (and where it ran,
the card and the reps), config 1 runs on the CPU in a process of its own
when other configs run, and the entry point defaults to the card.  Times
taken here are CPU host times and mean nothing for the card; the
`cuda`-marked test runs the card's graphed step."""

import json
import math

import pytest
import torch

from ddsp_pytorch_tpu_torch import bench_headline

TINY = dict(hidden_size=16, n_harmonic=4, n_bands=5)
# the keys of each config's line in scripts/bench_headline.py (:80-85,
# :118-123, :179-187, :194-202, :249-259)
JAX_KEYS = {
    1: {"config", "desc", "ms", "x_realtime"},
    2: {"config", "desc", "ms_per_call", "x_realtime"},
    3: {"config", "desc", "ms_per_step", "steps_per_s", "gsamples_per_s"},
    4: {"config", "desc", "ms_per_step", "steps_per_s", "gsamples_per_s"},
    5: {"config", "desc", "ms", "gsamples_per_s", "x_realtime_aggregate",
        "min_of_256voice_10min_on_this_chip_s"},
}
TRAIN = dict(signal_length=4096, scales=[512, 256])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    """Config 1's child process at one torch thread too (the CLI's own
    default, every core, is for users): a full-width child on every core
    starves the other workers' time-paced tests."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _run(n: int, dtype: str = "float32") -> dict:
    kwargs = dict(TINY, dtype=dtype)
    if n == 1:
        return bench_headline.config_1(1, kwargs, signal_length=4096)
    if n == 2:
        return bench_headline.config_2("cpu", 1, kwargs)
    if n == 3:
        return bench_headline.config_3("cpu", 1, kwargs=kwargs, **TRAIN)
    if n == 4:
        return bench_headline.config_4("cpu", 1, kwargs=kwargs, **TRAIN)
    return bench_headline.config_5("cpu", 1, kwargs, voices=2, seconds=1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_config_line_has_the_jax_keys(n):
    line = _run(n)
    json.dumps(line)  # one JSON line
    assert JAX_KEYS[n] <= set(line), sorted(JAX_KEYS[n] - set(line))
    assert line["config"] == n and line["device"] == "cpu"
    assert line["eager_reps" if n in (3, 4) else "reps"] == 1
    for key in JAX_KEYS[n] - {"config", "desc"}:
        assert math.isfinite(line[key]) and line[key] > 0, key
    if n in (3, 4):  # no CUDA graph on the CPU: the eager step is the line's step
        assert line["step"] == "eager" and line["ms_per_step"] == line["eager_ms_per_step"]
        assert line["dtype"] == "float32"


def test_bf16_training_line():
    line = _run(3, "bfloat16")
    assert line["dtype"] == "bfloat16" and math.isfinite(line["ms_per_step"])


def test_main_runs_config_1_in_its_own_process(capsys):
    """--configs 1,2: config 1's line comes from a child process on the CPU
    (at full width, one call a mean), config 2's from this one."""
    lines = bench_headline.main(["--configs", "1,2", "--device", "cpu", "--reps-scale", "0.01"])
    printed = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["config"] for x in printed] == [x["config"] for x in lines] == [1, 2]
    assert printed[0]["device"] == "cpu" and printed[0]["reps"] == 1 and printed[0]["card"] is None
    assert JAX_KEYS[1] <= set(printed[0]) and JAX_KEYS[2] <= set(printed[1])


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_headline.main(["--configs", "2"])


@pytest.mark.cuda
def test_graphed_training_line_on_cuda():
    """Config 3 at a tiny width on the card: the graphed step (a MultiStep
    call of STEPS_PER_CALL steps) beside the eager one, in both dtypes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    for dtype in ("float32", "bfloat16"):
        line = bench_headline.config_3("cuda", 10, 1, dict(TINY, dtype=dtype), **TRAIN)
        assert line["step"] == "graphed" and line["graphed_reps"] == 10
        assert 0 < line["ms_per_step"] == line["graphed_ms_per_step"]
        assert line["device"] == torch.cuda.get_device_name(0)
