"""The port's step breakdown (bench_step_breakdown, the counterpart of
scripts/bench_step_breakdown.py) on the CPU at tiny widths: every stage of
the train step timed, the ceilings' fields and the bf16 verdict's, and the
entry point's default device.  CPU host times mean nothing for the card;
the `cuda`-marked test runs the graphed protocol there."""

import math

import pytest
import torch

from ddsp_pytorch_tpu_torch import bench_step_breakdown as sb

TINY = dict(kwargs=dict(hidden_size=16, n_harmonic=4, n_bands=5), signal_length=4096,
            scales=[512, 256])
CEILINGS = ("matmul_f32_tflops", "matmul_bf16_tflops", "fft4096_gflops", "fft4096_s_per_batch",
            "hbm_saxpy_gbps")
# an entry's fields in scripts/bench_step_breakdown.py (:334-363)
ENTRY = ("stages_ms", "n_params", "fwd_stage_sum_vs_full_fwd", "fwd_stages_plus_loss_opt_vs_full_step",
         "steps_per_s_full_step", "full_step_ms_bf16", "bf16_speedup_full_step", "gru_ms_bf16",
         "bf16_speedup_gru", "verdict_ms_in_turns")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _positive(x) -> bool:
    return math.isfinite(x) and x > 0


def test_batch_entry_times_every_stage_and_gives_the_bf16_verdict():
    entry = sb.batch_entry(2, 2, "cpu", **TINY)
    assert set(ENTRY) <= set(entry)
    assert tuple(entry["stages_ms"]) == sb.STAGES
    assert all(_positive(v) for v in entry["stages_ms"].values())
    assert all(_positive(entry[k]) for k in ENTRY if k not in ("stages_ms", "verdict_ms_in_turns"))
    turns = entry["verdict_ms_in_turns"]
    for stage, speedup in (("full_step", "bf16_speedup_full_step"), ("gru_controls", "bf16_speedup_gru")):
        f32, bf16 = turns[stage]["float32"], turns[stage]["bfloat16"]
        assert len(f32) == len(bf16) == 2 and f32[0] == entry["stages_ms"][stage]
        assert entry[speedup] == pytest.approx(sum(f32) / sum(bf16))


def test_bf16_stages_run_the_bf16_model():
    stages, n_params = sb.measure_stages(2, 1, "cpu", "bfloat16", ("gru_controls", "full_step"), **TINY)
    f32, n_f32 = sb.measure_stages(2, 1, "cpu", "float32", ("gru_controls",), **TINY)
    assert set(stages) == {"gru_controls", "full_step"} and set(f32) == {"gru_controls"}
    assert n_params == n_f32 > 0  # the same float32 parameters


def test_ceilings_fields():
    out = sb.measure_ceilings("cpu", rows=64, n_fft=256, fft_batch=4, saxpy_n=1024, iters=2)
    assert tuple(out) == CEILINGS and all(_positive(v) for v in out.values())


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sb.main(["--batches", "2"])


@pytest.mark.cuda
def test_graphed_protocol_on_cuda():
    """The CUDA-graph protocol at a tiny width on the card: every stage and
    the verdict come back finite; a matmul's graphed time is positive."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    device = torch.device("cuda", 0)
    x = torch.randn(256, 256, device=device)
    assert sb.timed_loop(lambda: x @ x, 4, device) > 0
    entry = sb.batch_entry(2, 2, device, **TINY)
    assert all(_positive(v) for v in entry["stages_ms"].values())
    assert _positive(entry["bf16_speedup_full_step"])
