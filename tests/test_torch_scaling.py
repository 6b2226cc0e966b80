"""The port's weak-scaling sweep (bench_scaling, the counterpart of
scripts/bench_scaling.py) on the CPU: two gloo processes for the plumbing,
as the JAX script uses the virtual CPU mesh.  The ranks run one torch
thread each; their times mean nothing for the card."""

import math

import pytest
import torch

from ddsp_pytorch_tpu_torch import bench_scaling

TINY = ["--set", "model.kwargs.hidden_size=16", "--set", "model.kwargs.n_harmonic=4",
        "--set", "model.kwargs.n_bands=5", "--set", "train.scales=[512, 256]"]
ARGS = ["--per-device-batch", "1", "--signal-length", "4096", "--reps", "2", "--dist-timeout", "60", *TINY]


def test_two_gloo_processes_give_world_1_and_2(tmp_path):
    out = tmp_path / "scaling.json"
    payload = bench_scaling.main(["--device", "cpu", "--world-sizes", "1,2", "--out", str(out), *ARGS])
    assert out.exists() and payload["device"] == "cpu" and payload["card"] is None
    r1, r2 = payload["results"]
    assert (r1["devices"], r1["global_batch"]) == (1, 1) and (r2["devices"], r2["global_batch"]) == (2, 2)
    for r in (r1, r2):
        assert r["backend"] == "gloo" and r["step"] == "eager"
        for key in ("step_ms", "steps_per_s", "samples_per_s", "efficiency"):
            assert math.isfinite(r[key]) and r[key] > 0, key
    assert r1["efficiency"] == 1.0
    assert r2["efficiency"] == pytest.approx(r2["samples_per_s"] / 2 / r1["samples_per_s"])


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_scaling.main(ARGS)


@pytest.mark.cuda
def test_world_1_on_one_card():
    """World size 1 as one NCCL process, its graphed step timed; one card
    says that scaling needs more."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    payload = bench_scaling.main(["--world-sizes", "1", *ARGS])
    (r,) = payload["results"]
    assert r["backend"] == "nccl" and r["step"] == "graphed" and r["efficiency"] == 1.0
