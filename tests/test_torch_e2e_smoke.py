"""The user journey through the port's five CLIs (ddsp_pytorch_tpu_torch/
e2e_smoke.py, the port of scripts/e2e_smoke.sh) on the CPU at the JAX
script's own size, and the port's CI entry point (ddsp_pytorch_tpu_torch/ci.py,
the port of scripts/ci.sh): its runtime, sanitizer, selftest and
multi-process steps on the CPU, its step order, and a failing step
failing the run.

The journey's config is the JAX script's YAML text: it parses in the
port's YAML reader to what the JAX package's reader gives, flow list and
`use_pallas: never` included (the port's load_model drops the latter).
"""

import os

import pytest
import torch
import yaml

from ddsp_pytorch_tpu_torch import ci, e2e_smoke
from ddsp_pytorch_tpu_torch.config import load_yaml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_journey_on_the_cpu(capfd):
    secs = e2e_smoke.main(["--device", "cpu"])
    assert list(secs) == ["preprocess", "train", "export", "transfer", "performance"]
    out = capfd.readouterr().out
    assert "e2e smoke: all green" in out and "x realtime" in out


def test_config_text_reads_as_in_jax(tmp_path):
    text = e2e_smoke.CONFIG.format(tmp=str(tmp_path), sr=e2e_smoke.SAMPLE_RATE)
    got = load_yaml(text)
    assert got == yaml.safe_load(text)
    assert got["train"]["scales"] == [512, 256] and got["model"]["kwargs"]["use_pallas"] == "never"


def test_journey_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        e2e_smoke.main([])


def test_ci_steps_on_the_cpu(capfd):
    """The runtime, sanitizer, selftest and multi-process steps on the CPU
    (the pytest step would run this suite again; the journey is tested
    above)."""
    ci.step_runtime("cpu")
    ci.step_sanitizers()
    ci.step_selftest("cpu")
    ci.step_multiprocess("cpu")
    out = capfd.readouterr().out
    assert "runtime selftest: PASS" in out and "pd_mock_test ok (bundle" in out
    assert out.count("stream_test: PASS") == 3  # release, thread and address sanitizer builds


@pytest.mark.parametrize("fast", [False, True])
def test_ci_runs_every_step_in_order(fast, monkeypatch):
    ran = []
    for name in ci.STEPS:
        monkeypatch.setattr(ci, f"step_{name}", lambda *a, name=name: ran.append(name))
    secs = ci.main(["--device", "cpu", *(["--fast"] if fast else [])])
    want = ["pytest", "runtime", "selftest", "multiprocess"] if fast else list(ci.STEPS)
    assert ran == list(secs) == want
    assert ci.STEPS == ("pytest", "runtime", "sanitizers", "selftest", "multiprocess", "e2e")
    for name in ci.CARD_TEST_FILES:
        assert os.path.exists(os.path.join(ci.REPO, "tests", name))


def test_a_failing_ci_step_fails_the_run(monkeypatch):
    ran = []
    for name in ci.STEPS:
        monkeypatch.setattr(ci, f"step_{name}", lambda *a, name=name: ran.append(name))

    def broken(device):
        raise RuntimeError("planted failure")

    monkeypatch.setattr(ci, "step_selftest", broken)
    with pytest.raises(RuntimeError, match="planted failure"):
        ci.main(["--device", "cpu"])
    assert ran == ["pytest", "runtime", "sanitizers"]  # nothing after the failed step
