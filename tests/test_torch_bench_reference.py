"""The head-to-head against the reference's formulation
(ddsp_pytorch_tpu_torch/bench_reference.py, the counterpart of
scripts/bench_reference_cpu.py) on the CPU at a tiny width.

The restated reference forward equals the JAX package's TorchReferenceDecoder
(utils/torch_reference.py) on the same transplanted weights and injected
noise, within 1e-5 of the peak; the report's keys are REFBENCH_r05.json's
plus `card`.  Times taken here are CPU host times and mean nothing for the
card."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.models.decoder import DDSPDecoder as JaxDecoder
from ddsp_pytorch_tpu.utils.torch_reference import TorchReferenceDecoder
from ddsp_pytorch_tpu_torch import bench_reference
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(name="tiny-16k-8harm", sample_rate=16000, block_size=64, hidden_size=16, n_harmonic=8, n_bands=9)
PEAK_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("frames, batch", [(12, 1), (7, 3)])
def test_restated_reference_equals_the_jax_packages(frames, batch):
    rng = np.random.default_rng(frames)
    kw = {k: TINY[k] for k in ("sample_rate", "block_size", "hidden_size", "n_harmonic", "n_bands")}
    f0 = rng.uniform(100, 900, (batch, frames, 1)).astype(np.float32)
    f0[0, :2] = 7000.0  # harmonics above Nyquist: the mask's 1e-4
    lo = rng.standard_normal((batch, frames, 1)).astype(np.float32)
    noise = rng.uniform(-1, 1, (batch, frames, TINY["block_size"])).astype(np.float32)
    jmodel = JaxDecoder(**kw, has_reverb=False, use_pallas="never")
    params = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        {"pitch": jnp.asarray(f0), "loudness": jnp.asarray(lo)})["params"])
    want = TorchReferenceDecoder(params, sample_rate=kw["sample_rate"], block_size=kw["block_size"],
                                 n_harmonic=kw["n_harmonic"], hidden_size=kw["hidden_size"])(
        torch.tensor(f0), torch.tensor(lo), noise=torch.tensor(noise)).numpy()
    ref = bench_reference.ReferenceDecoder(flax_to_state_dict(params), sample_rate=kw["sample_rate"],
                                           block_size=kw["block_size"], n_harmonic=kw["n_harmonic"],
                                           hidden_size=kw["hidden_size"], device="cpu")
    got = ref(torch.tensor(f0), torch.tensor(lo), noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape == (batch, frames * kw["block_size"])
    assert np.abs(got - want).max() <= PEAK_REL * np.abs(want).max()
    # without injected noise: a fresh draw each call, of the same shape
    a, b = ref(torch.tensor(f0), torch.tensor(lo)), ref(torch.tensor(f0), torch.tensor(lo))
    assert a.shape == b.shape and not torch.equal(a, b)


def test_both_sides_get_the_same_weights():
    """The reference's weights are those performance.make_synth draws for
    the port's side (init_params, a CPU generator seeded 0)."""
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.performance import make_synth

    config = Config()
    config.model.kwargs.update({k: TINY[k] for k in ("sample_rate", "block_size", "hidden_size", "n_harmonic",
                                                    "n_bands")})
    ours = make_synth(config=config, device="cpu").model.state_dict()
    for k, v in bench_reference.fresh_model(TINY).state_dict().items():
        assert torch.equal(v, ours[k]), k


def test_report_has_refbench_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_reference, "CONFIGS", [TINY])
    out = tmp_path / "ref.json"
    report = bench_reference.main(["--device", "cpu", "--n-run", "2", "--protocol-runs", "2", "--out", str(out)])
    with open(os.path.join(REPO, "REFBENCH_r05.json")) as f:
        record = json.load(f)
    assert set(report) == set(record) | {"card"} and report["card"] is None
    (row,) = report["configs"]
    assert set(row) == set(record["configs"][0])
    assert set(row["torch_reference"]) == set(record["configs"][0]["torch_reference"])
    assert set(row["ours_cpu"]) == set(record["configs"][0]["ours_cpu"])
    assert row["torch_reference"]["n_samples"] == 16384
    for side in ("torch_reference", "ours_cpu"):
        assert math.isfinite(row[side]["mean_ms"]) and row[side]["mean_ms"] > 0
    assert row["speedup_same_cpu"] == pytest.approx(row["torch_reference"]["mean_ms"] / row["ours_cpu"]["mean_ms"])
    assert (report["n_run"], report["protocol_runs"]) == (2, 2)
    with open(out) as f:
        assert json.load(f) == report


def test_configs_are_the_jax_scripts():
    assert [c["name"] for c in bench_reference.CONFIGS] == ["reference-default-48k-64harm", "headline-48k-100harm"]
    with open(os.path.join(REPO, "REFBENCH_r05.json")) as f:
        record = json.load(f)
    for cfg, rec in zip(bench_reference.CONFIGS, record["configs"]):
        assert {k: rec[k] for k in cfg} == cfg


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_reference.main(["--n-run", "1"])
