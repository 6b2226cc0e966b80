"""The port's benchmark protocol (ddsp_pytorch_tpu_torch/performance.py) and
headline (bench.py) against the repository's performance.py and bench.py,
on the CPU, at a small config (hidden 32, 8 harmonics, 17 noise bands,
16 kHz, block 256).

Tolerances: the staged controls array-equal to the JAX protocol's; one
synthesized call (and the next, carrying the state) of the port against
the JAX StreamingSynth.step on the same transplanted weights, noise off on
both sides, within 2e-3 absolute (the whole-model bound,
tests/test_full_model_parity.py:95).
"""

import importlib.util
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddsp_pytorch_tpu.streaming as jax_streaming
from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.models import load_model as jax_load_model
from ddsp_pytorch_tpu_torch import bench, performance
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "preprocess": {"sample_rate": 16000, "signal_length": 4096, "block_size": 256},
    "model": {"name": "single-inst-decoder",
              "kwargs": {"hidden_size": 32, "n_harmonic": 8, "n_bands": 17, "sample_rate": 16000,
                         "block_size": 256, "has_reverb": False}},
}
WHOLE_MODEL_ATOL = 2e-3
KEYS = {"mean_ms", "audio_ms", "x_realtime", "samples_per_s", "batch", "sample_rate", "device_name"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_module(name: str):
    """The repository's own `name`.py (performance.py, bench.py)."""
    spec = importlib.util.spec_from_file_location(f"_root_{name}", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np_tree(tree) -> dict:
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def test_run_benchmark_keys_on_cpu():
    r = performance.run_benchmark(config=Config.from_dict(SMALL), n_run=2, device="cpu")
    assert KEYS <= set(r)
    assert r["device_name"] == "cpu" and r["batch"] == 1 and r["sample_rate"] == 16000
    assert r["audio_ms"] == 1000 * 16384 / 16000
    assert r["calls"] == 3  # warm-up + 2 timed
    assert np.isfinite(r["x_realtime"]) and r["x_realtime"] > 0 and r["mean_ms"] > 0
    r = performance.run_benchmark(config=Config.from_dict(SMALL), n_run=2, protocol_runs=2,
                                  discard_first=True, value_pull=True, batch=2, device="cpu")
    assert r["calls"] == 7 and r["batch"] == 2
    assert r["samples_per_s"] == pytest.approx(2 * 16384 / (r["mean_ms"] / 1000))


@pytest.mark.parametrize("sr,block,n", [(48000, 512, 65536), (16000, 256, 16384), (44100, 512, 65536),
                                        (22050, 300, 32700)])
def test_n_samples_whole_blocks(sr, block, n):
    assert performance.n_samples(sr, block) == n
    assert n % block == 0 and n <= 2 ** int(np.ceil(np.log2(sr)))


@pytest.mark.parametrize("batch", [1, 2])
def test_staged_controls_are_the_jax_protocols(monkeypatch, batch):
    """The JAX run_benchmark's inputs to StreamingSynth.step (recorded by a
    stand-in step) against the port's staged controls."""
    seen = []

    def record(self, f0, lo, *rest):
        seen.append((np.asarray(f0), np.asarray(lo)))
        return jnp.zeros((f0.shape[0], f0.shape[1] * self.block_size))

    monkeypatch.setattr(jax_streaming.StreamingSynth, "step", record)
    _root_module("performance").run_benchmark(config=JaxConfig.from_dict(SMALL), n_run=1, batch=batch)
    synth = performance.make_synth(config=Config.from_dict(SMALL), batch=batch, device="cpu")
    f0, lo = performance.stage_controls(synth, batch)
    assert f0.shape == lo.shape == (batch, 64, 1) and f0.dtype == torch.float32
    for jf0, jlo in seen:
        np.testing.assert_array_equal(f0.numpy(), jf0)
        np.testing.assert_array_equal(lo.numpy(), jlo)
    assert len(seen) == 2  # warm-up + one timed call


def test_one_call_matches_jax_streaming_step():
    jcfg = JaxConfig.from_dict(SMALL)
    jmodel = jax_load_model(jcfg)
    init = {"sig": jnp.zeros((1, 4096)), "pitch": jnp.full((1, 16, 1), 200.0),
            "loudness": jnp.zeros((1, 16, 1))}
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "noise": key}, init)["params"]
    tmodel = load_model(SMALL["model"]["name"], SMALL["model"]["kwargs"])
    tmodel.load_state_dict(flax_to_state_dict(_np_tree(params)))
    port = StreamingSynth(tmodel, noise_deterministic=True, device="cpu")
    ref = jax_streaming.StreamingSynth(jmodel, params, noise_deterministic=True)
    f0, lo = performance.stage_controls(port, 1)
    for call in range(2):
        got = port.step(f0, lo).numpy()
        want = np.asarray(ref.step(jnp.asarray(f0.numpy()), jnp.asarray(lo.numpy())))
        assert got.shape == want.shape == (1, 16384)
        np.testing.assert_allclose(got, want, atol=WHOLE_MODEL_ATOL, err_msg=f"call {call}")
    assert float(np.abs(got).max()) > 1e-3


def test_bench_config_is_bench_py_s(monkeypatch, capsys):
    """The repository's bench.py, its run_benchmark replaced by a recorder:
    the same config and protocol arguments as the port's bench."""
    calls = []

    def record(**kwargs):
        calls.append(kwargs)
        return {"x_realtime": 1.0, "mean_ms": 1.0}

    monkeypatch.setitem(sys.modules, "performance", types.SimpleNamespace(run_benchmark=record))
    _root_module("bench").main()
    capsys.readouterr()
    assert len(calls) == 2
    port = bench.headline_config()
    for recorded, protocol in zip(calls, (bench.DISPATCH, bench.VALUE_PULL)):
        cfg = recorded.pop("config")
        assert recorded == protocol
        assert cfg.model.name == port.model.name and cfg.model.kwargs == port.model.kwargs
        assert (cfg.preprocess.sample_rate, cfg.preprocess.block_size) == (48000, 512)
        assert (port.preprocess.sample_rate, port.preprocess.block_size) == (48000, 512)
    assert port.model.kwargs["n_harmonic"] == 100 and port.model.kwargs["hidden_size"] == 512


def test_bench_line_on_cpu(monkeypatch, capsys):
    """The port's bench prints one JSON line of the headline; here run_benchmark
    is swapped for the small config's so the CPU run stays short."""
    small = Config.from_dict(SMALL)
    real = performance.run_benchmark
    monkeypatch.setattr(bench, "run_benchmark", lambda config, **kw: real(
        config=small, **dict(kw, n_run=2, protocol_runs=1)))
    line = bench.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line
    assert line["metric"] == "x_realtime_48k_100harm" and line["device"] == "cpu" and line["card"] is None
    assert line["value"] > 0 and line["value_pull_x_realtime"] > 0
