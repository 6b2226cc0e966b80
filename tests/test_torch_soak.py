"""The port's long-horizon drift soak (ddsp_pytorch_tpu_torch/soak.py) against
scripts/stream_drift_soak.py, on the CPU, at reduced horizons (2e6 samples
of phase drift, 2e5 of pool churn with a churn every 5 calls), on the JAX
script's soak model with its weights transplanted into the port.

Bounds: the control draws equal bit for bit; the port's phase carry
within 1e-5 rad of its float64 oracle at every checkpoint (the error is a
walk of one float32 rounding a call, at most 2.4e-7 rad each: 244 calls
here) and no further from it than the JAX carry is from the JAX oracle;
the JAX carry itself also measured against the port's oracle (the exact
phase of the same controls); a pooled slot against an independent batch-1
stream within 1e-5 (tests/test_streaming.py:203's bound).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch import soak
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
import stream_drift_soak as jax_soak  # noqa: E402


PHASE_SAMPLES, POOL_SAMPLES, CHURN_EVERY = int(2e6), int(2e5), 5
ORACLE_ATOL = 1e-5
POOL_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree) -> dict:
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def transplanted():
    """The JAX script's soak model and params, and the port's model with them."""
    _, params = jax_soak._make_model_and_params(block=512, sr=48000, hidden=64, frames=16, seed=0)
    model = load_model("single-inst-decoder", soak.SOAK_KWARGS)
    model.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return model.eval()


@pytest.mark.parametrize("seed", [0, 3])
def test_controls_are_the_jax_draws(seed):
    port_rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(20):
        f0, loud = soak.controls(port_rng, 16)
        jf0, jloud = jax_soak._controls(jax_rng, 16)
        assert f0.dtype == jf0.dtype == loud.dtype == jloud.dtype == np.float32
        np.testing.assert_array_equal(f0, jf0)
        np.testing.assert_array_equal(loud, jloud)


def test_oracle_is_the_float64_sum():
    """phase_increments and the carried sum against a direct float64 loop
    over the same float32 controls (math.fsum of the wrapped increments)."""
    rng = np.random.default_rng(1)
    block, sr = 512, 48000
    f0s = [soak.controls(rng, 16)[0] for _ in range(300)]
    phi, direct = 0.0, []
    for f0 in f0s:
        inc = soak.phase_increments(f0, block, sr)
        want = [math.fmod(block * (2.0 * math.pi * float(f) / sr), 2.0 * math.pi) for f in f0]
        np.testing.assert_array_equal(inc, np.asarray(want))
        phi = (phi + float(np.sum(inc))) % soak.TWO_PI
        direct.extend(want)
    exact = math.fsum(direct) % (2.0 * math.pi)
    assert soak.circular_err(phi, exact) < 1e-11
    # the JAX script's oracle sums float32 increments: another phase
    jax_phi = math.fsum(float(x) for f0 in f0s for x in jax_soak._f32_dphi_mod(f0, block, sr))
    assert soak.circular_err(jax_phi % (2.0 * math.pi), exact) > 1e-6


def test_phase_drift_matches_jax(transplanted):
    port = soak.phase_drift_soak(PHASE_SAMPLES, model=transplanted, device="cpu")
    ref = jax_soak.phase_drift_soak(PHASE_SAMPLES)
    assert port["total_samples"] == ref["total_samples"] == 244 * 16 * 512
    assert [c["samples"] for c in port["checkpoints"]] == [c["samples"] for c in ref["checkpoints"]]
    for c in port["checkpoints"]:
        assert c["abs_err_rad"] <= ORACLE_ATOL, c
    assert port["max_abs_err_rad"] <= ref["max_abs_err_rad"]
    # the JAX carry against the exact phase of the same controls: the port's
    # carry is the closer of the two at every checkpoint
    for p, j in zip(port["checkpoints"], ref["checkpoints"]):
        jax_vs_exact = soak.circular_err(j["phase_f32"], p["phase_oracle_f64"])
        assert p["abs_err_rad"] <= jax_vs_exact + ORACLE_ATOL
        assert soak.circular_err(p["phase_f32"], j["phase_f32"]) <= jax_vs_exact + ORACLE_ATOL
    assert 0 < port["audio_peak"] < 100.0 and port["gru_carry_max_abs"] <= 1.0


def test_pool_churn_matches_jax(transplanted):
    port = soak.pool_churn_soak(POOL_SAMPLES, model=transplanted, device="cpu", churn_every=CHURN_EVERY)
    ref = jax_soak.pool_churn_soak(POOL_SAMPLES, churn_every=CHURN_EVERY)
    assert port["total_samples"] == ref["total_samples"] and port["voices"] == ref["voices"] == 4
    assert port["churn_events"] == ref["churn_events"] >= 4
    assert port["hero_vs_solo_max_abs_diff"] < POOL_ATOL, port
    assert ref["hero_vs_solo_max_abs_diff"] < POOL_ATOL, ref


def test_soak_cli_writes_its_report(tmp_path, capsys):
    out = tmp_path / "soak.json"
    report = soak.main(["--samples", "2e5", "--pool-samples", "1e5", "--device", "cpu", "--out", str(out)])
    assert out.exists() and report["card"] is None
    assert report["phase_drift"]["max_abs_err_rad"] <= ORACLE_ATOL
    assert "phase drift over" in capsys.readouterr().out
