"""The port's oscillator bank against the JAX package's.

Tolerances:
  * phases: the same f32 formula, but XLA's CPU cumsum is an associative
    scan and PyTorch's a sequential sum, so the unwrapped sum of F wrapped
    increments (up to F·2π) rounds differently: phases are compared on the
    circle at 4 f32 spacings of F·2π (6.1e-5 rad at F = 40, 9.8e-4 at 500);
  * plain bank vs the JAX XLA bank (use_pallas="never"): 1e-4, the same
    Chebyshev arithmetic with sin/cos from two libraries;
  * plain bank vs the Pallas kernel in interpret mode: 5e-4, the JAX suite's
    own Pallas-vs-XLA bound (tests/test_oscillator.py:156);
  * against the float64 literal oracle: 2e-4 (tests/test_oscillator.py:44),
    1e-3 at 64 harmonics (:165) and over 5 s (:73).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops import harmonic_synth_frames as jax_synth_frames
from ddsp_pytorch_tpu.ops import phase_accumulate_frames as jax_phase
from ddsp_pytorch_tpu.ops.pallas_kernels.oscillator import harmonic_synth_pallas
from ddsp_pytorch_tpu_torch.ops import oscillator as osc

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _oracle_f64(f0_frames, amp_frames, block, sr):
    """Literal reference math (cumsum over samples) in float64."""
    f0 = np.repeat(np.asarray(f0_frames, np.float64), block, axis=1)
    amp = np.repeat(np.asarray(amp_frames, np.float64), block, axis=1)
    omega = np.cumsum(2 * np.pi * f0 / sr, axis=1)
    k = np.arange(1, amp.shape[-1] + 1)
    return (np.sin(omega[..., None] * k) * amp).sum(-1)


def _controls(seed, b, f, k, lo=100.0, hi=400.0):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(lo, hi, (b, f)).astype(np.float32)
    amp = (rng.random((b, f, k)) / k).astype(np.float32)
    return f0, amp


def _cumsum_tol(n_frames):
    return 4 * float(np.spacing(np.float32(2 * np.pi * n_frames)))


def _circ(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("with_phase0", [False, True])
def test_phase_accumulate_matches_jax(with_phase0):
    f0, _ = _controls(0, 3, 40, 1, 50.0, 2000.0)
    phase0 = np.random.default_rng(1).uniform(0, 2 * np.pi, 3).astype(np.float32)
    p0 = phase0 if with_phase0 else None
    want_phi, want_out = jax_phase(
        jnp.asarray(f0), 512, 48000, None if p0 is None else jnp.asarray(p0)
    )
    got_phi, got_out = osc.phase_accumulate_frames(
        torch.tensor(f0), 512, 48000, None if p0 is None else torch.tensor(p0)
    )
    assert _circ(got_phi.numpy(), want_phi).max() <= _cumsum_tol(40)
    assert _circ(got_out.numpy(), want_out).max() <= _cumsum_tol(40)
    assert got_phi.min() >= 0 and got_phi.max() < 2 * math.pi


def test_long_sequence_phase_accuracy():
    """5 s at 16 kHz (tests/test_oscillator.py:56): the per-frame wrap keeps
    f32 phase accurate, in the port as in the JAX package."""
    sr, block, f = 16000, 160, 500
    f0 = np.full((1, f), 311.3, np.float32)
    amp = np.ones((1, f, 1), np.float32)
    got = osc.harmonic_synth_frames(torch.tensor(f0), torch.tensor(amp), block, sr).numpy()
    assert np.abs(got - _oracle_f64(f0, amp, block, sr)).max() < 1e-3
    want_phi, _ = jax_phase(jnp.asarray(f0), block, sr)
    got_phi, _ = osc.phase_accumulate_frames(torch.tensor(f0), block, sr)
    assert _circ(got_phi.numpy(), want_phi).max() <= _cumsum_tol(f)


@pytest.mark.parametrize("b,f,k,block,sr", [(2, 25, 8, 64, 16000), (1, 6, 64, 512, 48000)])
def test_plain_bank_matches_jax_xla(b, f, k, block, sr):
    f0, amp = _controls(2, b, f, k)
    want = jax_synth_frames(jnp.asarray(f0), jnp.asarray(amp), block, sr, use_pallas="never")
    got = osc.harmonic_synth_frames(torch.tensor(f0), torch.tensor(amp), block, sr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _oracle_f64(f0, amp, block, sr), atol=2e-4 if k < 64 else 1e-3)


def test_plain_bank_matches_pallas_interpret():
    f0, amp = _controls(3, 2, 25, 8)
    block, sr = 64, 16000
    phi, _ = jax_phase(jnp.asarray(f0), block, sr)
    want = harmonic_synth_pallas(
        jnp.asarray(f0), jnp.asarray(amp), phi, block, sr, interpret=True
    )
    got = osc.harmonic_synth_frames(torch.tensor(f0), torch.tensor(amp), block, sr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


def test_phase_carry_streaming_equivalence():
    f0, amp = _controls(4, 2, 24, 8)
    f0_t, amp_t = torch.tensor(f0), torch.tensor(amp)
    full = osc.harmonic_synth_frames(f0_t, amp_t, 64, 16000)
    a1, ph = osc.harmonic_synth_frames(f0_t[:, :12], amp_t[:, :12], 64, 16000, return_phase=True)
    a2 = osc.harmonic_synth_frames(f0_t[:, 12:], amp_t[:, 12:], 64, 16000, phase0=ph)
    np.testing.assert_allclose(torch.cat([a1, a2], -1).numpy(), full.numpy(), atol=1e-4)


def test_cpu_tensor_runs_plain_version_without_launch():
    rows = torch.rand(3), torch.rand(3), torch.rand(3, 4)
    before = osc.oscillator_bank.launches
    got = osc.oscillator_bank(*rows, 32)
    np.testing.assert_array_equal(got.numpy(), osc.oscillator_bank_plain(*rows, 32).numpy())
    assert osc.oscillator_bank.launches == before


@pytest.mark.parametrize(
    "phi,omega,amp,err",
    [
        (torch.zeros(3, 1), torch.zeros(3), torch.zeros(3, 4), ValueError),
        (torch.zeros(3), torch.zeros(2), torch.zeros(3, 4), ValueError),
        (torch.zeros(3), torch.zeros(3), torch.zeros(2, 4), ValueError),
        (torch.zeros(3, dtype=torch.float64), torch.zeros(3), torch.zeros(3, 4), TypeError),
        (torch.zeros(3), torch.zeros(3), torch.zeros(4, 3).T, ValueError),
    ],
    ids=["phi-2d", "omega-shape", "amp-rows", "float64", "non-contiguous"],
)
def test_wrapper_rejects_bad_inputs(phi, omega, amp, err):
    with pytest.raises(err):
        osc.oscillator_bank(phi, omega, amp, 16)
