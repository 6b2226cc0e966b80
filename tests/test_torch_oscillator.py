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

import contextlib
import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops import harmonic_synth_frames as jax_synth_frames
from ddsp_pytorch_tpu.ops import phase_accumulate_frames as jax_phase
from ddsp_pytorch_tpu.ops.pallas_kernels.oscillator import harmonic_synth_pallas
from ddsp_pytorch_tpu_torch.ops import kernels
from ddsp_pytorch_tpu_torch.ops import oscillator as osc

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    before = kernels.counts()
    got = osc.oscillator_bank(*rows, 32)
    np.testing.assert_array_equal(got.numpy(), osc.oscillator_bank_plain(*rows, 32).numpy())
    assert kernels.counts() == before


def test_launch_passes_pointers_then_the_stream_and_counts(monkeypatch):
    """kernels.launch, the one caller of the C launchers, against a
    recording fake launcher (and fakes of the device scope, the stream and
    the capture query, which a CPU build lacks): tensors arrive as their
    data pointers, None as None (ctypes' null pointer), ints, floats and
    ctypes objects as they are, and the stream last; a launch lands in
    `launches` of its kernel alone, or in `captured` under capture; a
    non-zero return raises with the kernel's name and counts nothing."""
    calls, returns, capturing = [], iter([0, 0, 2]), [False]

    def launcher(name):
        def fn(*args):
            calls.append((name, args))
            return next(returns)
        return fn

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(kernels, "launcher", launcher)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    x, out = torch.zeros(4), torch.zeros(2)
    plan = (ctypes.c_int * 2)()
    before = kernels.counts()
    kernels.launch("gru_fwd", x, None, out, 3, 0.5, plan)
    assert calls == [("gru_fwd", (x.data_ptr(), None, out.data_ptr(), 3, 0.5, plan, 1234))]
    want = {name: dict(c) for name, c in before.items()}
    want["gru_fwd"]["launches"] += 1
    assert kernels.counts() == want
    capturing[0] = True
    kernels.launch("oscillator_fwd", out, 7)
    want["oscillator_fwd"]["captured"] += 1
    assert calls[-1] == ("oscillator_fwd", (out.data_ptr(), 7, 1234)) and kernels.counts() == want
    with pytest.raises(RuntimeError, match="stft_frame launch failed: cudaError 2"):
        kernels.launch("stft_frame", x, 1)
    assert kernels.counts() == want


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


def test_plain_bank_float64_matches_literal_oracle():
    """float64 rows run the plain version on the CPU (the reference that
    float32 runs are measured against): y = Σ_k A_k sin(k θ) to 1e-10, where
    float32 holds 2e-4."""
    rng = np.random.default_rng(11)
    rows, k, s = 6, 64, 512
    phi = rng.uniform(0, 2 * np.pi, rows)
    omega = 2 * np.pi / 48000 * rng.uniform(50, 2000, rows)
    amp = rng.random((rows, k)) / k
    got = osc.oscillator_bank(*(torch.tensor(x) for x in (phi, omega, amp)), s)
    assert got.dtype == torch.float64
    theta = phi[:, None] + omega[:, None] * np.arange(1, s + 1)
    want = (np.sin(theta[..., None] * np.arange(1, k + 1)) * amp[:, None, :]).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_oscillator_bank_float64_gradients_match_autograd():
    """OscillatorBank's analytic backward in float64 against autograd
    through the plain float64 forward: 1e-10 of each gradient's largest
    magnitude."""
    rng = np.random.default_rng(12)
    rows, k, s = 5, 16, 128
    vals = (rng.uniform(0, 2 * np.pi, rows), 2 * np.pi / 16000 * rng.uniform(50, 2000, rows),
            rng.random((rows, k)) / k)
    g = torch.tensor(rng.standard_normal((rows, s)))
    ins = [torch.tensor(x, requires_grad=True) for x in vals]
    ref = [torch.tensor(x, requires_grad=True) for x in vals]
    osc.OscillatorBank.apply(*ins, s).backward(g)
    osc.oscillator_bank_plain(*ref, s).backward(g)
    for a, b in zip(ins, ref):
        assert a.grad.dtype == torch.float64
        assert float((a.grad - b.grad).abs().max()) <= 1e-10 * float(b.grad.abs().max())


def test_phase_accumulate_sums_in_float64():
    """float32 frame phases are the float64 sum rounded once: the same on
    every device whatever order its cumsum adds in (a float32 cumsum's
    partial sums reach F·2π, and a GPU scan's error was twice a sequential
    sum's).  Checked bit for bit against the float64 phases, and against
    the literal phase to 1 f32 spacing of 2π over 500 frames."""
    rng = np.random.default_rng(13)
    f0 = torch.tensor(rng.uniform(50, 2000, (3, 500)).astype(np.float32))
    phase0 = torch.tensor(rng.uniform(0, 2 * np.pi, 3).astype(np.float32))
    phi, out = osc.phase_accumulate_frames(f0, 512, 48000, phase0)
    phi64, out64 = osc.phase_accumulate_frames(f0.double(), 512, 48000, phase0.double())
    assert phi.dtype == out.dtype == torch.float32
    assert torch.equal(phi, phi64.float()) and torch.equal(out, out64.float())
    exact = np.mod(phase0.double().numpy()[:, None] + np.cumsum(
        np.pad(2 * np.pi * f0.double().numpy()[:, :-1] * 512 / 48000, ((0, 0), (1, 0))), axis=1), 2 * np.pi)
    d = np.abs(phi.double().numpy() - exact)
    assert np.minimum(d, 2 * np.pi - d).max() <= np.spacing(np.float32(2 * np.pi))
