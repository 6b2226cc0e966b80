"""The port's oscillator backward against the JAX package's.

Tolerances:
  * row gradients (dphi, domega, damp) against jax.vjp of the Pallas pair
    `_osc_rows` in interpret mode, and against autograd through the plain
    forward: 1e-4 of each output's largest magnitude.  The same f32
    arithmetic summed over S = 64–512 samples in other orders; domega's
    terms carry the factor (i+1), so its sums reach 10³–10⁵ and only an
    error relative to that magnitude is meaningful;
  * df0 and dA of harmonic_synth_frames against jax.grad of the JAX bank
    (Pallas in interpret mode and XLA): rtol/atol 5e-3, the JAX suite's own
    kernel-vs-XLA gradient bound (tests/test_oscillator.py:181-182).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops import harmonic_synth_frames as jax_synth_frames
from ddsp_pytorch_tpu.ops import phase_accumulate_frames as jax_phase
from ddsp_pytorch_tpu.ops.pallas_kernels.oscillator import _TILE_R, _osc_rows, harmonic_synth_pallas
from ddsp_pytorch_tpu_torch.ops import kernels
from ddsp_pytorch_tpu_torch.ops import oscillator as osc

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on shared cores, where torch's default of one thread per core
    oversubscribes them (results here do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed, rows, k, s, sr=48000.0):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, rows).astype(np.float32)
    omega = (2 * np.pi / sr * rng.uniform(50, 2000, rows)).astype(np.float32)
    amp = (rng.random((rows, k)) / k).astype(np.float32)
    g = rng.standard_normal((rows, s)).astype(np.float32)
    return phi, omega, amp, g


def _close_rel(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= REL * scale, f"{name}: max |Δ| {err:.3e} > {REL} × {scale:.3e}"


def _jax_vjp(phi, omega, amp, g, s):
    """jax.vjp of the Pallas pair in interpret mode, rows padded to a
    _TILE_R multiple as harmonic_synth_pallas pads them (:207-210)."""
    rows = phi.shape[0]
    pad = (-rows) % _TILE_R
    p = lambda x: jnp.pad(jnp.asarray(x).reshape(rows, -1), ((0, pad), (0, 0)))
    _, vjp = jax.vjp(lambda a, b, c: _osc_rows(a, b, c, s, True), p(phi), p(omega), p(amp))
    dphi, domega, damp = vjp(p(g))
    return np.asarray(dphi)[:rows, 0], np.asarray(domega)[:rows, 0], np.asarray(damp)[:rows]


@pytest.mark.parametrize("rows,k,s", [(5, 8, 64), (37, 16, 128), (3, 64, 512)])
def test_plain_backward_matches_pallas_vjp(rows, k, s):
    phi, omega, amp, g = _rows(rows, rows, k, s)
    want = _jax_vjp(phi, omega, amp, g, s)
    got = osc.oscillator_bank_bwd_plain(*(torch.tensor(x) for x in (phi, omega, amp, g)), s)
    for a, b, name in zip(got, want, ("dphi", "domega", "damp")):
        _close_rel(a.numpy(), b, name)


@pytest.mark.parametrize("rows,k,s", [(5, 8, 64), (2, 64, 512)])
def test_autograd_function_matches_pallas_and_plain_autograd(rows, k, s):
    """OscillatorBank on CPU tensors: the plain forward and backward, the
    same gradients as jax.vjp of the Pallas pair and as autograd through
    the plain forward's own graph."""
    phi, omega, amp, g = _rows(10 + rows, rows, k, s)
    want = _jax_vjp(phi, omega, amp, g, s)
    ins = [torch.tensor(x, requires_grad=True) for x in (phi, omega, amp)]
    before = kernels.counts()
    y = osc.OscillatorBank.apply(*ins, s)
    y.backward(torch.tensor(g))
    assert kernels.counts() == before
    ref = [torch.tensor(x, requires_grad=True) for x in (phi, omega, amp)]
    osc.oscillator_bank_plain(*ref, s).backward(torch.tensor(g))
    np.testing.assert_array_equal(y.detach().numpy(), osc.oscillator_bank_plain(
        *(torch.tensor(x) for x in (phi, omega, amp)), s).numpy())
    for t, r, w, name in zip(ins, ref, want, ("dphi", "domega", "damp")):
        _close_rel(t.grad.numpy(), w, name + " vs pallas")
        _close_rel(t.grad.numpy(), r.grad.numpy(), name + " vs plain autograd")


def test_noncontiguous_cotangent():
    """The cotangent reaches backward through reshapes; a non-contiguous one
    gives the same gradients as its contiguous copy."""
    phi, omega, amp, g = _rows(3, 4, 6, 32)
    ins = [torch.tensor(x, requires_grad=True) for x in (phi, omega, amp)]
    y = osc.OscillatorBank.apply(*ins, 32)
    g_nc = torch.tensor(np.ascontiguousarray(g.T)).T
    assert not g_nc.is_contiguous()
    grads = torch.autograd.grad(y, ins, g_nc)
    want = osc.oscillator_bank_bwd_plain(*(torch.tensor(x) for x in (phi, omega, amp, g)), 32)
    for a, b in zip(grads, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("use_pallas", ["interpret", "never"])
def test_harmonic_synth_frames_grads_match_jax(use_pallas):
    """df0 and dA through phase accumulation and the bank, against jax.grad
    of the JAX bank (tests/test_oscillator.py:162-182)."""
    rng = np.random.default_rng(4)
    b, f, k, block, sr = 2, 12, 8, 64, 16000
    f0 = rng.uniform(100, 400, (b, f)).astype(np.float32)
    amp = (rng.random((b, f, k)) / k).astype(np.float32)

    def loss_jax(f0_, amp_):
        if use_pallas == "interpret":
            phi, _ = jax_phase(f0_, block, sr)
            y = harmonic_synth_pallas(f0_, amp_, phi, block, sr, interpret=True)
        else:
            y = jax_synth_frames(f0_, amp_, block, sr, use_pallas="never")
        return jnp.sum(jnp.sin(y))  # nonlinear, to exercise the chain rule

    want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(f0), jnp.asarray(amp))
    f0_t = torch.tensor(f0, requires_grad=True)
    amp_t = torch.tensor(amp, requires_grad=True)
    torch.sum(torch.sin(osc.harmonic_synth_frames(f0_t, amp_t, block, sr))).backward()
    np.testing.assert_allclose(f0_t.grad.numpy(), np.asarray(want[0]), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(amp_t.grad.numpy(), np.asarray(want[1]), rtol=5e-3, atol=5e-3)


def test_cpu_backward_runs_plain_version_without_launch():
    phi, omega, amp, g = (torch.tensor(x) for x in _rows(7, 3, 4, 32))
    before = kernels.counts()
    got = osc.oscillator_bank_bwd(phi, omega, amp, g, 32)
    want = osc.oscillator_bank_bwd_plain(phi, omega, amp, g, 32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kernels.counts() == before


@pytest.mark.parametrize(
    "grad,err",
    [
        (torch.zeros(3, 31), ValueError),
        (torch.zeros(3, 32, dtype=torch.float64), TypeError),
        (torch.zeros(32, 3).T, ValueError),
    ],
    ids=["grad-shape", "float64", "non-contiguous"],
)
def test_backward_wrapper_rejects_bad_inputs(grad, err):
    with pytest.raises(err):
        osc.oscillator_bank_bwd(torch.zeros(3), torch.zeros(3), torch.zeros(3, 4), grad, 32)


def test_backward_harmonic_bound():
    """The bound follows oscillator_bwd.cu's shared memory at its largest
    (4 rows a CTA): 4 warps × (32 reduced partials + 2 scalars) + 4 rows ×
    K padded to 32, all f32, within 48 KB."""
    assert osc.MAX_BWD_KERNEL_HARMONICS == (12288 - 4 * 32 - 8) // 4 // 32 * 32 == 3008
    assert 4 * (4 * 32 + 8 + 4 * osc.MAX_BWD_KERNEL_HARMONICS) <= 48 * 1024
    assert 4 * (4 * 32 + 8 + 4 * (osc.MAX_BWD_KERNEL_HARMONICS + 32)) > 48 * 1024
