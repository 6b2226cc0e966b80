"""The port's L0 elementwise, window and FIR/FFT ops against the JAX package.

Tolerances: 1e-5 absolute for the FFT-based ops (the same transforms from
two FFT libraries, on values of order 1), 1e-6 relative for the elementwise
ops (the same f32 formula; exp/log from two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu import ops as jops
from ddsp_pytorch_tpu_torch import ops

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n_bands,target", [(65, 512), (9, 64), (17, 32)])
def test_amp_to_impulse_response(n_bands, target):
    amp = _rng(0).random((2, 5, n_bands)).astype(np.float32)
    want = jops.amp_to_impulse_response(jnp.asarray(amp), target)
    got = ops.amp_to_impulse_response(torch.tensor(amp), target)
    assert got.shape == (2, 5, target)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n", [64, 512, 1000])
def test_fft_convolve(n):
    rng = _rng(1)
    sig = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    ker = rng.uniform(-1, 1, (1, n)).astype(np.float32) / n
    want = jops.fft_convolve(jnp.asarray(sig), jnp.asarray(ker))
    got = ops.fft_convolve(torch.tensor(sig), torch.tensor(ker))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n_bands,block", [(65, 512), (9, 64)])
def test_filtered_noise_injected(n_bands, block):
    rng = _rng(2)
    mags = rng.random((2, 4, n_bands)).astype(np.float32)
    noise = rng.uniform(-1, 1, (2, 4, block)).astype(np.float32)
    want = jops.filtered_noise(jnp.asarray(mags), block, None, noise=jnp.asarray(noise))
    got = ops.filtered_noise(torch.tensor(mags), block, noise=torch.tensor(noise))
    assert got.shape == (2, 4 * block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_filtered_noise_draws_from_generator():
    mags = torch.rand(1, 3, 9)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a = ops.filtered_noise(mags, 64, generator=g1)
    b = ops.filtered_noise(mags, 64, generator=g2)
    c = ops.filtered_noise(mags, 64, generator=g1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_scale_function():
    x = np.linspace(-60, 30, 1001, dtype=np.float32)
    want = np.asarray(jops.scale_function(jnp.asarray(x)))
    got = ops.scale_function(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_remove_above_nyquist():
    rng = _rng(3)
    amp = rng.random((2, 6, 64)).astype(np.float32)
    f0 = rng.uniform(50, 3000, (2, 6, 1)).astype(np.float32)
    want = np.asarray(jops.remove_above_nyquist(jnp.asarray(amp), jnp.asarray(f0), 48000))
    got = ops.remove_above_nyquist(torch.tensor(amp), torch.tensor(f0), 48000).numpy()
    np.testing.assert_array_equal(got, want)


def test_safe_log_and_hann():
    x = _rng(4).random(100).astype(np.float32)
    np.testing.assert_allclose(
        ops.safe_log(torch.tensor(x)).numpy(), np.asarray(jops.safe_log(jnp.asarray(x))), rtol=1e-6
    )
    for n in (128, 1024):
        np.testing.assert_allclose(
            ops.hann_window(n).numpy(), np.asarray(jops.hann_window(n)), atol=1e-7
        )
