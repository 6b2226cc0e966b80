"""The port's A-weighted loudness (ops/loudness.py) against the JAX
package's, on the CPU, on the same numpy inputs.

Tolerance: 1e-4 absolute (in log-magnitude units), on harmonic tones with
a noise floor 50 dB down, as recorded audio has, and on the same tones 80
dB quieter (near silence, where the 1e-7 floor dominates).  A synthetic
tone with no noise floor at all leaves most STFT bins at float32 rounding
magnitudes (1e-7 to 1e-9), where log(mag + 1e-7) turns two FFT libraries'
rounding into up to 0.075 (measured at n_fft 512 and 2048); such input is
not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops import loudness as jax_loudness
from ddsp_pytorch_tpu_torch.ops import loudness

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SR, BLOCK = 16000, 256
ATOL = 1e-4


def _tone(rng, batch, n, floor):
    t = np.arange(n) / SR
    f0 = rng.uniform(150, 400, (batch, 1))
    x = sum(0.4 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
    x = x + floor * rng.standard_normal((batch, n))
    return x.astype(np.float32)


def test_a_weighting_table_equals_jax():
    for n_fft in (512, 2048):
        f = loudness.fft_frequencies(SR, n_fft)
        np.testing.assert_array_equal(f, jax_loudness.fft_frequencies(SR, n_fft))
        np.testing.assert_array_equal(loudness.a_weighting(f), jax_loudness.a_weighting(f))
    assert loudness.a_weighting(np.array([0.0]))[0] == -80.0


@pytest.mark.parametrize("n_fft", [512, 2048])
@pytest.mark.parametrize("shape", ["T", "BT"])
@pytest.mark.parametrize("level", ["floored", "near_silent"])
def test_extract_loudness_matches_jax(n_fft, shape, level):
    rng = np.random.default_rng(n_fft)
    batch = 1 if shape == "T" else 3
    x = _tone(rng, batch, SR, floor=1e-3)
    if level == "near_silent":
        x = x * np.float32(1e-4)
    if shape == "T":
        x = x[0]
    got = loudness.extract_loudness(x, SR, BLOCK, n_fft, device="cpu")
    want = np.asarray(jax_loudness.extract_loudness(jnp.asarray(x), SR, BLOCK, n_fft))
    assert got.dtype.is_floating_point and tuple(got.shape) == want.shape == x.shape[:-1] + (SR // BLOCK,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert np.isfinite(got.numpy()).all()
