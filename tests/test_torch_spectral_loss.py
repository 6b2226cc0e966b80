"""The port's STFT, multiscale FFT, spectral loss and loudness stats
against the JAX package's.

Tolerances: magnitudes 1e-5 relative to the spectrum's largest value (two
FFT libraries on f32 frames of unit-scale audio); the loss 1e-5 relative
(a sum of means over every bin of every scale); loudness stats 1e-6
relative (f32 means and stds of values of order 10, reduced in other
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops import mean_std_loudness as jax_mean_std_loudness
from ddsp_pytorch_tpu.ops.spectral import frame_signal as jax_frame_signal
from ddsp_pytorch_tpu.ops.spectral import multiscale_fft as jax_multiscale_fft
from ddsp_pytorch_tpu.ops.spectral import stft as jax_stft
from ddsp_pytorch_tpu.training.loss import spectral_loss_from_signals as jax_loss
from ddsp_pytorch_tpu_torch import ops
from ddsp_pytorch_tpu_torch.training.loss import spectral_loss_from_signals

SCALES = [512, 256, 128]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on shared cores, where torch's default of one thread per core
    oversubscribes them (results here do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signals(seed, b=2, t=4096):
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 16000.0
    tone = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 800, (b, 1)) * n)
    return (tone + 0.05 * rng.standard_normal((b, t))).astype(np.float32)


def test_frame_signal_matches_jax():
    x = _signals(0, 2, 1000)
    np.testing.assert_array_equal(
        ops.frame_signal(torch.tensor(x), 256, 64).numpy(), np.asarray(jax_frame_signal(jnp.asarray(x), 256, 64))
    )


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (256, 64), (128, 32)])
def test_stft_magnitude_matches_jax(n_fft, hop):
    x = _signals(1)
    want = np.asarray(jax_stft(jnp.asarray(x), n_fft, hop))
    got = ops.stft(torch.tensor(x), n_fft, hop).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_multiscale_fft_matches_jax():
    x = _signals(3)
    want = jax_multiscale_fft(jnp.asarray(x), SCALES, 0.75)
    got = ops.multiscale_fft(torch.tensor(x), SCALES, 0.75)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_loss_and_its_gradient_match_jax():
    import jax

    x, y = _signals(4), _signals(5)
    want, _, _ = jax_loss(jnp.asarray(x), jnp.asarray(y), SCALES, 0.75)
    want_g = jax.grad(lambda r: jax_loss(jnp.asarray(x), r, SCALES, 0.75)[0])(jnp.asarray(y))
    y_t = torch.tensor(y, requires_grad=True)
    got, ori, rec = spectral_loss_from_signals(torch.tensor(x), y_t, SCALES, 0.75)
    got.backward()
    assert len(ori) == len(rec) == len(SCALES)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(y_t.grad.numpy(), want_g, atol=1e-4 * np.abs(want_g).max())


def test_loss_zero_for_identical_signals_and_length_check():
    x = torch.tensor(_signals(6))
    assert float(spectral_loss_from_signals(x, x, [256], 0.75)[0]) == 0.0
    with pytest.raises(ValueError, match="n_frames"):
        spectral_loss_from_signals(x, x[..., :-1], [256], 0.75)


def test_mean_std_loudness_matches_jax():
    rng = np.random.default_rng(7)
    batches = [{"loudness": (rng.standard_normal((4, 30, 1)) * 2 - 8).astype(np.float32)} for _ in range(5)]
    want = jax_mean_std_loudness(batches)
    got = ops.mean_std_loudness(batches)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a running mean of per-batch stds, not the global std
    assert abs(got[1] - np.concatenate([b["loudness"] for b in batches]).std(ddof=1)) > 1e-4
