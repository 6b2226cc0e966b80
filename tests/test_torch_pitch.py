"""The port's YIN + Viterbi pitch tracker (ops/pitch.py) against the JAX
package's, on the CPU, on the same numpy inputs.

Tolerances:
  * framing: equal;
  * cmndf: 5e-5 absolute.  Both sides are float32 and each differs from a
    float64 CMNDF by up to 1.9e-5 (measured on the glide below, at lag 2,
    where E0 + E(τ) − 2C(τ) cancels most and the cumulative mean is
    smallest), so two FFT libraries differ by up to 2.1e-5 there;
  * the emission on the pitch grid: 5e-5 absolute (the same values
    interpolated);
  * the Viterbi path: equal on the same emission matrix, ties included;
  * extract_pitch: 1e-3 relative;
  * a 220 Hz tone through save_wav/load_wav: its median f0 within 0.5 Hz.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.ops import pitch as jax_pitch
from ddsp_pytorch_tpu_torch.ops import pitch
from ddsp_pytorch_tpu_torch.utils import load_wav, save_wav

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SR, BLOCK = 16000, 256
CMNDF_ATOL = 5e-5
F0_RTOL = 1e-3


def _signals() -> dict:
    t = np.arange(SR) / SR
    glide = np.cumsum(np.linspace(150.0, 600.0, t.size)) / SR
    out = {
        "tone": 0.5 * np.sin(2 * np.pi * 220.0 * t),
        "glide": 0.5 * np.sin(2 * np.pi * glide),
        # strong second harmonic over a weak fundamental: d' dips at the
        # period of 400 Hz and of 200 Hz alike
        "octave_ambiguous": (0.15 * np.sin(2 * np.pi * 200.0 * t) + 0.6 * np.sin(2 * np.pi * 400.0 * t)
                             + 0.3 * np.sin(2 * np.pi * 800.0 * t)),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def test_framing_and_cmndf_match_jax():
    x = _signals()["glide"]
    tau_max = int(np.ceil(SR / 50.0))
    length = 2048 + tau_max
    want = np.asarray(jax_pitch._frame_centered(jnp.asarray(x), length, BLOCK))
    got = pitch.frame_centered(torch.tensor(x), length, BLOCK).numpy()
    assert got.shape == want.shape == (1 + SR // BLOCK, length)
    np.testing.assert_array_equal(got, want)
    d_jax = np.asarray(jax_pitch.cmndf(jnp.asarray(want), 2048, tau_max))
    d = pitch.cmndf(torch.tensor(want), 2048, tau_max).numpy()
    assert d.shape == d_jax.shape == (want.shape[0], tau_max + 1)
    np.testing.assert_array_equal(d[:, 0], 1.0)
    np.testing.assert_allclose(d, d_jax, atol=CMNDF_ATOL)


def test_grid_and_emission_match_jax():
    np.testing.assert_array_equal(pitch.pitch_grid(50.0, 2000.0, 60), jax_pitch._pitch_grid(50.0, 2000.0, 60))
    x = _signals()["glide"]
    want = np.asarray(jax_pitch.yin_emission(jnp.asarray(x), SR, BLOCK))
    got = pitch.yin_emission(torch.tensor(x), SR, BLOCK).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=CMNDF_ATOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_viterbi_path_equals_jax_with_ties(batch):
    """Emission costs rounded to one decimal, so that many predecessors tie
    for the minimum: both sides take the first."""
    rng = np.random.default_rng(batch)
    n_bins = pitch.pitch_grid(50.0, 2000.0, 60).shape[0]
    emis = np.round(rng.uniform(0.0, 1.0, (batch, 40, n_bins)), 1).astype(np.float32)
    emis[:, 5:9] = 0.0  # whole frames of tied bins
    switch = pitch.switch_cost(n_bins, 60)
    got = pitch.viterbi(torch.tensor(emis), torch.tensor(switch))
    assert got.shape == (batch, 40)
    for b in range(batch):
        np.testing.assert_array_equal(got[b], np.asarray(jax_pitch._viterbi(jnp.asarray(emis[b]),
                                                                              jnp.asarray(switch))))
    one = pitch.viterbi(torch.tensor(emis[0, :1]), torch.tensor(switch))  # a single frame
    np.testing.assert_array_equal(one, np.asarray(jax_pitch._viterbi(jnp.asarray(emis[0, :1]),
                                                                       jnp.asarray(switch))))


@pytest.mark.parametrize("name", ["tone", "glide", "octave_ambiguous"])
def test_extract_pitch_matches_jax(name):
    x = _signals()[name]
    want = np.asarray(jax_pitch.extract_pitch(x, SR, BLOCK))
    got = pitch.extract_pitch(x, SR, BLOCK, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (SR // BLOCK,)
    np.testing.assert_allclose(got.numpy(), want, rtol=F0_RTOL)


def test_extract_pitch_batches_rows():
    """A batch of signals gives each row's own track."""
    sigs = _signals()
    x = np.stack([sigs["tone"], sigs["glide"], sigs["octave_ambiguous"]])
    got = pitch.extract_pitch(x, SR, BLOCK, device="cpu").numpy()
    for row, want in zip(got, x):
        np.testing.assert_allclose(row, pitch.extract_pitch(want, SR, BLOCK, device="cpu").numpy(),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="mono"):
        pitch.extract_pitch(x[None], SR, BLOCK, device="cpu")


def test_tone_through_wav_round_trip(tmp_path):
    """The verify skill's drive: a 220 Hz tone rendered, written as 16-bit
    PCM, read back and tracked."""
    sr = 48000
    t = np.arange(sr) / sr
    tone = sum(a * np.sin(2 * np.pi * 220.0 * k * t) for k, a in ((1, 0.5), (2, 0.25), (3, 0.12), (4, 0.06)))
    save_wav(str(tmp_path / "tone.wav"), tone.astype(np.float32), sr)
    back, sr_back = load_wav(str(tmp_path / "tone.wav"), sr)
    assert sr_back == sr and back.dtype == np.float32
    f0 = pitch.extract_pitch(back, sr, 512, device="cpu").numpy()
    assert abs(float(np.median(f0[5:-5])) - 220.0) <= 0.5
