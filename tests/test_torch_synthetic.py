"""The port's synthetic corpus (data/synthetic.py) against the JAX
package's, on the CPU at a small size (3 items a partition, 16 kHz, block
256, 16384 samples, 8 harmonics), for the violin preset (the corpus of
pretrained/ddsp_violin_ae_bundle, MFCCs at the fixed 0 dB reference) and
the random tones (the global-maximum reference).

Tolerances:
  * file names, shapes and dtypes: equal; pitchs.npy: bitwise (the same
    numpy draws in the same order);
  * signals.npy: within 1e-4 of the peak of a float64 render of the same
    controls, and within that plus the JAX render's own distance from it
    of the JAX file.  The JAX package sums the frame phases in float32
    (its render is ~1e-4 of the peak from float64 here), the port in
    float64 (tests/test_torch_oscillator.py);
  * loudness.npy within 1e-3 and mfccs.npy within 1e-3 of their peak of
    what the JAX package's extract_loudness and mfcc give on the port's
    signals.  The features are compared on the same signals because the
    notes start (violin: attack from 0) or start and end (tone: a Hann
    envelope) at zero amplitude, where the audio is the render's rounding
    residue and the log loudness of the two renders differs by up to
    1.5e-3 (violin) and 0.04 (tone) at that frame; the renders themselves
    are compared above.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.data import make_synthetic_dataset as jax_make_synthetic_dataset
from ddsp_pytorch_tpu.ops import extract_loudness as jax_extract_loudness
from ddsp_pytorch_tpu.ops import harmonic_synth_frames as jax_harmonic_synth_frames
from ddsp_pytorch_tpu.ops import mfcc as jax_mfcc
from ddsp_pytorch_tpu_torch.data import make_synthetic_dataset

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SR, BLOCK, LENGTH, K = 16000, 256, 16384, 8
NAMES = ("signals", "pitchs", "loudness", "mfccs")
SIGNAL_REL_OF_PEAK, LOUDNESS_ATOL, MFCC_REL_OF_PEAK = 1e-4, 1e-3, 1e-3


def _render_f64(pitch: np.ndarray, amps: np.ndarray) -> np.ndarray:
    """The harmonic bank in float64 from float32 controls: φ summed exactly,
    then Σ_k A_k sin(k(φ + (i+1)ω))."""
    omega = 2 * np.pi * pitch.astype(np.float64) / SR
    inc = np.cumsum(np.mod(BLOCK * omega, 2 * np.pi), axis=-1)
    phi = np.concatenate([np.zeros(pitch.shape[:-1] + (1,)), inc[..., :-1]], axis=-1)
    theta = phi[..., None] + omega[..., None] * np.arange(1, BLOCK + 1)
    k = np.arange(1, amps.shape[-1] + 1)
    out = np.einsum("nfk,nfsk->nfs", amps.astype(np.float64), np.sin(k * theta[..., None]))
    return out.reshape(pitch.shape[0], -1)


@pytest.fixture(scope="module", params=["violin", "tone"])
def corpora(request, tmp_path_factory):
    instrument = request.param
    root = tmp_path_factory.mktemp(f"synthetic_{instrument}")
    kw = dict(n_items=3, sample_rate=SR, signal_length=LENGTH, block_size=BLOCK, n_harmonic=K, seed=5,
              instrument=instrument, mfcc_ref_db=0.0 if instrument == "violin" else None)
    port = make_synthetic_dataset(str(root / "port"), device="cpu", **kw)
    jax_make_synthetic_dataset(str(root / "jax"), **kw)
    return instrument, root, port


def _load(root, side, part):
    return {n: np.load(os.path.join(root, side, part, f"{n}.npy")) for n in NAMES}


def test_files_and_pitch_equal(corpora):
    _, root, port = corpora
    for part in ("train", "validation"):
        assert sorted(os.listdir(root / "port" / part)) == sorted(os.listdir(root / "jax" / part))
        got, want = _load(root, "port", part), _load(root, "jax", part)
        for n in NAMES:
            assert got[n].shape == want[n].shape and got[n].dtype == want[n].dtype, n
        assert got["mfccs"].shape == (3, LENGTH // BLOCK + 1, 30)
        np.testing.assert_array_equal(got["pitchs"], want["pitchs"])
    for n in NAMES:  # the last partition's arrays are returned
        np.testing.assert_array_equal(port[n], _load(root, "port", "validation")[n])


def test_signals_match_jax_and_float64(corpora, monkeypatch):
    """Each partition's audio against a float64 render of the controls the
    port's render received (recorded by rendering the corpus again through
    a stand-in for harmonic_synth_frames), its breath noise added."""
    import ddsp_pytorch_tpu_torch.data.synthetic as synthetic

    instrument, root, _ = corpora
    seen = []
    real = synthetic.harmonic_synth_frames

    def record(f0, amps, *args, **kwargs):
        seen.append((f0.numpy().copy(), amps.numpy().copy()))
        return real(f0, amps, *args, **kwargs)

    monkeypatch.setattr(synthetic, "harmonic_synth_frames", record)
    again = make_synthetic_dataset(str(root / "again"), n_items=3, sample_rate=SR, signal_length=LENGTH,
                                   block_size=BLOCK, n_harmonic=K, seed=5, instrument=instrument,
                                   mfcc_ref_db=0.0 if instrument == "violin" else None, device="cpu")
    np.testing.assert_array_equal(again["signals"], _load(root, "port", "validation")["signals"])
    for part, (pitch, amps) in zip(("train", "validation"), seen):
        got, want = _load(root, "port", part), _load(root, "jax", part)
        dry64 = _render_f64(pitch, amps)
        # the breath noise is the same bits on both sides: take it out
        noise = want["signals"] - np.asarray(jax_harmonic_synth_frames(
            jnp.asarray(pitch), jnp.asarray(amps), BLOCK, SR, use_pallas="never"))
        ref = dry64 + noise
        peak = float(np.abs(ref).max())
        port_err = float(np.abs(got["signals"] - ref).max())
        jax_err = float(np.abs(want["signals"] - ref).max())
        assert port_err <= SIGNAL_REL_OF_PEAK * peak, (part, port_err / peak)
        assert float(np.abs(got["signals"] - want["signals"]).max()) <= SIGNAL_REL_OF_PEAK * peak + jax_err


def test_features_match_jax(corpora):
    instrument, root, _ = corpora
    ref_db = 0.0 if instrument == "violin" else None
    for part in ("train", "validation"):
        got = _load(root, "port", part)
        sig = jnp.asarray(got["signals"])
        loud = np.asarray(jax_extract_loudness(sig, SR, BLOCK))
        mf = np.asarray(jax_mfcc(sig, SR, n_mfcc=30, n_fft=1024, hop_length=BLOCK, n_mels=128, ref_db=ref_db))
        np.testing.assert_allclose(got["loudness"], loud, atol=LOUDNESS_ATOL)
        mf_peak = float(np.abs(mf).max())
        assert float(np.abs(got["mfccs"] - mf).max()) <= MFCC_REL_OF_PEAK * mf_peak
