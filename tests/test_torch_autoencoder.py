"""The port's mfcc-autoencoder against the JAX package: the MFCC front end
(`mfcc`, `StreamingMFCC`, the mel filterbank and DCT constants), the model
on the committed ddsp_violin_ae_bundle's weights, its streaming step, the
one-block-latency session, the transplant of its weights, and the entry
points that build it or refuse it.

Tolerances, each with its reason:
  * MFCC coefficients (dB scale, up to ~100): 1e-3 absolute, the JAX
    suite's bound for streamed against offline MFCCs
    (tests/test_streaming_autoencoder.py:83): FFTs from two libraries;
  * the model forward on the bundle's weights (hidden 512, 64 harmonics,
    reverb on): 2e-3 absolute, tests/test_full_model_parity.py:95;
  * the streaming step with injected noise: 1e-4 absolute, as the decoder's
    (tests/test_torch_streaming.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.export import load_bundle as jax_load_bundle
from ddsp_pytorch_tpu.ops import spectral as jspectral
from ddsp_pytorch_tpu.streaming import init_stream_state
from ddsp_pytorch_tpu.streaming.mfcc import StreamingMFCC as JaxStreamingMFCC
from ddsp_pytorch_tpu_torch.bundle import read_params
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.export import (
    export_run,
    load_bundle,
    make_stream_session,
    make_streaming_mfcc,
    make_streaming_synth,
)
from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder, init_params, load_model
from ddsp_pytorch_tpu_torch.ops import spectral
from ddsp_pytorch_tpu_torch.streaming import AutoencoderStreamSession, StreamingSynth
from ddsp_pytorch_tpu_torch.streaming.mfcc import StreamingMFCC
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict, state_dict_to_flax
from tests.test_torch_voice_pool import tiny_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AE_BUNDLE = os.path.join(REPO, "pretrained", "ddsp_violin_ae_bundle")
DECODER_BUNDLE = os.path.join(REPO, "pretrained", "ddsp_violin_bundle")
SR, BLOCK, SIGLEN = 16000, 64, 4096
N_FFT, N_MELS, N_MFCC = 128, 40, 30  # n_fft = 2·hop, the reference's geometry
MFCC_ATOL = 1e-3
MODEL_ATOL = 2e-3
STREAM_ATOL = 1e-4
KW_TINY = dict(hidden_size=16, n_harmonic=4, n_bands=5, sample_rate=SR, block_size=BLOCK, has_reverb=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(batch=2, seed=0, n=SIGLEN, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = np.sin(2 * np.pi * rng.uniform(150, 300, (batch, 1)) * t).astype(np.float32)
    x *= rng.uniform(0.2, 1.0, (batch, 1)).astype(np.float32)
    return x + 0.01 * rng.standard_normal((batch, n)).astype(np.float32)


GEOMETRY = dict(n_mfcc=N_MFCC, n_fft=N_FFT, hop_length=BLOCK, fmin=20.0, fmax=8000.0, n_mels=N_MELS)


# ------------------------------------------------------------------ MFCC


def test_mel_filterbank_and_dct_equal_jax():
    for args in ((48000, 1024, 128, 20.0, 8000.0), (SR, N_FFT, N_MELS, 20.0, 8000.0)):
        np.testing.assert_array_equal(spectral.mel_filterbank(*args), jspectral.mel_filterbank(*args))
    np.testing.assert_array_equal(spectral.dct_matrix(30, 128), jspectral.dct_matrix(30, 128))


@pytest.mark.parametrize("ref_db", [None, 0.0])
def test_mfcc_matches_jax(ref_db):
    x = _signal()
    want = np.asarray(jspectral.mfcc(jnp.asarray(x), SR, ref_db=ref_db, **GEOMETRY))
    got = spectral.mfcc(torch.tensor(x), SR, ref_db=ref_db, **GEOMETRY).numpy()
    assert got.shape == want.shape == (2, SIGLEN // BLOCK + 1, N_MFCC)
    np.testing.assert_allclose(got, want, atol=MFCC_ATOL)


def test_power_to_db_matches_jax():
    s = np.random.default_rng(1).uniform(0, 1, (2, 5, 7)).astype(np.float32) ** 8
    for ref_db in (None, -3.0):
        want = np.asarray(jspectral.power_to_db(jnp.asarray(s), ref_db=ref_db))
        got = spectral.power_to_db(torch.tensor(s), ref_db=ref_db).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("irregular", [False, True])
def test_streaming_mfcc_matches_jax_and_offline(irregular):
    """Block pushes (block 1 releases frames 0 and 1) and pushes that do
    not align with the hop: the same frames, in the same order, as the JAX
    extractor and as the port's offline `mfcc` with the same fixed ref_db."""
    x = _signal(seed=3)
    rng = np.random.default_rng(7)
    sizes = []
    while sum(sizes) < SIGLEN:
        n = (int(rng.integers(1, 4)) * BLOCK + int(rng.integers(0, BLOCK))) if irregular else BLOCK
        sizes.append(min(n, SIGLEN - sum(sizes)))
    port, ref = StreamingMFCC(SR, batch=2, ref_db=0.0, **GEOMETRY), JaxStreamingMFCC(
        SR, batch=2, ref_db=0.0, **GEOMETRY)
    got, want, counts = [], [], []
    for start, n in zip(np.cumsum([0] + sizes[:-1]), sizes):
        a, b = port.push(x[:, start : start + n]), ref.push(x[:, start : start + n])
        assert a.shape == b.shape
        counts.append(a.shape[1])
        got.append(a)
        want.append(b)
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    if not irregular:
        assert counts[0] == 0 and counts[1] == 2 and set(counts[2:]) == {1}
    np.testing.assert_allclose(got, want, atol=MFCC_ATOL)
    offline = spectral.mfcc(torch.tensor(x), SR, ref_db=0.0, **GEOMETRY).numpy()
    np.testing.assert_allclose(got, offline[:, : got.shape[1]], atol=MFCC_ATOL)


def test_streaming_mfcc_rejects_bad_geometry_and_shape():
    with pytest.raises(ValueError, match="n_fft <= 2"):
        StreamingMFCC(SR, n_fft=4 * BLOCK, hop_length=BLOCK)
    with pytest.raises(ValueError, match="batch"):
        StreamingMFCC(SR, batch=2, **dict(GEOMETRY)).push(np.zeros((3, BLOCK), np.float32))


def test_make_streaming_mfcc_reads_the_bundle_geometry():
    sm = make_streaming_mfcc(AE_BUNDLE)
    assert (sm.sample_rate, sm.n_fft, sm.hop, sm.n_mfcc, sm.ref_db) == (48000, 1024, 512, 30, 0.0)
    pc = Config.from_yaml(os.path.join(AE_BUNDLE, "config.yaml")).preprocess
    assert sm.batch == 1
    assert (sm.sample_rate, sm.n_fft, sm.hop, sm.n_mfcc) == (
        pc.sample_rate, pc.mfcc_n_fft, pc.block_size, pc.n_mfcc)


# ----------------------------------------------------------------- model


@pytest.fixture(scope="module")
def violin_ae():
    jmodel, jparams, _ = jax_load_bundle(AE_BUNDLE)
    tmodel, meta = load_bundle(AE_BUNDLE, device="cpu")
    return jmodel, jparams, tmodel, meta


def test_forward_with_bundle_weights_matches_jax(violin_ae):
    """DDSPAutoencoder.forward on the committed bundle's weights, the same
    MFCCs and the JAX model's own noise draw injected: every output within
    2e-3, and frame_controls likewise."""
    jmodel, jparams, tmodel, meta = violin_ae
    assert isinstance(tmodel, DDSPAutoencoder) and tmodel.has_reverb
    rng = np.random.default_rng(0)
    f, block = 12, tmodel.block_size
    x = _signal(batch=1, seed=4, n=f * block, sr=48000)
    mf = spectral.mfcc(torch.tensor(x), 48000, ref_db=0.0)[:, :f].numpy()
    batch = {"pitch": rng.uniform(200, 440, (1, f, 1)).astype(np.float32),
             "loudness": rng.standard_normal((1, f, 1)).astype(np.float32), "mfcc": mf}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    want = jmodel.apply({"params": jparams}, jbatch, rngs={"noise": key})
    noise = jmodel.apply({"params": jparams}, jbatch["pitch"], method=jmodel.sample_noise,
                         rngs={"noise": key})
    with torch.no_grad():
        got = tmodel({k: torch.tensor(v) for k, v in batch.items()}, noise=torch.tensor(np.asarray(noise)))
        h_ctrl, n_ctrl = tmodel.frame_controls(*(torch.tensor(batch[k]) for k in ("pitch", "loudness", "mfcc")))
    for k in ("z", "harmonic_audio", "noise", "signal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=MODEL_ATOL, err_msg=k)
    jh, jn = jmodel.apply({"params": jparams}, *(jbatch[k] for k in ("pitch", "loudness", "mfcc")),
                          method=jmodel.frame_controls)
    np.testing.assert_allclose(n_ctrl["magnitudes"].numpy(), np.asarray(jn["magnitudes"]), atol=MODEL_ATOL)
    for k in ("amplitudes", "harmonic_distribution"):
        np.testing.assert_allclose(h_ctrl[k].numpy(), np.asarray(jh[k]), atol=MODEL_ATOL, err_msg=k)
    assert float(np.abs(got["signal"].numpy()).max()) > 1e-3


def test_streaming_step_with_injected_noise_matches_jax():
    """The tiny autoencoder's streaming_step, carrying the encoder GRU, the
    decoder GRU and the phase over 6 blocks with injected noise, equals the
    JAX step's (1e-4), and its streamed output equals its own offline
    forward before the reverb."""
    jmodel, jparams, tmodel = tiny_models(has_reverb=True, autoencoder=True)
    rng = np.random.default_rng(5)
    n = 6
    f0 = rng.uniform(150, 350, (2, n, 1)).astype(np.float32)
    ld = rng.standard_normal((2, n, 1)).astype(np.float32)
    mf = (10 * rng.standard_normal((2, n, N_MFCC))).astype(np.float32)
    noise = rng.uniform(-1, 1, (2, n, BLOCK)).astype(np.float32)
    s0 = init_stream_state(16, 2, enc_hidden_size=16)
    j = (s0.enc_gru, s0.gru, s0.phase)
    jstep = jax.jit(lambda *a: jmodel.apply({"params": jparams}, *a, method=jmodel.streaming_step))
    t = (torch.zeros(2, 16), torch.zeros(2, 16), torch.zeros(2))
    outs = []
    for i in range(n):
        sl = slice(i, i + 1)
        ja, *j = jstep(jnp.asarray(f0[:, sl]), jnp.asarray(ld[:, sl]), jnp.asarray(mf[:, sl]), *j,
                       jnp.asarray(noise[:, sl]))
        with torch.inference_mode():
            ta, *t = tmodel.streaming_step(torch.tensor(f0[:, sl]), torch.tensor(ld[:, sl]),
                                           torch.tensor(mf[:, sl]), *t, torch.tensor(noise[:, sl]))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=STREAM_ATOL, err_msg=f"block {i}")
        outs.append(ta)
    for got, want in zip(t, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=STREAM_ATOL)
    with torch.inference_mode():
        offline = tmodel({"pitch": torch.tensor(f0), "loudness": torch.tensor(ld), "mfcc": torch.tensor(mf)},
                         noise=torch.tensor(noise))
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(),
                               (offline["harmonic_audio"] + offline["noise"]).numpy(), atol=STREAM_ATOL)


def test_streaming_synth_needs_mfcc_frames():
    _, _, tmodel = tiny_models(autoencoder=True)
    synth = StreamingSynth(tmodel, device="cpu")
    f0, ld = np.full((1, 2, 1), 220.0, np.float32), np.zeros((1, 2, 1), np.float32)
    a1 = synth.step(f0, ld, np.ones((1, 2, N_MFCC), np.float32))
    a2 = synth.step(f0, ld, np.ones((1, 2, N_MFCC), np.float32))
    assert a1.shape == (1, 2 * BLOCK) and not torch.equal(a1, a2)
    with pytest.raises(ValueError, match="mfcc"):
        synth.step(f0, ld)


def test_weights_round_trip_the_bundle_tree(violin_ae):
    _, _, tmodel, _ = violin_ae
    tree = read_params(AE_BUNDLE)
    back = state_dict_to_flax(flax_to_state_dict(tree))

    def same(a, b, path=""):
        assert sorted(a) == sorted(b), path
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=f"{path}/{k}")

    same(tree, back)
    assert sorted(state_dict_to_flax(tmodel.state_dict())) == sorted(tree)


def test_init_params_covers_the_encoder():
    model = init_params(load_model("mfcc-autoencoder", dict(KW_TINY)), torch.Generator().manual_seed(0))
    enc = model.encoder
    assert bool(enc.GRU_0.weight_ih.abs().max() > 0) and bool(enc.Dense_0.weight.abs().max() > 0)
    assert torch.equal(enc.LayerNorm_0.weight, torch.ones(N_MFCC))
    w = enc.GRU_0.weight_hh.detach()  # flax's orthogonal w_hh (H, 3H), transposed
    np.testing.assert_allclose((w.T @ w).numpy(), np.eye(16), atol=1e-5)
    assert bool(model.decoder.z_mlp.Dense_0.weight.abs().max() > 0)


# -------------------------------------------------------------- sessions


def test_session_has_one_block_of_latency():
    """make_stream_session on the AE bundle: the first block out is
    silence, and the session's output is the library path (StreamingMFCC +
    the synth's step on the frames it releases) one block late."""
    session = make_stream_session(AE_BUNDLE, device="cpu", noise_deterministic=True)
    assert isinstance(session, AutoencoderStreamSession) and session.needs_audio
    synth = make_streaming_synth(AE_BUNDLE, device="cpu", noise_deterministic=True)
    sm = make_streaming_mfcc(AE_BUNDLE)
    block, n_blocks = session.block_size, 5
    x = _signal(batch=1, seed=9, n=n_blocks * block, sr=48000)[0]
    pitch = np.full(n_blocks * block, 330.0, np.float32)
    loud = np.full(n_blocks * block, -7.0, np.float32)
    got = np.concatenate([session.step_samples(pitch[i * block:(i + 1) * block],
                                               loud[i * block:(i + 1) * block],
                                               x[i * block:(i + 1) * block]) for i in range(n_blocks)])
    assert got.shape == (n_blocks * block,)
    np.testing.assert_array_equal(got[:block], 0.0)
    frames = np.concatenate([sm.push(x[None, i * block:(i + 1) * block]) for i in range(n_blocks)], axis=1)
    f = frames.shape[1]
    want = synth.step(pitch[None, : f * block : block, None], loud[None, : f * block : block, None],
                      frames)[0].numpy()
    np.testing.assert_allclose(got[block:], want[: (n_blocks - 1) * block], atol=STREAM_ATOL)
    assert float(np.abs(got).max()) > 1e-3
    with pytest.raises(ValueError, match="block_size"):
        session.step_samples(pitch[:100], loud[:100], x[:100])


def test_make_stream_session_gives_the_synth_for_a_decoder_bundle():
    session = make_stream_session(DECODER_BUNDLE, device="cpu")
    assert isinstance(session, StreamingSynth) and not session.needs_audio


# ------------------------------------------------------- once refused


def test_trainer_and_export_run_refuse_the_autoencoder(tmp_path):
    """Both took the autoencoder's config only to refuse it until its
    training was ported; now the Trainer builds it, and export_run of a run
    without a checkpoint fails for that reason alone
    (tests/test_torch_autoencoder_training.py and test_torch_export.py train
    and export one)."""
    cfg = Config.from_yaml(os.path.join(AE_BUNDLE, "config.yaml"))
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu", use_tensorboard=False)
    assert trainer.model.encoder.GRU_0.hidden_size == cfg.model.kwargs["hidden_size"]
    trainer.close()
    run = tmp_path / "ae_run"
    run.mkdir()
    cfg.to_yaml(str(run / "config.yaml"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export_run(str(run), str(tmp_path / "export"), device="cpu")
