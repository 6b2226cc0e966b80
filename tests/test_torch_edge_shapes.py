"""The port at the edge shapes of tests/test_edge_shapes.py, against the JAX
package on the CPU: a signal shorter than the reverb's impulse, batch 1 for
both families, the loss's clear error on a signal that is not a block
multiple, 44.1 kHz with block 441 (YIN, loudness, MFCCs and the hybrid
tracker), and a stream chunked one frame at a time.

Tolerances: the models within 1e-4 absolute of JAX with transplanted
weights and injected noise (tests/test_torch_models.py); the chunked stream
within 1e-4 of one call (tests/test_edge_shapes.py:160); YIN within 1e-3
relative (tests/test_torch_pitch.py), loudness 1e-4 (test_torch_loudness.py),
MFCCs 1e-3 (test_torch_autoencoder.py), the hybrid track 1e-4 relative
(test_torch_crepe.py); the medians as tests/test_edge_shapes.py:108-122.
The loudness of the JAX file's pure sine is held to 0.1 dB (see
LOUDNESS_FLOOR_ATOL) and a noisy copy of it to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.models import load_model as jax_load_model
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth, init_stream_state
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict

ATOL = 1e-4
F0_RTOL, LOUDNESS_ATOL, MFCC_ATOL, TRACK_RTOL = 1e-3, 1e-4, 1e-3, 1e-4
# a pure sine leaves most STFT bins at the FFT's rounding floor, whose log
# two FFT libraries put apart by up to 0.075 (ROADMAP.md §3, parity limits):
# the sine's loudness is held to that, the same sine with noise to 1e-4
LOUDNESS_FLOOR_ATOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(sr=16000, block=64, *, name="single-inst-decoder", reverb=False, frames=8) -> dict:
    """tests/test_edge_shapes.py:17-38's config."""
    return {
        "preprocess": {"sample_rate": sr, "signal_length": frames * block, "block_size": block},
        "model": {"name": name, "kwargs": {"hidden_size": 16, "n_harmonic": 4, "n_bands": 5, "sample_rate": sr,
                                           "block_size": block, "has_reverb": reverb, "use_pallas": "never"}},
    }


def _models(raw: dict, batch: dict):
    """(JAX model, its params, the port's model with them)."""
    cfg = JaxConfig.from_dict(raw)
    jmodel = jax_load_model(cfg)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    params = jmodel.init(rngs, jax.tree.map(jnp.asarray, batch))["params"]
    tmodel = load_model(raw["model"]["name"], raw["model"]["kwargs"])
    tmodel.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return jmodel, params, tmodel.eval()


def _forward_both(raw: dict, batch_size: int = 1, frames: int = None):
    """The JAX forward (tests/test_edge_shapes.py:41-60) and the port's on
    the same weights and noise → (port signal, JAX signal)."""
    block = raw["preprocess"]["block_size"]
    f = frames or raw["preprocess"]["signal_length"] // block
    rng = np.random.default_rng(0)
    batch = {"pitch": rng.uniform(150, 350, (batch_size, f, 1)).astype(np.float32),
             "loudness": rng.standard_normal((batch_size, f, 1)).astype(np.float32)}
    if raw["model"]["name"] == "mfcc-autoencoder":
        from ddsp_pytorch_tpu.models.encoder import N_MFCCS

        batch["mfcc"] = rng.standard_normal((batch_size, f, N_MFCCS)).astype(np.float32)
    jmodel, params, tmodel = _models(raw, batch)
    key = jax.random.PRNGKey(1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    want = jmodel.apply({"params": params}, jbatch, rngs={"noise": key})["signal"]
    noise = jmodel.apply({"params": params}, jbatch["pitch"], method=jmodel.sample_noise, rngs={"noise": key})
    with torch.no_grad():
        got = tmodel({k: torch.tensor(v) for k, v in batch.items()}, noise=torch.tensor(np.asarray(noise)))
    return got["signal"].numpy(), np.asarray(want)


def test_signal_shorter_than_reverb_ir():
    """4 frames (256 samples) through a 1 s reverb (16 000 samples)."""
    got, want = _forward_both(_raw(reverb=True), frames=4)
    assert got.shape == want.shape == (1, 4 * 64)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", ["single-inst-decoder", "mfcc-autoencoder"])
def test_batch_one_offline(name):
    raw = _raw(name=name, reverb=True)
    got, want = _forward_both(raw, batch_size=1)
    assert got.shape == want.shape == (1, raw["preprocess"]["signal_length"])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_loss_rejects_sig_not_block_multiple():
    from ddsp_pytorch_tpu.training.loss import spectral_loss_from_signals as jax_loss
    from ddsp_pytorch_tpu_torch.training.loss import spectral_loss_from_signals

    with pytest.raises(ValueError, match="block_size"):
        spectral_loss_from_signals(torch.zeros(1, 2148), torch.zeros(1, 2048), (256,), 0.75)
    with pytest.raises(ValueError, match="block_size"):
        jax_loss(jnp.zeros((1, 2148)), jnp.zeros((1, 2048)), (256,), 0.75)


def test_odd_sample_rate_44100_ops():
    """YIN, loudness, MFCCs and the default hybrid tracker (through its
    44.1 → 16 kHz resampler) at 44.1 kHz with block 441."""
    from ddsp_pytorch_tpu import ops as jops
    from ddsp_pytorch_tpu.data.preprocess import make_pitch_fn as jax_make_pitch_fn
    from ddsp_pytorch_tpu_torch import ops
    from ddsp_pytorch_tpu_torch.data.preprocess import make_pitch_fn

    sr, block = 44100, 441
    x = np.sin(2 * np.pi * 220.0 * np.arange(sr) / sr).astype(np.float32)
    f0 = ops.extract_pitch(x, sr, block, device="cpu").numpy()
    assert f0.shape == (sr // block,)
    assert abs(np.median(f0[5:-5]) - 220.0) < 2.0
    np.testing.assert_allclose(f0, np.asarray(jops.extract_pitch(x, sr, block)), rtol=F0_RTOL)
    lo = ops.extract_loudness(x[None, :], sr, block, device="cpu").numpy()
    assert lo.shape == (1, sr // block)
    np.testing.assert_allclose(lo, np.asarray(jops.extract_loudness(x[None, :], sr, block)),
                               atol=LOUDNESS_FLOOR_ATOL)
    noisy = (x + 0.05 * np.random.default_rng(0).standard_normal(sr)).astype(np.float32)[None, :]
    np.testing.assert_allclose(ops.extract_loudness(noisy, sr, block, device="cpu").numpy(),
                               np.asarray(jops.extract_loudness(noisy, sr, block)), atol=LOUDNESS_ATOL)
    m = ops.mfcc(torch.tensor(x[None, :]), sr, hop_length=block).numpy()
    assert m.shape[0] == 1 and np.all(np.isfinite(m))
    np.testing.assert_allclose(m, np.asarray(jops.mfcc(jnp.asarray(x[None, :]), sr, hop_length=block)),
                               atol=MFCC_ATOL)

    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg, jcfg):
        c.preprocess.sample_rate, c.preprocess.block_size = sr, block
    assert cfg.preprocess.pitch_tracker == jcfg.preprocess.pitch_tracker == "hybrid"
    fh = make_pitch_fn(cfg, device="cpu")(torch.tensor(x), sr, block).numpy()
    assert fh.shape == (sr // block,)
    assert abs(np.median(fh[5:-5]) - 220.0) < 3.0
    np.testing.assert_allclose(fh, np.asarray(jax_make_pitch_fn(jcfg)(jnp.asarray(x), sr, block)), rtol=TRACK_RTOL)


def test_odd_sample_rate_44100_model_and_streaming():
    """At 44.1 kHz with block 441, the streaming step one frame at a time
    equals one call over every frame, and both equal JAX's; the user-facing
    StreamingSynth takes the odd block."""
    from ddsp_pytorch_tpu.streaming import init_stream_state as jax_init_stream_state

    raw = _raw(sr=44100, block=441)
    f = 8
    rng = np.random.default_rng(1)
    pitch = rng.uniform(150, 350, (1, f, 1)).astype(np.float32)
    loud = rng.standard_normal((1, f, 1)).astype(np.float32)
    jmodel, params, tmodel = _models(raw, {"pitch": pitch, "loudness": loud})
    noise = rng.uniform(-1, 1, (1, f, 441)).astype(np.float32)

    state0 = jax_init_stream_state(16, 1)
    want, _, _ = jmodel.apply({"params": params}, jnp.asarray(pitch), jnp.asarray(loud), state0.gru,
                              state0.phase, jnp.asarray(noise), method=jmodel.streaming_step)
    state = init_stream_state(16, 1, device="cpu")
    with torch.no_grad():
        offline, _, _ = tmodel.streaming_step(torch.tensor(pitch), torch.tensor(loud), state.gru, state.phase,
                                              torch.tensor(noise))
        gru, phase, outs = state.gru, state.phase, []
        for c in range(f):  # one frame at a time — the harshest chunking
            audio, gru, phase = tmodel.streaming_step(torch.tensor(pitch[:, c:c + 1]), torch.tensor(loud[:, c:c + 1]),
                                                      gru, phase, torch.tensor(noise[:, c:c + 1]))
            outs.append(audio)
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), offline.numpy(), atol=ATOL)
    np.testing.assert_allclose(offline.numpy(), np.asarray(want), atol=ATOL)

    synth = StreamingSynth(tmodel, batch=1, noise_deterministic=True, device="cpu")
    a = synth.step(pitch[:, :4], loud[:, :4])
    assert tuple(a.shape) == (1, 4 * 441) and bool(torch.isfinite(a).all())
