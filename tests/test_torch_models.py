"""The port's models against the flax ones, with transplanted weights and
injected noise, at a small width (hidden 32, 8 harmonics, 9 noise bands,
block 64, 16 kHz).

Tolerance 1e-4 absolute on every output: the same f32 arithmetic, with
matmuls, FFTs and transcendentals from other libraries and XLA's CPU cumsum
(an associative scan) for the frame phases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.models.decoder import MLP as JaxMLP
from ddsp_pytorch_tpu.models.decoder import DDSPDecoder as JaxDecoder
from ddsp_pytorch_tpu.models.modules import Reverb as JaxReverb
from ddsp_pytorch_tpu.streaming import init_stream_state
from ddsp_pytorch_tpu_torch.models import DDSPDecoder, load_model
from ddsp_pytorch_tpu_torch.models.decoder import MLP
from ddsp_pytorch_tpu_torch.models.modules import Reverb
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KW = dict(hidden_size=32, n_harmonic=8, n_bands=9, sample_rate=16000, block_size=64, has_reverb=True)
F = 32
ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    batch = {
        "pitch": rng.uniform(150, 350, (2, F, 1)).astype(np.float32),
        "loudness": rng.standard_normal((2, F, 1)).astype(np.float32),
    }
    jmodel = JaxDecoder(**KW, use_pallas="never")
    params = jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jax.tree.map(jnp.asarray, batch),
    )["params"]
    # reverb params away from their init, so the decay and wet paths matter
    params = dict(params)
    params["reverb"] = {
        "noise": params["reverb"]["noise"],
        "decay": jnp.asarray(1.3, jnp.float32),
        "wet": jnp.asarray(-0.7, jnp.float32),
    }
    tmodel = DDSPDecoder(**KW)
    tmodel.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return jmodel, params, tmodel.eval(), batch


def _compare(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _compare(got[k], want[k], f"{path}.{k}")
        return
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, path
    np.testing.assert_allclose(got, want, atol=ATOL, err_msg=path)


def test_forward_every_output_key(models):
    jmodel, params, tmodel, batch = models
    key = jax.random.PRNGKey(5)
    jbatch = jax.tree.map(jnp.asarray, batch)
    want = jmodel.apply({"params": params}, jbatch, rngs={"noise": key})
    noise = jmodel.apply(
        {"params": params}, jbatch["pitch"], method=jmodel.sample_noise, rngs={"noise": key}
    )
    with torch.no_grad():
        got = tmodel({k: torch.tensor(v) for k, v in batch.items()}, noise=torch.tensor(np.asarray(noise)))
    _compare(got, want)


def test_streaming_steps_chained(models):
    """4 chained streaming_steps of 8 frames: audio, GRU carry and phase."""
    jmodel, params, tmodel, batch = models
    rng = np.random.default_rng(1)
    state = init_stream_state(KW["hidden_size"], 2)
    j_gru, j_phase = state.gru, state.phase
    t_gru, t_phase = torch.zeros(2, KW["hidden_size"]), torch.zeros(2)
    for c in range(4):
        sl = slice(8 * c, 8 * (c + 1))
        noise = rng.uniform(-1, 1, (2, 8, KW["block_size"])).astype(np.float32)
        j_audio, j_gru, j_phase = jmodel.apply(
            {"params": params},
            jnp.asarray(batch["pitch"][:, sl]),
            jnp.asarray(batch["loudness"][:, sl]),
            j_gru,
            j_phase,
            jnp.asarray(noise),
            method=jmodel.streaming_step,
        )
        with torch.no_grad():
            t_audio, t_gru, t_phase = tmodel.streaming_step(
                torch.tensor(batch["pitch"][:, sl]),
                torch.tensor(batch["loudness"][:, sl]),
                t_gru,
                t_phase,
                torch.tensor(noise),
            )
        np.testing.assert_allclose(t_audio.numpy(), np.asarray(j_audio), atol=ATOL)
        np.testing.assert_allclose(t_gru.numpy(), np.asarray(j_gru), atol=ATOL)
        d = np.abs(t_phase.numpy() - np.asarray(j_phase))
        assert np.minimum(d, 2 * np.pi - d).max() < ATOL


@pytest.mark.parametrize("t", [200, 300, 1000], ids=["truncated-ir", "equal", "padded-ir"])
def test_reverb(t):
    """Reverb at a short IR length (300 samples), on signals shorter than,
    as long as and longer than the IR."""
    rng = np.random.default_rng(2)
    jrev = JaxReverb(300, 16000)
    params = {
        "noise": jnp.asarray(rng.uniform(-1, 1, 300).astype(np.float32)),
        "decay": jnp.asarray(2.0, jnp.float32),
        "wet": jnp.asarray(0.5, jnp.float32),
    }
    x = rng.uniform(-1, 1, (2, t)).astype(np.float32)
    want = jrev.apply({"params": params}, jnp.asarray(x))
    trev = Reverb(300, 16000)
    trev.load_state_dict(flax_to_state_dict(_np_tree(params)))
    with torch.no_grad():
        got = trev(torch.tensor(x))
        np.testing.assert_allclose(
            trev.build_impulse().numpy(),
            np.asarray(jrev.apply({"params": params}, method=jrev.build_impulse)),
            atol=1e-6,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mlp_layer_norm_epsilon():
    """Inputs of tiny variance, where LayerNorm's ε dominates: the port
    must use flax's 1e-6, not PyTorch's 1e-5 default."""
    rng = np.random.default_rng(3)
    x = (1e-4 * rng.standard_normal((4, 1))).astype(np.float32)
    jmlp = JaxMLP(16)
    params = _np_tree(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    # Dense_0 keeps its zero bias, so LayerNorm_0's input has variance ~1e-8;
    # nonzero later biases keep the scale LayerNorm_0 gives it from being
    # normalized away
    for i in (1, 2):
        params[f"Dense_{i}"]["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)
    want = jmlp.apply({"params": params}, jnp.asarray(x))
    tmlp = MLP(1, 16)
    tmlp.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = tmlp(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_load_model_registry():
    model = load_model("single-inst-decoder", dict(KW, use_pallas="auto"))
    assert isinstance(model, DDSPDecoder) and model.has_reverb
    for name in ("mfcc-autoencoder", "no-such-model"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            load_model(name, {})
