"""The port's LongFormSynthesizer against the JAX package's and against the
unsharded model, on the CPU (tests/test_longform.py's setup: hidden 32, 8
harmonics, 9 bands, 16 kHz, block 64, 4 voices × 128 frames, a 1 s reverb
over the whole signal): the same weights (transplanted from the flax
init), controls and noise (JAX's draw, injected) through an in-process
(data 2, time 4) mesh, within JAX's atol 2e-3 (:55-92).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.models import load_model as jax_load_model
from ddsp_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from ddsp_pytorch_tpu.parallel.longform import LongFormSynthesizer as JaxLongForm
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.parallel import LongFormSynthesizer, make_mesh
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) JAX devices")

B, F, BLOCK = 4, 128, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(autoencoder: bool, has_reverb: bool, seed: int):
    raw = {"preprocess": {"sample_rate": 16000, "signal_length": F * BLOCK, "block_size": BLOCK},
           "model": {"name": "mfcc-autoencoder" if autoencoder else "single-inst-decoder", "kwargs": {
               "hidden_size": 32, "n_harmonic": 8, "n_bands": 9, "sample_rate": 16000,
               "block_size": BLOCK, "has_reverb": has_reverb, "use_pallas": "never"}}}
    jmodel = jax_load_model(JaxConfig.from_dict(raw))
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(150, 350, (B, F, 1)).astype(np.float32)
    loud = rng.standard_normal((B, F, 1)).astype(np.float32)
    mfcc = rng.standard_normal((B, F, 30)).astype(np.float32) if autoencoder else None
    init_batch = {"sig": jnp.zeros((B, F * BLOCK)), "pitch": jnp.asarray(f0), "loudness": jnp.asarray(loud)}
    if autoencoder:
        init_batch["mfcc"] = jnp.asarray(mfcc)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                         init_batch)["params"]
    model = load_model(raw["model"]["name"], raw["model"]["kwargs"])
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return jmodel, params, model, f0, loud, mfcc


@pytest.mark.parametrize("autoencoder,has_reverb", [(False, True), (True, False), (True, True)],
                         ids=["decoder-reverb", "autoencoder", "autoencoder-reverb"])
def test_longform_matches_jax_and_unsharded(autoencoder, has_reverb):
    jmodel, params, model, f0, loud, mfcc = _setup(autoencoder, has_reverb, seed=3 if autoencoder else 0)
    key = jax.random.PRNGKey(7)
    jlf = JaxLongForm(jmodel, params, jax_make_mesh(data=2, time=4), use_pallas="never")
    jmfcc = None if mfcc is None else jnp.asarray(mfcc)
    want_jax = np.asarray(jlf.synthesize(jnp.asarray(f0), jnp.asarray(loud), jmfcc, rng=key))
    # the JAX long-form draw: partitionable threefry equals this unsharded draw
    noise = np.asarray(jax.random.uniform(key, (B, F, BLOCK), jnp.float32) * 2.0 - 1.0)

    t = {"f0": torch.tensor(f0), "loud": torch.tensor(loud), "noise": torch.tensor(noise)}
    tmfcc = None if mfcc is None else torch.tensor(mfcc)
    got = LongFormSynthesizer(model, make_mesh(2, 4)).synthesize(t["f0"], t["loud"], tmfcc, noise=t["noise"])
    batch = {"pitch": t["f0"], "loudness": t["loud"]}
    if autoencoder:
        batch["mfcc"] = tmfcc
    with torch.no_grad():
        want = model(batch, noise=t["noise"])["signal"]
    assert got.shape == (B, F * BLOCK)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)


def test_longform_draws_the_unsharded_noise_and_checks_its_inputs():
    """Without injected noise an in-process mesh draws what the unsharded
    model draws from the same generator; the autoencoder needs mfcc; the
    frames must divide over the time axis."""
    _, _, model, f0, loud, _ = _setup(False, True, seed=0)
    f0, loud = torch.tensor(f0), torch.tensor(loud)
    got = LongFormSynthesizer(model, make_mesh(1, 8)).synthesize(
        f0, loud, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = model({"pitch": f0, "loudness": loud}, generator=torch.Generator().manual_seed(5))["signal"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)
    dry = LongFormSynthesizer(model, make_mesh(2, 4), include_reverb=False).synthesize(
        f0, loud, noise=torch.zeros(B, F, BLOCK))
    with torch.no_grad():
        ctrls, _ = model.frame_controls(f0, loud)
    harmonic = model.harmonic_synth(**ctrls)
    np.testing.assert_allclose(dry.numpy(), harmonic.numpy(), atol=2e-4)
    with pytest.raises(ValueError, match="divide"):
        LongFormSynthesizer(model, make_mesh(1, 3)).synthesize(f0, loud, noise=torch.zeros(B, F, BLOCK))
    _, _, ae, f0a, louda, _ = _setup(True, False, seed=3)
    with pytest.raises(ValueError, match="mfcc"):
        LongFormSynthesizer(ae, make_mesh(2, 4)).synthesize(torch.tensor(f0a), torch.tensor(louda))
