"""Training the mfcc-autoencoder with the port, against the JAX package, on
the CPU at a small width (hidden 32, 8 harmonics, 17 noise bands, 16 kHz,
block 256, 32 frames, scales [512, 256], reverb on), with transplanted
weights and the JAX step's noise injected.

Tolerances:
  * one float32 train step's loss against jax.value_and_grad of the JAX
    step: 5e-3 relative (measured 1.9e-5);
  * the same step in float64 against JAX's in float64 (scoped
    jax.enable_x64, as tests/test_torch_training.py does for the decoder):
    the loss and every gradient leaf within 1e-6 relative L2 error.  This
    is the gradient parity check.  In float32 the AE's gradient at fresh
    weights is ill-conditioned (the loss's log term differentiates to
    1/(S + 1e-7) on near-silent STFT bins): measured against the float64
    step, the JAX package's float32 gradient is 10.2 % off as a whole (its
    worst leaf 39 %), the port's 3.4 % (20 %), so two float32 steps cannot
    agree leaf by leaf at 5e-3.  The float32 test holds the port's float32
    gradient to the float64 step at least as closely as the JAX package's
    float32 gradient is held (the port sums the frame phases in float64,
    tests/test_torch_oscillator.py);
  * the loaders' batches and MultiStep against eager steps: bit for bit
    (one process, the CPU);
  * a resumed fit against an uninterrupted one: bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.data.dataset import DataLoader as JaxDataLoader
from ddsp_pytorch_tpu.data.dataset import Dataset as JaxDataset
from ddsp_pytorch_tpu.data.dataset import DeviceDataLoader as JaxDeviceDataLoader
from ddsp_pytorch_tpu.models.encoder import DDSPAutoencoder as JaxAutoencoder
from ddsp_pytorch_tpu.training.loss import spectral_loss_from_signals as jax_loss
from ddsp_pytorch_tpu.training.train import _normalize_loudness
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import DataLoader, Datamodule, Dataset, DeviceDataLoader, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder, init_params
from ddsp_pytorch_tpu_torch.ops.spectral import mfcc
from ddsp_pytorch_tpu_torch.training import Trainer, make_optimizer, make_train_step
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.state import TrainState
from ddsp_pytorch_tpu_torch.training.train import (
    loss_and_grads,
    make_train_multi_step,
    make_train_multi_step_indexed,
)
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict, state_dict_to_flax
from tests.test_torch_training import _leaves, _Widened

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SR, BLOCK, F, B = 16000, 256, 32, 2
N_MFCC, MFCC_N_FFT = 30, 512  # n_fft ≤ 2·hop, so a bundle of this run can stream
KW = dict(hidden_size=32, n_harmonic=8, n_bands=17, sample_rate=SR, block_size=BLOCK, has_reverb=True)
SCALES = [512, 256]
MEAN, STD = -6.0, 1.1
F32_REL, F64_REL = 5e-3, 1e-6  # the loss in float32; loss and leaves in float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    """A batch of 2 harmonic notes with a noise floor, their MFCCs (the
    model's F frames of the F + 1 a centered STFT gives) and random
    controls."""
    rng = np.random.default_rng(seed)
    t = np.arange(F * BLOCK) / SR
    f0 = rng.uniform(150, 350, (B, 1))
    sig = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 5))
    sig = (sig + 0.01 * rng.standard_normal((B, t.size))).astype(np.float32)
    mf = mfcc(torch.tensor(sig), SR, n_mfcc=N_MFCC, n_fft=MFCC_N_FFT, hop_length=BLOCK, ref_db=0.0)
    return {
        "pitch": np.repeat(f0, F, axis=1)[..., None].astype(np.float32),
        "loudness": (rng.standard_normal((B, F, 1)) - 6.0).astype(np.float32),
        "mfcc": mf[:, :-1].numpy(),
        "sig": sig,
    }


@pytest.fixture(scope="module")
def setup():
    batch = _batch()
    jmodel = JaxAutoencoder(**KW, use_pallas="never")
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in batch.items()},
    )["params"]
    return jmodel, jax.tree.map(np.asarray, params), batch


def _jax_loss_and_grads(jmodel, params, batch, noise_rng):
    """The JAX step's loss and gradients (train.py:119-131), and the noise
    its FilteredNoise draws under noise_rng (the noise_synth scope's first
    draw, as models/modules.py:113-127 describes)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, _normalize_loudness(jbatch, MEAN, STD), rngs={"noise": noise_rng})
        return jax_loss(jbatch["sig"], out["signal"], SCALES, 0.75)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    noise = jmodel.apply({"params": params}, method=lambda m: m.noise_synth.sample(B, F),
                         rngs={"noise": noise_rng})
    return float(loss), dict(_leaves(jax.tree.map(np.asarray, grads))), np.asarray(noise)


def _port_loss_and_grads(model, batch, noise):
    loss, grads = loss_and_grads(model, {k: torch.tensor(v) for k, v in batch.items()}, MEAN, STD,
                                 SCALES, 0.75, noise=torch.tensor(noise))
    names = [n for n, _ in model.named_parameters()]
    return loss, dict(_leaves(state_dict_to_flax(dict(zip(names, grads)))))


def _leaf_errors(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    errors = {}
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
        errors[name] = float(np.linalg.norm(got[name] - w) / np.linalg.norm(w))
    return errors


def _whole_error(got: dict, want: dict) -> float:
    a = np.concatenate([got[n].ravel() for n in sorted(want)])
    b = np.concatenate([want[n].ravel() for n in sorted(want)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_train_step_matches_jax(setup):
    """One float32 AE step: the port's loss_and_grads (what make_train_step
    runs) against jax.value_and_grad of the JAX step's loss; both sides'
    gradients, every encoder, decoder and synth leaf, against the port's
    float64 step on the same weights, batch and noise."""
    jmodel, params, batch = setup
    _, noise_rng = jax.random.split(jax.random.PRNGKey(3))
    want_loss, want, noise = _jax_loss_and_grads(jmodel, params, batch, noise_rng)
    model = DDSPAutoencoder(**KW)
    model.load_state_dict(flax_to_state_dict(params))
    loss, got = _port_loss_and_grads(model, batch, noise)
    assert any(name.startswith("encoder.") for name in got)
    np.testing.assert_allclose(float(loss), want_loss, rtol=F32_REL)
    model.double()
    _, ref = _port_loss_and_grads(model, {k: v.astype(np.float64) for k, v in batch.items()},
                                  noise.astype(np.float64))
    port_err, jax_err = _whole_error(got, ref), _whole_error(want, ref)
    assert port_err <= jax_err, f"port f32 gradient {port_err:.3e} from f64, JAX's {jax_err:.3e}"
    port_leaf, jax_leaf = _leaf_errors(got, ref), _leaf_errors(want, ref)
    assert max(port_leaf.values()) <= max(jax_leaf.values())


@pytest.fixture
def jax_float64(monkeypatch):
    """The JAX step in float64 for this test only: x64 on as a context, and
    the modules on the AE step's path that pin float32 by name (those of
    tests/test_torch_training.py's fixture, plus the encoder's f0 cast,
    models/encoder.py:103) see `jnp` with those names bound to the 64-bit
    types."""
    import ddsp_pytorch_tpu.models.decoder as jax_decoder
    import ddsp_pytorch_tpu.models.encoder as jax_encoder
    import ddsp_pytorch_tpu.models.modules as jax_modules
    import ddsp_pytorch_tpu.ops.filters as jax_filters
    import ddsp_pytorch_tpu.training.loss as jax_loss_module

    for module in (jax_decoder, jax_encoder, jax_modules, jax_filters, jax_loss_module):
        monkeypatch.setattr(module, "jnp", _Widened())
    with jax.enable_x64(True):
        yield


def test_float64_step_matches_jax_float64(setup, jax_float64):
    """The port's AE step in float64 on the CPU (`model.double()`) against
    the JAX AE step in float64, from the same weights, batch and noise."""
    _, params, batch = setup
    params64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    batch64 = {k: v.astype(np.float64) for k, v in batch.items()}
    jmodel = JaxAutoencoder(**KW, dtype=jnp.float64, use_pallas="never")
    _, noise_rng = jax.random.split(jax.random.PRNGKey(3))
    want_loss, want, noise = _jax_loss_and_grads(jmodel, params64, batch64, noise_rng)
    assert noise.dtype == np.float64 and all(w.dtype == np.float64 for w in want.values())
    model = DDSPAutoencoder(**KW)
    model.load_state_dict(flax_to_state_dict(params))
    model.double()
    loss, got = _port_loss_and_grads(model, batch64, noise)
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss), want_loss, rtol=F64_REL)
    errors = _leaf_errors(got, want)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= F64_REL, f"{worst}: relative L2 error {errors[worst]:.3e} > {F64_REL}"


# ------------------------------------------------------------ the data path


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A tiny AE cache from the port's synthetic corpus: 4 violin notes of
    16384 samples a partition, MFCCs at the fixed 0 dB reference."""
    path = str(tmp_path_factory.mktemp("ae_cache"))
    make_synthetic_dataset(path, n_items=4, sample_rate=SR, signal_length=16384, block_size=BLOCK,
                           n_harmonic=8, instrument="violin", mfcc_n_fft=MFCC_N_FFT, mfcc_ref_db=0.0,
                           device="cpu")
    return path


def test_loaders_carry_mfcc(cache):
    """Dataset, DataLoader and DeviceDataLoader give `mfcc` of F frames (the
    cache's F + 1 less the last), as the JAX loaders do, in the same order;
    the device loader's gathers and HostBatchStager's keys carry it."""
    train = os.path.join(cache, "train")
    ds = Dataset(train)
    frames = ds.pitchs.shape[1]
    assert ds.mfccs.shape == (4, frames + 1, N_MFCC)
    item = ds[1]
    assert item["mfcc"].shape == (frames, N_MFCC)
    np.testing.assert_array_equal(item["mfcc"], JaxDataset(train)[1]["mfcc"])
    port = DataLoader(ds, 2, shuffle=True, drop_last=True, seed=5)
    ref = JaxDataLoader(JaxDataset(train), 2, shuffle=True, drop_last=True, seed=5)
    dev = DeviceDataLoader(ds, 2, shuffle=True, drop_last=True, seed=5, device="cpu")
    jdev = JaxDeviceDataLoader(JaxDataset(train), 2, shuffle=True, drop_last=True, seed=5)
    assert dev.device_data["mfcc"].shape == (4, frames, N_MFCC)
    np.testing.assert_array_equal(dev.device_data["mfcc"].numpy(), np.asarray(jdev.device_data["mfcc"]))
    for epoch in range(2):
        for loader in (port, ref, dev):
            loader.set_epoch(epoch)
        for a, b, c in zip(port, ref, dev):
            assert sorted(a) == sorted(b) == sorted(c) == ["loudness", "mfcc", "pitch", "sig"]
            assert a["mfcc"].shape == (2, frames, N_MFCC)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(c[k].numpy(), a[k])
    idx2d = np.stack(list(dev.index_batches()))
    stacked = dev.take_stacked(idx2d)
    assert stacked["mfcc"].shape == (idx2d.shape[0], 2, frames, N_MFCC)


def _ae_config(cache, **train):
    return Config.from_dict({
        "preprocess": {"sample_rate": SR, "signal_length": 16384, "block_size": BLOCK, "out_dir": cache,
                       "mfcc_n_fft": MFCC_N_FFT, "mfcc_ref_db": 0.0},
        "model": {"name": "mfcc-autoencoder", "kwargs": dict(KW)},
        "train": {"scales": SCALES, "overlap": 0.75, "batch": 2, "lr": 1e-3,
                  "checkpoint_every_steps": 10, "val_interval_epochs": 5, "log_interval_epochs": 5,
                  **train},
    })


@pytest.mark.parametrize("indexed", [False, True], ids=["stacked", "indexed"])
def test_multi_step_with_mfcc_equals_eager_steps(cache, indexed):
    """MultiStep on the CPU, with mfcc in the stacked super-batch or
    gathered from the device-resident cache, trains bit for bit what as many
    eager steps train, the noise drawn from the same generator."""
    cfg = _ae_config(cache)
    ds = Dataset(os.path.join(cache, "train"))
    loader = DeviceDataLoader(ds, 2, shuffle=True, drop_last=True, seed=0, device="cpu")
    idx2d = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        idx2d += list(loader.index_batches())
    idx2d = np.stack(idx2d)
    base = init_params(DDSPAutoencoder(**KW), torch.Generator().manual_seed(0))

    def fresh():
        model = DDSPAutoencoder(**KW)
        model.load_state_dict(base.state_dict())
        tx = make_optimizer(cfg)
        state = TrainState(0, model, tx.init([p for _, p in model.named_parameters()]),
                           torch.Generator().manual_seed(7), MEAN, STD)
        return model, tx, state

    model_e, tx_e, state_e = fresh()
    step = make_train_step(model_e, tx_e, cfg)
    eager = [float(step(state_e, loader.take(idx))["loss"]) for idx in idx2d]

    model_g, tx_g, state_g = fresh()
    n = idx2d.shape[0]
    if indexed:
        rows = make_train_multi_step_indexed(model_g, tx_g, cfg, n)(state_g, loader.device_data, idx2d)
    else:
        rows = make_train_multi_step(model_g, tx_g, cfg, n)(state_g, loader.take_stacked(idx2d))
    assert state_g.step == state_e.step == n
    assert rows[:, 0].tolist() == eager
    for (name, a), b in zip(model_g.named_parameters(), model_e.parameters()):
        assert torch.equal(a, b), name
    assert torch.equal(state_g.generator.get_state(), state_e.generator.get_state())


def test_trainer_fit_reduces_loss_and_resumes(cache, tmp_path):
    """Trainer.fit on the tiny AE cache: every loss finite, the loss falls;
    a run of 8 steps equals 4 + 4 with a resume, bit for bit."""
    cfg = _ae_config(cache, steps=40, steps_per_call=4)
    dm = Datamodule(cfg, device_cache=True, device="cpu")
    dm.setup()
    trainer = Trainer(cfg, str(tmp_path / "fit"), device="cpu", use_tensorboard=False)
    state = trainer.fit(dm)
    trainer.close()
    losses = [v for _, v in read_metrics(str(tmp_path / "fit"), "loss")]
    assert state.step == 40 and len(losses) == 40 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])
    assert read_metrics(str(tmp_path / "fit"), "loss/val")

    def run(name, totals):
        for total in totals:
            c = _ae_config(cache, steps=8, checkpoint_every_steps=100)
            d = Datamodule(c)
            d.setup()
            t = Trainer(c, str(tmp_path / name), device="cpu", use_tensorboard=False)
            s = t.fit(d, total_steps=total)
            t.close()
        return s

    a, b = run("straight", [8]), run("resumed", [4, 8])
    assert a.step == b.step == 8
    for (k, va), (_, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(va, vb), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert read_metrics(str(tmp_path / "straight"), "loss") == read_metrics(str(tmp_path / "resumed"), "loss")
