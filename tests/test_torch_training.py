"""The port's training path against the JAX package's, on the CPU at a small
width (hidden 32, 8 harmonics, 9 noise bands, 16 kHz, block 64, 32 frames,
scales [512, 256], reverb on), with transplanted weights and injected noise.

Tolerances:
  * one train step's loss against jax.value_and_grad: 1e-5 relative;
  * its gradients: the whole gradient (every leaf, concatenated) within 1e-2
    relative L2 error, and each leaf within 0.1.  The loss is ill-
    conditioned in f32 at init: its log-magnitude term differentiates to
    1/(S + 1e-7) on the near-silent bins of the reconstruction, so f32
    rounding there is magnified ~10⁴-fold (a 1e-6 relative change of the
    injected noise moves the port's own gradients by 0.1–0.6 %), and XLA's
    associative cumsum moves the frame phases by up to 6e-5 rad against
    PyTorch's sequential one (tests/test_torch_oscillator.py).  Measured
    here: whole-gradient error 5.1e-3, worst leaf 7.3e-2;
  * the port's optimizers against optax from identical gradients, 5 steps:
    1e-6 relative (the same formulas in f32);
  * NaN guard and exact resume: bit for bit (one process, the CPU).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddsp_pytorch_tpu.config import Config as JaxConfig
from ddsp_pytorch_tpu.data import make_synthetic_dataset
from ddsp_pytorch_tpu.data.dataset import DataLoader as JaxDataLoader
from ddsp_pytorch_tpu.data.dataset import Dataset as JaxDataset
from ddsp_pytorch_tpu.models.decoder import DDSPDecoder as JaxDecoder
from ddsp_pytorch_tpu.training.state import TrainState as JaxTrainState
from ddsp_pytorch_tpu.training.train import make_optimizer as jax_make_optimizer
from ddsp_pytorch_tpu.training.train import make_train_step as jax_make_train_step
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import DataLoader, Datamodule, Dataset
from ddsp_pytorch_tpu_torch.models import DDSPDecoder, init_params
from ddsp_pytorch_tpu_torch.training import Trainer, make_optimizer, make_train_step
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.state import TrainState
from ddsp_pytorch_tpu_torch.training.train import loss_and_grads
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict, state_dict_to_flax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KW = dict(hidden_size=32, n_harmonic=8, n_bands=9, sample_rate=16000, block_size=64, has_reverb=True)
F, B = 32, 2
SCALES = [512, 256]
GRAD_REL, LEAF_REL = 1e-2, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on shared cores, where torch's default of one thread per core
    oversubscribes them (results here do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_grads_close(got: dict, want: dict):
    """Relative L2 errors of the whole gradient and of each leaf."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
        err = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
        assert err <= LEAF_REL, f"{name}: relative L2 error {err:.3e} > {LEAF_REL}"
    a = np.concatenate([got[n].ravel() for n in sorted(want)])
    b = np.concatenate([want[n].ravel() for n in sorted(want)])
    err = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert err <= GRAD_REL, f"whole gradient: relative L2 error {err:.3e} > {GRAD_REL}"


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(tree[k])


def _cfg(**train):
    raw = {
        "model": {"name": "single-inst-decoder", "kwargs": dict(KW)},
        "train": {"scales": SCALES, "overlap": 0.75, "batch": B, "lr": 1e-3, **train},
    }
    return Config.from_dict(raw), JaxConfig.from_dict(raw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    t = np.arange(F * KW["block_size"]) / KW["sample_rate"]
    batch = {
        "pitch": rng.uniform(150, 350, (B, F, 1)).astype(np.float32),
        "loudness": (rng.standard_normal((B, F, 1)) - 6.0).astype(np.float32),
        "sig": (0.3 * np.sin(2 * np.pi * 220.0 * t)[None] + 0.02 * rng.standard_normal((B, t.size))).astype(
            np.float32
        ),
    }
    jmodel = JaxDecoder(**KW)
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in batch.items()},
    )["params"]
    params = jax.tree.map(np.asarray, params)
    return jmodel, params, batch


def _jax_state(params, tx, mean, std, seed=3):
    return JaxTrainState(
        step=jnp.asarray(0, jnp.int32),
        params=jax.tree.map(jnp.asarray, params),
        opt_state=tx.init(jax.tree.map(jnp.asarray, params)),
        rng=jax.random.PRNGKey(seed),
        mean_loudness=jnp.asarray(mean, jnp.float32),
        std_loudness=jnp.asarray(std, jnp.float32),
    )


def _port_state(params, tx, mean, std):
    model = DDSPDecoder(**KW)
    model.load_state_dict(flax_to_state_dict(params))
    return TrainState(
        step=0, model=model, opt_state=tx.init([p for _, p in model.named_parameters()]),
        generator=torch.Generator().manual_seed(0), mean_loudness=mean, std_loudness=std,
    )


def _noise_of_jax_step(jmodel, params, rng_key, pitch):
    """The draw the JAX train step makes: FilteredNoise.sample under the
    noise_rng half of jax.random.split(state.rng) (train.py:117)."""
    _, noise_rng = jax.random.split(rng_key)
    return np.asarray(jmodel.apply({"params": params}, jnp.asarray(pitch),
                                   method=jmodel.sample_noise, rngs={"noise": noise_rng}))


def test_train_step_loss_and_gradients_match_jax(setup):
    """One step of the port's loss_and_grads (what make_train_step runs)
    against jax.value_and_grad of the JAX step's loss_fn."""
    from ddsp_pytorch_tpu.training.loss import spectral_loss_from_signals as jax_loss
    from ddsp_pytorch_tpu.training.train import _normalize_loudness

    jmodel, params, batch = setup
    mean, std = -6.0, 1.1
    key = jax.random.PRNGKey(3)
    _, noise_rng = jax.random.split(key)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, _normalize_loudness(jbatch, mean, std), rngs={"noise": noise_rng})
        return jax_loss(jbatch["sig"], out["signal"], SCALES, 0.75)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    noise = _noise_of_jax_step(jmodel, params, key, batch["pitch"])
    tx = make_optimizer(_cfg()[0])
    state = _port_state(params, tx, mean, std)
    loss, grads = loss_and_grads(
        state.model, {k: torch.tensor(v) for k, v in batch.items()}, mean, std, SCALES, 0.75,
        noise=torch.tensor(noise),
    )
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    names = [n for n, _ in state.model.named_parameters()]
    got = dict(_leaves(state_dict_to_flax(dict(zip(names, grads)))))
    _assert_grads_close(got, dict(_leaves(jax.tree.map(np.asarray, want_grads))))


def test_train_step_matches_jax_make_train_step(setup):
    """make_train_step with SGD against the JAX make_train_step: the same
    loss, and every parameter moved by −lr·grad, the moves compared at the
    gradient tolerance; metrics and the step counter as in the JAX step."""
    jmodel, params, batch = setup
    cfg, jcfg = _cfg(optimizer="sgd", lr=0.5)
    jtx = jax_make_optimizer(jcfg)
    jstate = _jax_state(params, jtx, -6.0, 1.1)
    noise = _noise_of_jax_step(jmodel, params, jstate.rng, batch["pitch"])
    jnew, jmetrics = jax.jit(jax_make_train_step(jmodel, jtx, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    tx = make_optimizer(cfg)
    state = _port_state(params, tx, -6.0, 1.1)
    metrics = make_train_step(state.model, tx, cfg)(
        state, {k: torch.tensor(v) for k, v in batch.items()}, noise=torch.tensor(noise)
    )
    assert state.step == int(jnew.step) == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]), rtol=GRAD_REL)
    assert int(metrics["update_skipped"]) == int(jmetrics["update_skipped"]) == 0
    before = dict(_leaves(params))
    got = dict(_leaves(state_dict_to_flax(state.model.state_dict())))
    want = dict(_leaves(jax.tree.map(np.asarray, jnew.params)))
    _assert_grads_close(
        {k: v.astype(np.float64) - before[k] for k, v in got.items()},
        {k: v.astype(np.float64) - before[k] for k, v in want.items()},
    )


def _random_grads(rng, params):
    return jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, params)


@pytest.mark.parametrize(
    "train",
    [
        {},
        {"optimizer": "sgd", "lr": 0.1},
        {"grad_clip_norm": 0.5},
        {"grad_clip_norm": 1e6},
        {"lr_stop": 1e-4, "lr_decay_steps": 3},
        {"optimizer": "sgd", "lr_stop": 0.0, "lr_decay_steps": 4, "grad_clip_norm": 1.0},
    ],
    ids=["adam", "sgd", "adam-clip", "adam-no-clip", "adam-schedule", "sgd-schedule-clip"],
)
def test_optimizer_matches_optax(setup, train):
    """Identical gradients into the port's optimizer and optax's, 5 steps."""
    _, params, _ = setup
    cfg, jcfg = _cfg(**train)
    jtx = jax_make_optimizer(jcfg)
    tx = make_optimizer(cfg)
    names = [n for n, _ in _leaves(params)]
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = jtx.init(jparams)
    tparams = [torch.tensor(v) for _, v in _leaves(params)]
    topt = tx.init(tparams)
    rng = np.random.default_rng(1)

    @jax.jit
    def jax_step(g, opt, p):
        upd, opt = jtx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt

    for _ in range(5):
        g = _random_grads(rng, params)
        jparams, jopt = jax_step(jax.tree.map(jnp.asarray, g), jopt, jparams)
        tupd, topt = tx.update([torch.tensor(v) for _, v in _leaves(g)], topt)
        tparams = [p + u for p, u in zip(tparams, tupd)]
    for name, (_, w), t in zip(names, _leaves(jax.tree.map(np.asarray, jparams)), tparams):
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=name)


def test_nan_guard_leaves_params_and_optimizer_state(setup):
    """A non-finite loss skips the update: parameters and Adam's state,
    count included, stay bit for bit; the step advances."""
    _, params, batch = setup
    cfg, _ = _cfg()
    tx = make_optimizer(cfg)
    state = _port_state(params, tx, -6.0, 1.1)
    step = make_train_step(state.model, tx, cfg)
    good = {k: torch.tensor(v) for k, v in batch.items()}
    assert int(step(state, good)["update_skipped"]) == 0
    snap_params = {k: v.clone() for k, v in state.model.state_dict().items()}
    snap_opt = jax.tree.map(lambda t: t.clone(), state.opt_state)
    bad = dict(good)
    bad["sig"] = good["sig"].clone()
    bad["sig"][0, 5] = float("nan")
    metrics = step(state, bad)
    assert not np.isfinite(float(metrics["loss"]))
    assert int(metrics["update_skipped"]) == 1 and state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snap_params[k]), k
    assert int(state.opt_state["count"]) == int(snap_opt["count"]) == 1
    for a, b in zip(jax.tree.leaves(state.opt_state), jax.tree.leaves(snap_opt)):
        assert torch.equal(a, b)


def test_init_params_distributions():
    """init_params draws flax's initializers (models/decoder.py:68-72,
    modules.py:157-167); compared in distribution with flax's own init."""
    kw = dict(KW, hidden_size=128)
    model = init_params(DDSPDecoder(**kw), torch.Generator().manual_seed(0))
    jparams = jax.jit(JaxDecoder(**kw).init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        {"pitch": jnp.full((1, 4, 1), 200.0), "loudness": jnp.zeros((1, 4, 1))},
    )["params"]
    got = dict(_leaves(state_dict_to_flax(model.state_dict())))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("bias", "b_ih", "b_hh", "decay", "wet") or (leaf == "scale"):
            np.testing.assert_array_equal(g, w, err_msg=name)  # constants
        elif leaf == "kernel":
            std = 1.0 / np.sqrt(w.shape[0])
            assert np.abs(g).max() <= 2 * std / 0.8796256610342398 + 1e-6, name
            if g.size >= 1000:
                np.testing.assert_allclose(g.std(), std, rtol=0.1, err_msg=name)
                np.testing.assert_allclose(g.std(), w.std(), rtol=0.1, err_msg=name)
        elif leaf == "w_ih":
            limit = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            assert np.abs(g).max() <= limit and np.abs(w).max() <= limit
            np.testing.assert_allclose(g.std(), limit / np.sqrt(3), rtol=0.05)
        elif leaf == "w_hh":  # (H, 3H): orthonormal rows, as flax's
            h = w.shape[0]
            np.testing.assert_allclose(g @ g.T, np.eye(h), atol=1e-5)
            np.testing.assert_allclose(w @ w.T, np.eye(h), atol=1e-5)
        elif leaf == "noise":
            assert g.min() >= -1 and g.max() <= 1
            np.testing.assert_allclose(g.std(), 1 / np.sqrt(3), rtol=0.05)
        else:
            raise AssertionError(f"unchecked leaf {name}")
    assert float(model.reverb.decay.detach()) == 5.0 and float(model.reverb.wet.detach()) == 0.0


def test_state_dict_to_flax_round_trip(setup):
    _, params, _ = setup
    sd = flax_to_state_dict(params)
    back = state_dict_to_flax(sd)
    got, want = dict(_leaves(back)), dict(_leaves(params))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    model = DDSPDecoder(**KW)
    model.load_state_dict(sd)
    again = flax_to_state_dict(state_dict_to_flax(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k
    with pytest.raises(KeyError):
        state_dict_to_flax({"x.mystery": torch.zeros(1)})


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache"))
    make_synthetic_dataset(path, n_items=4, sample_rate=16000, signal_length=8192, block_size=256, n_harmonic=8)
    return path


def test_dataloader_order_matches_jax(cache):
    for shuffle, drop_last, batch in ((True, True, 2), (False, False, 3), (True, False, 3)):
        port = DataLoader(Dataset(os.path.join(cache, "train")), batch, shuffle, drop_last, seed=5)
        ref = JaxDataLoader(JaxDataset(os.path.join(cache, "train")), batch, shuffle, drop_last, seed=5)
        assert len(port) == len(ref)
        for epoch in range(3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                # the mfccs the autoencoder reads are not loaded by the port
                assert sorted(a) == sorted(set(b) - {"mfcc"}) == ["loudness", "pitch", "sig"]
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])


def _tiny_config(cache, **train):
    return Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 8192, "block_size": 256, "out_dir": cache},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 64, "n_harmonic": 8, "n_bands": 17, "sample_rate": 16000,
            "block_size": 256, "has_reverb": True}},
        "train": {"scales": [512, 256], "overlap": 0.75, "batch": 2, "lr": 1e-3,
                  "checkpoint_every_steps": 10, "val_interval_epochs": 5, **train},
    })


def test_trainer_fit_reduces_loss(cache, tmp_path):
    """The CPU training slice of the JAX suite, on the port:
    a fresh model on the JAX package's synthetic tones; the loss drops by the
    bound of the JAX suite's test (tests/test_training.py:126)."""
    cfg = _tiny_config(cache, steps=60)
    dm = Datamodule(cfg)
    dm.setup()
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    state = trainer.fit(dm)
    trainer.close()
    assert state.step == 60
    losses = [v for _, v in read_metrics(str(tmp_path / "run"), "loss")]
    skipped = [v for _, v in read_metrics(str(tmp_path / "run"), "update_skipped")]
    assert len(losses) == 60 and all(np.isfinite(losses)) and sum(skipped) == 0
    assert np.mean(losses[-5:]) < 0.82 * np.mean(losses[:5])
    assert read_metrics(str(tmp_path / "run"), "loss/val")
    assert trainer.checkpointer.best_meta() is not None
    frozen = Config.from_yaml(str(tmp_path / "run" / "config.yaml"))
    assert frozen.data.mean_loudness == cfg.data.mean_loudness is not None


def test_exact_resume(cache, tmp_path):
    """6 steps in one run equal 3 + 3 with a resume, bit for bit: params,
    Adam's state and the noise generator (the 3-step stop is mid-epoch)."""
    def run(name, totals):
        for total in totals:
            cfg = _tiny_config(cache, steps=6, checkpoint_every_steps=100)
            dm = Datamodule(cfg)
            dm.setup()
            trainer = Trainer(cfg, str(tmp_path / name), device="cpu")
            state = trainer.fit(dm, total_steps=total)
            trainer.close()
        return state

    a = run("straight", [6])
    b = run("resumed", [3, 6])
    assert a.step == b.step == 6
    for (k, va), (_, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(va, vb), k
    for x, y in zip(jax.tree.leaves(a.opt_state), jax.tree.leaves(b.opt_state)):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    la = read_metrics(str(tmp_path / "straight"), "loss")
    lb = read_metrics(str(tmp_path / "resumed"), "loss")
    assert la == lb and [s for s, _ in la] == list(range(1, 7))


def test_trainer_refuses_what_waits(cache, tmp_path):
    for change in ({"mesh": {"time": 4}}, {"train": {"steps_per_call": 25}}):
        cfg = _tiny_config(cache)
        for section, values in change.items():
            setattr(cfg, section, dataclasses.replace(getattr(cfg, section), **values))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Trainer(cfg, str(tmp_path / "run"), device="cpu")
