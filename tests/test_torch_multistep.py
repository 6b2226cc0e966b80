"""The port's steps_per_call, device-resident loader and preemption-safe fit,
on the CPU at a small width (hidden 16, 8 harmonics, 9 noise bands, 16 kHz,
block 256, 32 frames, scales [512, 256], reverb on), against the port's
own single-step loop and the JAX package's loaders.

Tolerances:
  * steps_per_call 4 (scan_unroll 2) against steps_per_call 1, and a
    preempted-and-resumed run against an uninterrupted one: bit for bit
    (torch.equal on every parameter, optimizer-state leaf and the noise
    generator's state, and equal per-step losses), since each call runs the
    same single-step arithmetic on the same batches and noise;
  * the batches each step trains on: equal to the JAX loaders' batches in
    the JAX Trainer's order (every step takes the next batch of the epoch
    stream, tests/test_training.py:181);
  * DeviceDataLoader against the JAX DeviceDataLoader: indices and batches
    equal; loudness_stats bit for bit equal to the port's mean_std_loudness
    (the same per-batch float32 stats and host running mean), and within
    1e-6 relative of the JAX package's two estimators, as
    tests/test_torch_spectral_loss.py holds the port's mean_std_loudness:
    per-batch float32 means from two libraries' reductions differ in the
    last bit (the JAX package's own loudness_stats and mean_std_loudness
    differ there too on the CPU).
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu.data import make_synthetic_dataset
from ddsp_pytorch_tpu.data.dataset import DataLoader as JaxDataLoader
from ddsp_pytorch_tpu.data.dataset import Dataset as JaxDataset
from ddsp_pytorch_tpu.data.dataset import DeviceDataLoader as JaxDeviceDataLoader
from ddsp_pytorch_tpu.ops import mean_std_loudness as jax_mean_std_loudness
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import DataLoader, Datamodule, Dataset, DeviceDataLoader
from ddsp_pytorch_tpu_torch.models import DDSPDecoder
from ddsp_pytorch_tpu_torch.ops import mean_std_loudness
from ddsp_pytorch_tpu_torch.training import Trainer, make_optimizer
from ddsp_pytorch_tpu_torch.training import train as train_mod
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.optim import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, BATCH, STEPS = 4, 2, 14  # 2 steps an epoch; 14 = 3 calls of 4 + 2 single steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache"))
    make_synthetic_dataset(path, n_items=N_ITEMS, sample_rate=16000, signal_length=8192,
                           block_size=256, n_harmonic=8)
    return path


def _config(cache, **train):
    return Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 8192, "block_size": 256, "out_dir": cache},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 16, "n_harmonic": 8, "n_bands": 9, "sample_rate": 16000,
            "block_size": 256, "has_reverb": True}},
        "train": {"scales": [512, 256], "overlap": 0.75, "batch": BATCH, "lr": 1e-3, "steps": STEPS,
                  "checkpoint_every_steps": 100, "val_interval_epochs": 3, **train},
    })


def _fit(cache, run_dir, device_cache=False, total_steps=None, **train):
    cfg = _config(cache, **train)
    dm = Datamodule(cfg, device_cache=device_cache, device="cpu")
    dm.setup()
    trainer = Trainer(cfg, str(run_dir), device="cpu", use_tensorboard=False)
    try:
        return trainer.fit(dm, total_steps=total_steps)
    finally:
        trainer.close()


def _assert_same_state(a, b):
    assert a.step == b.step
    for (name, x), y in zip(a.model.named_parameters(), b.params()):
        assert torch.equal(x, y), name
    for x, y in zip(tree_leaves(a.opt_state), tree_leaves(b.opt_state)):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _record_batches(monkeypatch):
    """Wrap the train step's loss_and_grads to record each step's pitch."""
    seen = []
    inner = train_mod.loss_and_grads

    def recording(model, batch, *args, **kwargs):
        seen.append(batch["pitch"].detach().clone().numpy())
        return inner(model, batch, *args, **kwargs)

    monkeypatch.setattr(train_mod, "loss_and_grads", recording)
    return seen


def _jax_order(cache, device_cache, n_steps):
    """The pitch of the batches the JAX Trainer trains steps 1..n on: the
    epochs' batches in order (train.py:449-560)."""
    dataset = JaxDataset(os.path.join(cache, "train"))
    cls = JaxDeviceDataLoader if device_cache else JaxDataLoader
    loader = cls(dataset, BATCH, shuffle=True, drop_last=True, seed=0)
    out, epoch = [], 0
    while len(out) < n_steps:
        loader.set_epoch(epoch)
        out += [np.asarray(b["pitch"]) for b in loader]
        epoch += 1
    return out[:n_steps]


@pytest.mark.parametrize("device_cache", [False, True], ids=["host_loader", "device_cache"])
def test_steps_per_call_trains_what_single_steps_train(cache, tmp_path, monkeypatch, device_cache):
    """steps_per_call 4 with scan_unroll 2, where a call spans two epochs
    (4 > 2 steps an epoch) and the last 2 of 14 steps run single, trains
    exactly what steps_per_call 1 trains, in the JAX Trainer's batch order."""
    seen = _record_batches(monkeypatch)
    one = _fit(cache, tmp_path / "spc1", device_cache)
    seen_one = list(seen)
    seen.clear()
    four = _fit(cache, tmp_path / "spc4", device_cache, steps_per_call=4, scan_unroll=2)
    _assert_same_state(one, four)
    assert one.step == STEPS
    l1, l4 = read_metrics(str(tmp_path / "spc1"), "loss"), read_metrics(str(tmp_path / "spc4"), "loss")
    assert l1 == l4 and [s for s, _ in l4] == list(range(1, STEPS + 1))
    want = _jax_order(cache, device_cache, STEPS)
    assert len(seen_one) == len(seen) == STEPS
    for got_1, got_4, ref in zip(seen_one, seen, want):
        np.testing.assert_array_equal(got_1, ref)
        np.testing.assert_array_equal(got_4, ref)


@pytest.mark.parametrize("spc,at_step,stops_at", [(1, 5, 5), (4, 6, 8)], ids=["spc1", "spc4"])
def test_preempted_run_resumes_exactly(cache, tmp_path, monkeypatch, spc, at_step, stops_at):
    """A SIGTERM sent from inside step `at_step` checkpoints at the next
    call boundary and returns; the handlers are restored; a second fit
    resumes and ends equal to an uninterrupted run."""
    train = {"steps_per_call": spc, "scan_unroll": 2 if spc > 1 else 1}
    straight = _fit(cache, tmp_path / "straight", **train)

    calls = []
    inner = train_mod.loss_and_grads

    def preempting(*args, **kwargs):
        calls.append(1)
        if len(calls) == at_step:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(*args, **kwargs)

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(train_mod, "loss_and_grads", preempting)
    stopped = _fit(cache, tmp_path / "run", **train)
    monkeypatch.setattr(train_mod, "loss_and_grads", inner)
    assert signal.getsignal(signal.SIGTERM) is before
    assert stopped.step == stops_at
    assert sorted(int(n[:-3]) for n in os.listdir(tmp_path / "run" / "checkpoints"))[-1] == stops_at
    assert [s for s, _ in read_metrics(str(tmp_path / "run"), "loss")] == list(range(1, stops_at + 1))

    resumed = _fit(cache, tmp_path / "run", **train)
    _assert_same_state(straight, resumed)
    assert read_metrics(str(tmp_path / "run"), "loss") == read_metrics(str(tmp_path / "straight"), "loss")


def test_device_data_loader_matches_jax(cache):
    path = os.path.join(cache, "train")
    for shuffle, drop_last, batch in ((True, True, 2), (False, False, 3), (True, False, 3)):
        port = DeviceDataLoader(Dataset(path), batch, shuffle, drop_last, seed=5, device="cpu")
        ref = JaxDeviceDataLoader(JaxDataset(path), batch, shuffle, drop_last, seed=5)
        assert len(port) == len(ref)
        # the cache has mfccs.npy: both loaders hold the autoencoder's mfcc too
        assert sorted(port.device_data) == sorted(ref.device_data) == ["loudness", "mfcc", "pitch", "sig"]
        for epoch in range(3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port.index_batches()), list(ref.index_batches())
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            full = [i for i in got if len(i) == batch]
            if full:
                stacked, jstacked = port.take_stacked(np.stack(full)), ref.take_stacked(np.stack(full))
                for k, v in stacked.items():
                    assert v.shape[:2] == (len(full), batch)
                    np.testing.assert_array_equal(v.numpy(), np.asarray(jstacked[k]))
            for a, b in zip(port, ref):
                for k, v in a.items():
                    np.testing.assert_array_equal(v.numpy(), np.asarray(b[k]))

        port.set_epoch(0)  # the stats of epoch 0's order, as the Trainer takes them
        ref.set_epoch(0)
        got = port.loudness_stats()
        assert got == mean_std_loudness(DataLoader(Dataset(path), batch, shuffle, drop_last, seed=5))
        np.testing.assert_allclose(got, ref.loudness_stats(), rtol=1e-6)
        np.testing.assert_allclose(
            got, jax_mean_std_loudness(JaxDataLoader(JaxDataset(path), batch, shuffle, drop_last, seed=5)),
            rtol=1e-6,
        )


def test_datamodule_device_cache_chooses_device_loader(cache):
    cfg = _config(cache)
    dm = Datamodule(cfg, device_cache=True, device="cpu")
    dm.setup()
    loader = dm.train_dataloader()
    assert isinstance(loader, DeviceDataLoader) and loader.device == torch.device("cpu")
    assert (loader.batch_size, loader.shuffle, loader.drop_last) == (BATCH, True, True)
    assert type(dm.val_dataloader()) is DataLoader
    plain = Datamodule(cfg)
    plain.setup()
    assert type(plain.train_dataloader()) is DataLoader


def test_multi_step_checks_its_arguments(cache, tmp_path):
    cfg = _config(cache)
    model = DDSPDecoder(**cfg.model.kwargs)
    with pytest.raises(ValueError, match="train.scan_unroll=3 must divide train.steps_per_call=4"):
        train_mod.make_train_multi_step(model, make_optimizer(cfg), cfg, 4, 3)
    with pytest.raises(ValueError, match="must divide"):
        Trainer(_config(cache, steps_per_call=4, scan_unroll=3), str(tmp_path / "run"), device="cpu",
                use_tensorboard=False)
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu", use_tensorboard=False)
    state = trainer.init_state()
    multi = train_mod.make_train_multi_step_indexed(trainer.model, trainer.tx, cfg, 4, 2)
    loader = DeviceDataLoader(Dataset(os.path.join(cache, "train")), BATCH, device="cpu")
    with pytest.raises(ValueError, match="leading axis of 3, expected steps_per_call=4"):
        multi(state, loader.device_data, np.zeros((3, BATCH), np.int64))
    rows = multi(state, loader.device_data, np.zeros((4, BATCH), np.int64))
    assert rows.shape == (4, 3) and state.step == 4 and bool(torch.isfinite(rows).all())
    trainer.close()


def test_committed_run_configs_are_accepted(tmp_path):
    """Every committed decoder run config sets steps_per_call 25 or 50; the
    Trainer takes them."""
    names = ("ddsp_violin_config.yaml", "ddsp_flute_config.yaml", "ddsp_sigmund_config.yaml")
    for name in names:
        cfg = Config.from_yaml(os.path.join(REPO, "pretrained", name))
        assert cfg.train.steps_per_call in (25, 50)
        trainer = Trainer(cfg, str(tmp_path / name), device="cpu", use_tensorboard=False)
        assert (trainer._spc, trainer._unroll) == (cfg.train.steps_per_call, cfg.train.scan_unroll)
        trainer.close()


def test_jax_trainer_config_agrees():
    """The JAX package reads the same steps_per_call and scan_unroll."""
    from ddsp_pytorch_tpu.config import Config as JaxConfig

    path = os.path.join(REPO, "pretrained", "ddsp_violin_config.yaml")
    ours, theirs = Config.from_yaml(path).train, JaxConfig.from_yaml(path).train
    assert (ours.steps_per_call, ours.scan_unroll) == (theirs.steps_per_call, theirs.scan_unroll) == (25, 1)
    assert jax.devices()[0].platform == "cpu"
