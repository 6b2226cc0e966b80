"""The port's time-sharded train step against the JAX package's, on the CPU.

At the JAX suite's sizes (tests/test_time_sharded_training.py:34-58:
hidden 16, 4 harmonics, 5 bands, 16 kHz, block 64, 4096 samples, scales
[512, 256], batch 4), one SGD step of the port's time-sharded step on an
in-process (data 2, time 4) mesh against one step of JAX's on its 8-device
virtual mesh, from the same weights, batch and noise, at that suite's
tolerances (:115-140): loss rtol 1e-4, grad norm rtol 1e-3, each leaf's
delta within 2e-2 of its largest (the padded shape: 1.5e-1 and grad norm
5e-3, :278-291).  Sharper, the port only: its sharded step against its own
unsharded step, both in float64 — the loss within 1e-12 relative and each
leaf's error within 1e-9 of the whole gradient's norm (and within 1e-8 of
its own: a near-zero leaf such as noise_proj carries the loss's
conditioning at near-silent STFT bins); then pad-and-mask's plan, the
Trainer on a mesh with exact resume, and the trajectory of
time_sharded_trajectory.py held to the artifact's bounds.
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
from ddsp_pytorch_tpu.models import load_model as jax_load_model
from ddsp_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from ddsp_pytorch_tpu.parallel.sharding import replicate_state as jax_replicate_state
from ddsp_pytorch_tpu.parallel.sharding import shard_time_batch as jax_shard_time_batch
from ddsp_pytorch_tpu.parallel.sharding import shard_time_train_step
from ddsp_pytorch_tpu.training import create_train_state
from ddsp_pytorch_tpu.training.time_sharded import make_time_sharded_train_step
from ddsp_pytorch_tpu.training.time_sharded import plan_time_padding as jax_plan_time_padding
from ddsp_pytorch_tpu_torch import time_sharded_trajectory
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.parallel import make_mesh
from ddsp_pytorch_tpu_torch.training import Trainer, make_train_step
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.optim import Optimizer
from ddsp_pytorch_tpu_torch.training.state import TrainState
from ddsp_pytorch_tpu_torch.training.time_sharded import plan_time_padding, validate_time_sharding
from ddsp_pytorch_tpu_torch.training.train import make_loss_and_grads
from ddsp_pytorch_tpu_torch.weights import flax_to_state_dict, state_dict_to_flax

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) JAX devices")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MFCC = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(has_reverb=True, autoencoder=False, signal_length=4096):
    return {
        "preprocess": {"sample_rate": 16000, "signal_length": signal_length, "block_size": 64},
        "model": {"name": "mfcc-autoencoder" if autoencoder else "single-inst-decoder", "kwargs": {
            "hidden_size": 16, "n_harmonic": 4, "n_bands": 5, "sample_rate": 16000,
            "block_size": 64, "has_reverb": has_reverb}},
        "train": {"scales": [512, 256], "overlap": 0.75, "batch": 4},
    }


def _batch(rng, raw, autoencoder=False):
    b, t = 4, raw["preprocess"]["signal_length"]
    f = t // 64
    batch = {"sig": rng.standard_normal((b, t)).astype(np.float32) * np.float32(0.1),
             "pitch": rng.uniform(100, 400, (b, f, 1)).astype(np.float32),
             "loudness": rng.standard_normal((b, f, 1)).astype(np.float32)}
    if autoencoder:
        batch["mfcc"] = rng.standard_normal((b, f, N_MFCC)).astype(np.float32)
    return batch


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(tree[k], np.float64)


CASES = {
    "reverb": ({"has_reverb": True}, 2e-2, 1e-3),
    "no_reverb": ({"has_reverb": False}, 2e-2, 1e-3),
    "autoencoder": ({"has_reverb": True, "autoencoder": True}, 2e-2, 1e-3),
    # 71 frames: 71 % 4 != 0, the pad-and-mask path (:278-291)
    "padded": ({"has_reverb": True, "signal_length": 4096 + 448}, 1.5e-1, 5e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_sharded_step_matches_jax(rng, case):
    """One SGD(0.1) step, port's (data 2, time 4) in-process mesh against
    JAX's 8-device mesh: same weights (transplanted), batch and noise (the
    JAX step's own draw, injected)."""
    kwargs, delta_tol, grad_norm_rtol = CASES[case]
    autoencoder = kwargs.get("autoencoder", False)
    raw = _raw(**kwargs)
    jcfg, cfg = JaxConfig.from_dict(raw), Config.from_dict(raw)
    jmodel = jax_load_model(jcfg)
    batch = _batch(rng, raw, autoencoder)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = optax.sgd(0.1)
    jmesh = jax_make_mesh(data=2, time=4)
    state0 = create_train_state(jmodel, jbatch, tx, seed=0)
    params0 = jax.tree.map(np.asarray, jax.device_get(state0.params))
    # the draw the JAX step makes (time_sharded.py:229, 253-258), taken
    # before the step, which donates the state
    _, noise_rng = jax.random.split(state0.rng)
    noise = np.asarray(jmodel.apply({"params": params0}, jbatch["pitch"], rngs={"noise": noise_rng},
                                    method=jmodel.sample_noise))
    step = shard_time_train_step(make_time_sharded_train_step(jmodel, tx, jcfg, jmesh), jmesh)
    jnew, jmetrics = step(jax_replicate_state(state0, jmesh), jax_shard_time_batch(jbatch, jmesh))

    model = load_model(cfg.model.name, cfg.model.kwargs)
    model.load_state_dict(flax_to_state_dict(params0))
    port_tx = Optimizer("sgd", 0.1)
    state = TrainState(0, model, port_tx.init(list(model.parameters())), torch.Generator(), 0.0, 1.0)
    metrics = make_train_step(model, port_tx, cfg, make_mesh(2, 4))(
        state, {k: torch.tensor(v) for k, v in batch.items()}, noise=torch.tensor(noise))

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=grad_norm_rtol)
    before = dict(_leaves(params0))
    got = {k: v - before[k] for k, v in _leaves(state_dict_to_flax(model.state_dict()))}
    want = {k: v - before[k] for k, v in _leaves(jax.tree.map(np.asarray, jax.device_get(jnew.params)))}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(got[name], w, atol=delta_tol * scale, rtol=1e-3,
                                   err_msg=f"param delta (= -lr*grad) mismatch at {name}")


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4), (1, 2)], ids=["time4", "data2-time4", "time2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_sharded_step_equals_unsharded(rng, case, mesh_shape):
    """The port's sharded loss and gradients against its unsharded step,
    both in float64 on the CPU, same weights, batch and noise: the loss
    within 1e-12 relative (measured ≤ 7e-15), each leaf within 1e-9 of the
    whole gradient's norm (measured ≤ 6e-11) and 1e-8 of its own (≤ 3.1e-9)."""
    kwargs = CASES[case][0]
    raw = _raw(**kwargs)
    cfg = Config.from_dict(raw)
    batch = {k: torch.tensor(v, dtype=torch.float64)
             for k, v in _batch(rng, raw, kwargs.get("autoencoder", False)).items()}
    f = batch["pitch"].shape[1]
    noise = torch.tensor(rng.uniform(-1, 1, (4, f, 64)))
    model = init_params(load_model(cfg.model.name, cfg.model.kwargs),
                        torch.Generator().manual_seed(0)).double()
    state = TrainState(0, model, {}, torch.Generator(), -0.2, 1.3)
    loss0, g0 = make_loss_and_grads(model, cfg, None)(state, batch, noise)
    loss1, g1 = make_loss_and_grads(model, cfg, make_mesh(*mesh_shape))(state, batch, noise)
    assert loss1.dtype == torch.float64 and all(g.dtype == torch.float64 for g in g1)
    assert abs(float(loss1) - float(loss0)) <= 1e-12 * abs(float(loss0))
    whole = float(torch.cat([g.flatten() for g in g0]).norm())
    for (name, _), a, b in zip(model.named_parameters(), g1, g0):
        err = float((a - b).norm())
        assert err <= 1e-9 * whole, f"{name}: |Δ| {err:.3e} > 1e-9 of |g| {whole:.3e}"
        assert err <= 1e-8 * float(b.norm()), f"{name}: |Δ| {err:.3e} > 1e-8 of its norm"


@pytest.mark.parametrize("autoencoder", [False, True], ids=["decoder", "autoencoder"])
def test_frame_controls_sample_noise_and_reverb_impulse_are_the_forward(rng, autoencoder):
    """The NN stage, the noise draw and the IR the sharded step takes apart
    (JAX decoder.py:168-223, encoder.py:90-99) recombine into the model's
    forward bit for bit (:221-251 of the JAX suite's sample_noise test)."""
    raw = _raw(has_reverb=True, autoencoder=autoencoder)
    cfg = Config.from_dict(raw)
    model = init_params(load_model(cfg.model.name, cfg.model.kwargs), torch.Generator().manual_seed(0))
    batch = {k: torch.tensor(v) for k, v in _batch(rng, raw, autoencoder).items()}
    with torch.no_grad():
        out = model(batch, generator=torch.Generator().manual_seed(3))
        noise = model.sample_noise(batch["pitch"], torch.Generator().manual_seed(3))
        args = (batch["pitch"], batch["loudness"]) + ((batch["mfcc"],) if autoencoder else ())
        harmonic_ctrls, noise_ctrls = model.frame_controls(*args)
        dry = model.harmonic_synth(**harmonic_ctrls) + model.noise_synth(**noise_ctrls, noise=noise)
        ir = torch.nn.functional.pad(model.reverb_impulse(), (0, 0))[: dry.shape[-1]]
        wet = torch.fft.irfft(torch.fft.rfft(torch.nn.functional.pad(dry, (0, dry.shape[-1])))
                              * torch.fft.rfft(torch.nn.functional.pad(ir, (dry.shape[-1], 0))[None]))
    assert noise.shape == (4, 64, 64)
    assert torch.equal(out["noise"], model.noise_synth(**noise_ctrls, noise=noise))
    assert torch.equal(out["signal"], wet[..., wet.shape[-1] // 2:])


def test_shipped_timesharded_config_plan():
    """configs/config_timesharded.yaml is the reference workload with
    mesh.time 4: 375 → 384 frames, chunk 49152 (:295-322), and the plan
    equals JAX's at time 2, 4 and 8."""
    path = os.path.join(REPO, "configs", "config_timesharded.yaml")
    cfg, jcfg = Config.from_yaml(path), JaxConfig.from_yaml(path)
    assert cfg.mesh.time == 4 and cfg.preprocess.signal_length == 192000
    plan = plan_time_padding(cfg, make_mesh(data=2, time=4))
    assert (plan.frames, plan.frames_pad) == (375, 384)
    assert plan.t_pad == 384 * 512 and plan.chunk == 49152
    for n_time in (2, 4, 8):
        got = plan_time_padding(cfg, make_mesh(8 // n_time, n_time))
        want = jax_plan_time_padding(jcfg, jax_make_mesh(data=8 // n_time, time=n_time))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.pad_samples <= 192000 * 0.1 and got.t_pad % (n_time * 1024) == 0


def test_plan_time_padding_shapes():
    """tests/test_time_sharded_training.py:254-276 on the port's plan."""
    mesh = make_mesh(2, 4)
    cfg = Config.from_dict(_raw(has_reverb=False))
    plan = plan_time_padding(cfg, mesh)
    assert plan.pad_frames == 0 and plan.t_pad == 4096
    cfg2 = Config.from_dict(_raw(has_reverb=False, signal_length=4096 + 256))
    cfg2.train.scales = [512]
    plan2 = plan_time_padding(cfg2, mesh)
    assert plan2.pad_frames > 0 and plan2.chunk % 128 == 0 and plan2.pad_samples >= 256
    assert 2 * plan2.t_valid - plan2.t_pad - 1 >= 3 * plan2.chunk
    bad = Config.from_dict(_raw(has_reverb=False))
    bad.train.scales = [2048]
    with pytest.raises(ValueError, match="time sharding"):
        validate_time_sharding(bad, mesh)


def test_trainer_accepts_the_timesharded_config(tmp_path):
    """Trainer(configs/config_timesharded.yaml) builds at full width, with
    no mesh (unsharded, as the JAX Trainer with mesh=None) and with its
    in-process time = 4 mesh; a mesh whose data axis does not divide the
    batch, or a workload that cannot shard, raises."""
    cfg = Config.from_yaml(os.path.join(REPO, "configs", "config_timesharded.yaml"))
    for mesh in (None, make_mesh(1, cfg.mesh.time), make_mesh(2, 4)):
        trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu", use_tensorboard=False, mesh=mesh)
        assert trainer.model.hidden_size == 512 and trainer.mesh is mesh
        trainer.close()
    with pytest.raises(ValueError, match="divide"):
        Trainer(cfg, str(tmp_path / "run"), device="cpu", use_tensorboard=False, mesh=make_mesh(3, 4))
    bad = Config.from_yaml(os.path.join(REPO, "configs", "config_timesharded.yaml"))
    bad.train.scales = [131072]
    with pytest.raises(ValueError, match="time sharding"):
        Trainer(bad, str(tmp_path / "run"), device="cpu", use_tensorboard=False, mesh=make_mesh(1, 4))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache"))
    make_synthetic_dataset(path, n_items=8, sample_rate=16000, signal_length=4096, block_size=64,
                           n_harmonic=4, device="cpu")
    return path


def _fit_config(cache, steps):
    raw = _raw(has_reverb=True)
    raw["preprocess"]["out_dir"] = cache
    raw["train"].update({"scales": [256], "steps": steps, "steps_per_call": 2,
                         "val_interval_epochs": 1, "checkpoint_every_steps": 2})
    raw["mesh"] = {"data": 2, "time": 4}
    return Config.from_dict(raw)


def test_trainer_fit_time_sharded_and_resume(cache, tmp_path):
    """Trainer.fit on an in-process (data 2, time 4) mesh, steps_per_call 2
    (the multi-step on the CPU), validation each epoch: 6 straight steps
    equal 4 steps and a resumed fit to 6, bit for bit; the losses equal the
    unsharded Trainer's to the sharded step's float32 rounding."""
    mesh = make_mesh(2, 4)
    runs = {}
    for name, legs in (("straight", (6,)), ("resumed", (4, 6)), ("unsharded", (6,))):
        for steps in legs:
            cfg = _fit_config(cache, steps)
            dm = Datamodule(cfg, mesh=mesh)
            dm.setup()
            trainer = Trainer(cfg, str(tmp_path / name), device="cpu", use_tensorboard=False,
                              mesh=None if name == "unsharded" else mesh)
            state = trainer.fit(dm)
            trainer.close()
        runs[name] = state
        assert state.step == 6
    a, b = runs["straight"], runs["resumed"]
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    la = read_metrics(str(tmp_path / "straight"), "loss")
    assert la == read_metrics(str(tmp_path / "resumed"), "loss")
    assert [s for s, _ in la] == list(range(1, 7)) and all(np.isfinite([v for _, v in la]))
    lu = read_metrics(str(tmp_path / "unsharded"), "loss")
    np.testing.assert_allclose([v for _, v in la], [v for _, v in lu], rtol=1e-4)
    assert read_metrics(str(tmp_path / "straight"), "loss/val")


def test_trajectory_time_sharded_equivalence():
    """time_sharded_trajectory.run_trajectories at 300 steps (the JAX
    suite's test, :295-322), on the CPU: the windowed losses within 5 % at
    every checkpoint, both runs' last window below 0.6 × the first, the
    final global parameter rel-L2 under 0.2 (measured at 400 steps: 0.096)."""
    report = time_sharded_trajectory.run_trajectories(steps=300, window=25, device="cpu")
    assert report["pad_frames"] == 9 and report["frames_pad"] == 80
    assert time_sharded_trajectory.check_bounds(report) == []
