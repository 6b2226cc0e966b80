"""Multi-process training on the CPU: two processes over gloo run the port's
train CLI with --multihost, and their run equals one process on the global
batch (the counterpart of tests/test_multihost.py).

  * data-parallel (mesh data 2): each rank loads its interleaved shard,
    replicated state, one all_reduce of the gradients and loss a step
    (steps_per_call 2: the multi-step's loop on the CPU), rank 0 alone
    writing.  Held against the same steps in this process on the
    concatenated global batches, the Trainer's own stats estimator and
    noise draws: each step's loss rtol 1e-5, grad norm rtol 1e-3
    (tests/test_parallel.py:187-241), the final parameters and the
    validation loss likewise;
  * time-sharded across the processes (mesh time 2, one shard a rank, the
    pad-and-mask path, reverb on): the halo, reverb-tail and phase-scan
    collectives cross the process boundary, and the run equals the
    unsharded CLI run at the time-sharded step's tolerances (loss rtol
    1e-4, grad norm rtol 5e-3: tests/test_time_sharded_training.py:278-291).

Each process runs one torch thread; every collective is bounded by the
CLI's --dist-timeout and every process by a subprocess timeout, so a hung
collective fails the test within a couple of minutes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import DataLoader, Dataset, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.models import init_params, load_model
from ddsp_pytorch_tpu_torch.ops import mean_std_loudness, uniform_noise
from ddsp_pytorch_tpu_torch.training import make_eval_step, make_optimizer, make_train_step
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESS_TIMEOUT_S = 150
COLLECTIVE_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache"))
    for length in (2048, 2112):
        make_synthetic_dataset(os.path.join(path, str(length)), n_items=8, sample_rate=16000,
                               signal_length=length, block_size=64, n_harmonic=4, device="cpu")
    return path


def _config(tmp_path, cache, name, signal_length, has_reverb, **train) -> str:
    cfg = Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": signal_length, "block_size": 64,
                       "out_dir": os.path.join(cache, str(signal_length))},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 16, "n_harmonic": 4, "n_bands": 5, "sample_rate": 16000,
            "block_size": 64, "has_reverb": has_reverb}},
        "train": {"scales": [256, 128], "batch": 4, "optimizer": "sgd", "lr": 1e-3,
                  "val_interval_epochs": 1, "checkpoint_every_steps": 0, **train},
    })
    path = str(tmp_path / f"{name}.yaml")
    cfg.to_yaml(path)
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cli(root, name, config, world, extra=()):
    """The train CLI in `world` processes (--multihost over gloo when world
    > 1); returns the run directory."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "ddsp_pytorch_tpu_torch.train", "--config", config, "--name", name,
           "--root", str(root), "--device", "cpu", "--no-tensorboard", *extra]
    if world > 1:
        cmd += ["--multihost", "--dist-timeout", str(COLLECTIVE_TIMEOUT_S)]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n=====\n".join(logs)
    return os.path.join(str(root), name)


def _checkpoint(run_dir, step):
    return torch.load(os.path.join(run_dir, "checkpoints", f"{step}.pt"), map_location="cpu",
                      weights_only=True)


def _replay(run_dir, cfg, batches, mean_l, std_l):
    """Step k of one unsharded process on global batch k, from the run's
    own state after step k − 1 where the run checkpointed it (else from the
    replayed step k − 1; fresh weights at k = 1, as the Trainer draws
    them): [(loss, grad_norm, params after)].  Held
    against the run from the same state, a step is compared with a step;
    the float32 loss is ill-conditioned at fresh weights (a 1e-10 change of
    the parameters moves the next gradient's norm by ~0.3 %), so runs that
    drift apart by rounding could not be held to 1e-3 after their first
    step."""
    model = load_model(cfg.model.name, cfg.model.kwargs)
    generator = torch.Generator().manual_seed(cfg.train.seed)
    init_params(model, generator)
    tx = make_optimizer(cfg)
    state = TrainState(0, model, tx.init(list(model.parameters())), generator, mean_l, std_l)
    step = make_train_step(model, tx, cfg)
    out = []
    for k, batch in enumerate(batches, start=1):
        if os.path.exists(os.path.join(run_dir, "checkpoints", f"{k - 1}.pt")):
            state.load_state_dict(_checkpoint(run_dir, k - 1))
        metrics = step(state, {key: torch.tensor(v) for key, v in batch.items()})
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    {n: v.clone() for n, v in model.state_dict().items()}))
    return out, state, make_eval_step(model, cfg)


def _val_loss(state, eval_step, val_batches):
    """Trainer._run_validation on one process: each batch's noise from a
    generator seeded 0, the mean of the batches' losses."""
    losses = []
    for batch in val_batches:
        batch = {k: torch.tensor(v) for k, v in batch.items()}
        noise = uniform_noise((batch["pitch"].shape[0], batch["pitch"].shape[1], 64),
                              torch.Generator().manual_seed(0), torch.float32, "cpu")
        losses.append(float(eval_step(state, batch, noise=noise)["loss"]))
    return float(np.mean(losses))


def _check_run(run_dir, replayed, loss_rtol, grad_norm_rtol, param_atol):
    losses = read_metrics(run_dir, "loss")
    assert [s for s, _ in losses] == list(range(1, len(replayed) + 1)), "rank 0 alone logs, once a step"
    norms = [v for _, v in read_metrics(run_dir, "grad_norm")]
    for k, (loss, norm, params) in enumerate(replayed, start=1):
        np.testing.assert_allclose(losses[k - 1][1], loss, rtol=loss_rtol, err_msg=f"loss, step {k}")
        np.testing.assert_allclose(norms[k - 1], norm, rtol=grad_norm_rtol, err_msg=f"grad norm, step {k}")
        saved = _checkpoint(run_dir, k)["params"]
        for name, v in params.items():
            np.testing.assert_allclose(saved[name].numpy(), v.numpy(), rtol=0,
                                       atol=param_atol * max(float(v.abs().max()), 1.0),
                                       err_msg=f"{name} after step {k}")


def _global_batches(cfg, partition, num_shards, epochs, train=True):
    """The global batches of a run whose loaders are split over `num_shards`
    data shards: each step's [shard 0's rows, shard 1's rows, ...]."""
    data = Dataset(os.path.join(cfg.preprocess.out_dir, partition))
    loaders = [DataLoader(data, cfg.train.batch // num_shards, shuffle=train, drop_last=train,
                          seed=cfg.train.seed, num_shards=num_shards, shard_index=i)
               for i in range(num_shards)]
    out = []
    for epoch in range(epochs):
        for loader in loaders:
            loader.set_epoch(epoch)
        out += [{k: np.concatenate([b[k] for b in parts]) for k in parts[0]} for parts in zip(*loaders)]
    return out


def _check_val(run_dir, cfg, num_shards, state, eval_step, rtol):
    """The run's validation losses against one process's on the global val
    batches, from the run's checkpoint at each."""
    val_batches = _global_batches(cfg, "validation", num_shards, 1, train=False)
    got = dict(read_metrics(run_dir, "loss/val"))
    assert sorted(got) == [2, 4]
    for at, value in got.items():
        state.load_state_dict(_checkpoint(run_dir, at))
        np.testing.assert_allclose(value, _val_loss(state, eval_step, val_batches), rtol=rtol,
                                   err_msg=f"loss/val at step {at}")


def test_two_process_data_parallel_cli_equals_one_process(cache, tmp_path):
    steps = 4
    config = _config(tmp_path, cache, "dp", 2048, False, steps=steps, checkpoint_every_steps=1,
                     keep_checkpoints=steps)
    run_dir = _run_cli(tmp_path, "dp", config, world=2)
    cfg = Config.from_yaml(config)
    # the Trainer's stats across processes: the whole dataset at the global
    # batch, unshuffled (train.py:652-668)
    data = Dataset(os.path.join(cfg.preprocess.out_dir, "train"))
    mean_l, std_l = mean_std_loudness(DataLoader(data, cfg.train.batch, shuffle=False))
    frozen = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    assert (frozen.data.mean_loudness, frozen.data.std_loudness) == (mean_l, std_l)
    replayed, state, eval_step = _replay(run_dir, cfg, _global_batches(cfg, "train", 2, 2), mean_l, std_l)
    _check_run(run_dir, replayed, loss_rtol=1e-5, grad_norm_rtol=1e-3, param_atol=1e-6)
    _check_val(run_dir, cfg, 2, state, eval_step, rtol=1e-5)


@pytest.mark.parametrize("data,time", [(1, 2), (2, 2)], ids=["time2", "data2-time2"])
def test_multi_process_time_sharded_cli_equals_one_process(cache, tmp_path, data, time):
    """The time axis across processes, one shard a rank (data × time ranks;
    with data 2 each pair of time ranks shares its data shard's rows):
    2112 samples = 33 frames, padded to 36 (pad-and-mask), reverb on,
    steps_per_call 2 (the multi-step's loop with the collectives inside),
    the stats pinned in the config.  Steps 1 and 3 equal one unsharded step
    on the global batch from the run's own state at the time-sharded step's
    bounds (loss 1e-4, grad norm 5e-3); steps 2 and 4, inside a call, the
    replayed step after step 1 and 3 in loss; the validation losses (the
    unsharded eval on every rank) one process's within 1e-5."""
    config = _config(tmp_path, cache, "ts", 2112, True, steps=4, steps_per_call=2,
                     checkpoint_every_steps=1, keep_checkpoints=4)
    cfg = Config.from_yaml(config)
    cfg.data.mean_loudness, cfg.data.std_loudness = -4.0, 1.5
    cfg.to_yaml(config)
    run_dir = _run_cli(tmp_path, "ts", config, world=data * time,
                       extra=("--mesh-data", str(data), "--mesh-time", str(time)))
    with open(os.path.join(run_dir, "config.yaml")) as f:
        assert f"time: {time}" in f.read()
    replayed, state, eval_step = _replay(run_dir, cfg, _global_batches(cfg, "train", data, 2), -4.0, 1.5)
    assert sorted(int(f[:-3]) for f in os.listdir(os.path.join(run_dir, "checkpoints"))) == [2, 4]
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    norms = [v for _, v in read_metrics(run_dir, "grad_norm")]
    np.testing.assert_allclose(losses, [r[0] for r in replayed], rtol=1e-4)
    for k in (1, 3):  # from the run's own state (fresh, checkpoint 2)
        np.testing.assert_allclose(norms[k - 1], replayed[k - 1][1], rtol=5e-3, err_msg=f"step {k}")
    _check_val(run_dir, cfg, data, state, eval_step, rtol=1e-5)


_COLLECTIVES = """
import os, torch, torch.distributed as dist
from ddsp_pytorch_tpu_torch.parallel import make_mesh
dist.init_process_group("gloo", init_method="env://")
mesh = make_mesh(1, 3, group=dist.group.WORLD)
axis, me = mesh.time_axis, dist.get_rank()
x = torch.arange(6.0).view(1, 2, 3).add(10.0 * me).requires_grad_()
w = torch.arange(6.0).view(1, 2, 3).add(100.0 * me)
for k in (1, -1, 2):
    y = axis.shift(x, k)
    src = me - k
    assert torch.equal(y.detach(), x.detach() + 10.0 * (src - me) if 0 <= src < 3 else torch.zeros_like(x)), k
    (g,) = torch.autograd.grad((w * y).sum(), x)
    dst = me + k  # the transpose: my slice went to dst, its cotangent comes back
    assert torch.equal(g, w + 100.0 * (dst - me) if 0 <= dst < 3 else torch.zeros_like(w)), k
gathered = axis.all_gather(x)
assert gathered.shape == (3, 2, 3) and torch.equal(gathered[me], x.detach()[0])
(g,) = torch.autograd.grad((gathered * (1.0 + torch.arange(3.0)).view(3, 1, 1)).sum(), x)
assert torch.equal(g, torch.full_like(x, 3.0 * (1.0 + me)))  # the summed cotangents' row `me`
total = mesh.psum((x * (me + 1.0)).sum())
(g,) = torch.autograd.grad(total, x)
assert float(total) == sum((r + 1.0) * float((torch.arange(6.0) + 10.0 * r).sum()) for r in range(3))
assert torch.equal(g, torch.full_like(x, me + 1.0))  # identity backward: no world-size factor
# the mesh holds the process group: released first, the group is freed by
# destroy_process_group, not at interpreter exit, where gloo's threads can
# still be joinable (std::terminate, a rank exiting -6)
del mesh, axis
dist.destroy_process_group()
print("collectives ok", me)
"""


def test_cross_process_collectives_and_their_transposes(tmp_path):
    """shift, all_gather and psum across three gloo processes (one time
    shard a rank): values, and autograd's backward as JAX's transposes —
    shift(k) → shift(−k), all_gather → this rank's row of the summed
    cotangents, psum → the identity (the gradients are summed once after
    the backward, parallel/sharding.GradientReducer)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="3", PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", _COLLECTIVES], env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(3)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n=====\n".join(logs)
    assert all(f"collectives ok {r}" in log for r, log in enumerate(logs))


def test_cli_refuses_segments_with_multihost(tmp_path):
    out = subprocess.run([sys.executable, "-m", "ddsp_pytorch_tpu_torch.train", "--multihost",
                          "--segment-steps", "2", "--device", "cpu"], cwd=REPO, capture_output=True,
                         text=True, timeout=PROCESS_TIMEOUT_S,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 2 and "--multihost" in out.stderr
