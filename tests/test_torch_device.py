"""Entry points default to the GPU and never fall back to the CPU; on a
CUDA card, CUDA tensors go through the hand-written kernels, and a train
step's gradients flow through both of them.

The `cuda`-marked tests skip where torch.cuda.is_available() is False.  This
file imports no JAX, so on a card (where JAX is not installed) they run with

    DDSP_TEST_PLATFORM=cuda python -m pytest tests/test_torch_device.py -m cuda
"""

import copy
import os

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch import bench, performance, resolve_device, soak
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.export import export_run, load_bundle, make_stream_session, make_streaming_synth
from ddsp_pytorch_tpu_torch.models import DDSPDecoder, init_params
from ddsp_pytorch_tpu_torch.ops import kernels, roofline
from ddsp_pytorch_tpu_torch.ops import oscillator as osc
from ddsp_pytorch_tpu_torch.runtime import selftest
from ddsp_pytorch_tpu_torch.serve import StreamServer
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.training.train import loss_and_grads

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launched(name: str) -> int:
    return kernels.counts()[name]["launches"]


BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "pretrained", "ddsp_violin_bundle")
AE_BUNDLE = os.path.join(os.path.dirname(BUNDLE), "ddsp_violin_ae_bundle")
SIGMUND_BUNDLE = os.path.join(os.path.dirname(BUNDLE), "ddsp_sigmund_bundle")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "entry",
    [
        lambda: make_streaming_synth(BUNDLE),
        lambda: make_streaming_synth(BUNDLE, device="cuda:0"),
        lambda: load_bundle(BUNDLE),
        lambda: StreamServer(BUNDLE, port=0),
        lambda: export_run("a-run-directory"),
        lambda: make_stream_session(AE_BUNDLE),
        lambda: StreamServer(BUNDLE, port=0, voices=4),
        lambda: StreamServer(AE_BUNDLE, port=0),
        lambda: performance.run_benchmark(),
        lambda: performance.run_benchmark(BUNDLE),
        lambda: bench.main([]),
        lambda: soak.phase_drift_soak(8192),
        lambda: soak.pool_churn_soak(8192),
        lambda: selftest.main(),
        lambda: selftest.soak(1.0),
    ],
    ids=["make_streaming_synth", "explicit-cuda0", "load_bundle", "StreamServer", "export_run",
         "make_stream_session", "StreamServer-pool", "StreamServer-autoencoder", "run_benchmark",
         "run_benchmark-bundle", "bench", "phase_drift_soak", "pool_churn_soak", "selftest",
         "selftest-soak"],
)
def test_default_device_raises_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda):
    """The hand-written kernel against the plain version on the card, at
    the serving shape and ragged ones: 5e-4, the JAX suite's Pallas-vs-XLA
    bound (tests/test_oscillator.py:156)."""
    rng = np.random.default_rng(6)
    for rows, k, s in ((1, 64, 512), (37, 100, 512), (5, 1, 64)):
        phi = torch.tensor(rng.uniform(0, 2 * np.pi, rows).astype(np.float32), device=cuda)
        omega = torch.tensor(
            (2 * np.pi / 48000 * rng.uniform(50, 2000, rows)).astype(np.float32), device=cuda
        )
        amp = torch.tensor((rng.random((rows, k)) / k).astype(np.float32), device=cuda)
        before = _launched("oscillator_fwd")
        got = osc.oscillator_bank(phi, omega, amp, s)
        assert _launched("oscillator_fwd") == before + 1
        want = osc.oscillator_bank_plain(phi, omega, amp, s)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 5e-4


@pytest.mark.cuda
def test_streaming_on_cuda_launches_kernel_per_block(cuda):
    """Streaming on the card goes through the kernel once per block and
    agrees with the CPU plain path (1e-4, as in chip_smoke.py)."""
    gpu = make_streaming_synth(BUNDLE, device=cuda, noise_deterministic=True)
    cpu = make_streaming_synth(BUNDLE, device="cpu", noise_deterministic=True)
    pitch = np.full((1, 512), 330.0, np.float32)
    loud = np.full((1, 512), -7.0, np.float32)
    before = _launched("oscillator_fwd")
    for _ in range(4):
        got = gpu.step_samples(pitch, loud)
        want = cpu.step_samples(pitch, loud)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    assert _launched("oscillator_fwd") == before + 4


def test_trainer_default_device_raises_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Config(), str(tmp_path / "run"))


def _wav_folder(root) -> Config:
    """data/{train,validation}/a.wav (a 0.3 s tone) and a yin config."""
    from ddsp_pytorch_tpu_torch.utils import save_wav

    for part in ("train", "validation"):
        os.makedirs(root / "data" / part)
        save_wav(str(root / "data" / part / "a.wav"),
                 0.3 * np.sin(2 * np.pi * 220 * np.arange(4800) / 16000), 16000)
    return Config.from_dict({
        "data": {"data_location": str(root / "data")},
        "preprocess": {"sample_rate": 16000, "block_size": 256, "signal_length": 4096,
                       "out_dir": str(root / "cache"), "pitch_tracker": "yin"},
        "model": {"name": "mfcc-autoencoder", "kwargs": dict(TINY)},
    })


def _setup(datamodule):
    datamodule.setup()
    return datamodule


@pytest.mark.parametrize(
    "entry",
    ["Datamodule-device-cache", "Trainer-autoencoder", "make_synthetic_dataset", "extract_loudness",
     "extract_pitch", "preprocess_folder", "preprocess-cli", "train_pretrained-cli", "extract_pitch_crepe",
     "extract_pitch_hybrid", "make_pitch_fn-hybrid", "timbre_transfer", "transfer-cli"],
)
def test_feature_and_training_entry_points_raise_without_cuda(no_cuda, tmp_path, entry):
    """The entry points of the autoencoder's training path default to the
    GPU and raise without one, before writing anything; the Datamodule
    raises where it places data on the device (its device-resident
    loader).  Each takes the plain path only with device='cpu'."""
    from ddsp_pytorch_tpu_torch import preprocess as preprocess_cli
    from ddsp_pytorch_tpu_torch import train_pretrained, transfer
    from ddsp_pytorch_tpu_torch.data import Datamodule, make_synthetic_dataset, preprocess_folder
    from ddsp_pytorch_tpu_torch.data.preprocess import make_pitch_fn
    from ddsp_pytorch_tpu_torch.inference import timbre_transfer
    from ddsp_pytorch_tpu_torch.models.crepe import CREPE, extract_pitch_crepe, extract_pitch_hybrid
    from ddsp_pytorch_tpu_torch.ops import extract_loudness, extract_pitch

    cfg = _wav_folder(tmp_path)
    cfg.to_yaml(str(tmp_path / "cfg.yaml"))
    x = np.zeros(4096, np.float32)
    entries = {
        "Datamodule-device-cache": lambda: _setup(Datamodule(cfg, device_cache=True)).train_dataloader(),
        "Trainer-autoencoder": lambda: Trainer(cfg, str(tmp_path / "run")),
        "make_synthetic_dataset": lambda: make_synthetic_dataset(str(tmp_path / "syn")),
        "extract_loudness": lambda: extract_loudness(x, 16000, 256),
        "extract_pitch": lambda: extract_pitch(x, 16000, 256),
        "preprocess_folder": lambda: preprocess_folder(cfg.data.data_location, "train", cfg),
        "preprocess-cli": lambda: preprocess_cli.main(["--config", str(tmp_path / "cfg.yaml")]),
        "train_pretrained-cli": lambda: train_pretrained.main(
            ["--model", "mfcc-autoencoder", "--root", str(tmp_path / "root"), "--out", str(tmp_path / "out")]),
        "extract_pitch_crepe": lambda: extract_pitch_crepe(x, 16000, 256, CREPE("micro").eval()),
        "extract_pitch_hybrid": lambda: extract_pitch_hybrid(x, 16000, 256, CREPE("micro").eval()),
        "make_pitch_fn-hybrid": lambda: make_pitch_fn(Config.from_dict(
            {"preprocess": {"pitch_tracker": "hybrid"}})),
        "timbre_transfer": lambda: timbre_transfer(SIGMUND_BUNDLE, np.zeros(48000, np.float32), 48000),
        "transfer-cli": lambda: transfer.main(["--bundle", SIGMUND_BUNDLE, "--input", str(tmp_path / "data" / "train"
                                               / "a.wav"), "--output", str(tmp_path / "out.wav")]),
    }
    if entry == "Datamodule-device-cache":
        cfg.preprocess.out_dir = str(tmp_path / "features")
        for part in ("train", "validation"):
            os.makedirs(tmp_path / "features" / part)
            for name in ("signals", "pitchs", "loudness"):
                np.save(tmp_path / "features" / part / f"{name}.npy",
                        np.zeros((2, 4096 if name == "signals" else 16), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entries[entry]()
    for written in ("syn", "cache", "run", "root/runs", "out", "out.wav"):
        assert not (tmp_path / written).exists(), written


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_cuda(cuda):
    """The backward kernel against its plain version on the card, each
    output within 1e-4 of its largest magnitude (f32 sums over the S
    samples in other orders; domega reaches 10^4–10^5)."""
    rng = np.random.default_rng(7)
    for rows, k, s in ((1, 64, 512), (37, 100, 512), (5, 1, 64), (300, 64, 512)):
        phi = torch.tensor(rng.uniform(0, 2 * np.pi, rows).astype(np.float32), device=cuda)
        omega = torch.tensor(
            (2 * np.pi / 48000 * rng.uniform(50, 2000, rows)).astype(np.float32), device=cuda
        )
        amp = torch.tensor((rng.random((rows, k)) / k).astype(np.float32), device=cuda)
        g = torch.tensor(rng.standard_normal((rows, s)).astype(np.float32), device=cuda)
        before = _launched("oscillator_bwd")
        got = osc.oscillator_bank_bwd(phi, omega, amp, g, s)
        assert _launched("oscillator_bwd") == before + 1
        want = osc.oscillator_bank_bwd_plain(phi, omega, amp, g, s)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.device.type == "cuda"
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_gpu_train_step_gradients_reach_harmonic_branch(cuda):
    """A train step on the card launches both kernels once, its harmonic-
    branch gradients are nonzero, and loss and gradients match the CPU
    step from the same weights, batch and noise: loss 1e-4 relative; the
    whole gradient within 2e-2 relative L2 error, each leaf within 0.1 of
    its own norm or 1e-3 of the whole gradient's (chip_smoke.py states why:
    at fresh weights the noise branch's tiny gradient is dominated by f32
    rounding of the oscillator bank)."""
    kw = dict(hidden_size=64, n_harmonic=16, n_bands=17, sample_rate=16000, block_size=128, has_reverb=True)
    frames = 24
    rng = np.random.default_rng(8)
    t = np.arange(frames * kw["block_size"]) / kw["sample_rate"]
    batch = {
        "pitch": rng.uniform(150, 400, (2, frames, 1)).astype(np.float32),
        "loudness": rng.standard_normal((2, frames, 1)).astype(np.float32),
        "sig": (0.3 * np.sin(2 * np.pi * 262.0 * t)[None] + 0.01 * rng.standard_normal((2, t.size))).astype(
            np.float32
        ),
    }
    noise = rng.uniform(-1, 1, (2, frames, kw["block_size"])).astype(np.float32)
    cpu_model = init_params(DDSPDecoder(**kw), torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(cuda)

    def step(model, dev):
        tb = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(model, tb, 0.0, 1.0, [1024, 256], 0.75,
                                     noise=torch.tensor(noise, device=dev))
        return float(loss), [g.detach().cpu().double() for g in grads]

    before = (_launched("oscillator_fwd"), _launched("oscillator_bwd"))
    gpu_loss, gpu_grads = step(gpu_model, cuda)
    assert (_launched("oscillator_fwd"), _launched("oscillator_bwd")) == (before[0] + 1, before[1] + 1)
    cpu_loss, cpu_grads = step(cpu_model, "cpu")
    names = [n for n, _ in cpu_model.named_parameters()]
    harm = dict(zip(names, gpu_grads))["harmonic_proj.weight"]
    assert float(harm.norm()) > 0
    assert abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    a, b = torch.cat([g.flatten() for g in gpu_grads]), torch.cat([g.flatten() for g in cpu_grads])
    assert float((a - b).norm() / b.norm()) <= 2e-2
    for name, ga, gb in zip(names, gpu_grads, cpu_grads):
        assert float((ga - gb).norm()) <= max(0.1 * float(gb.norm()), 1e-3 * float(b.norm())), name


def _rows_on(device, rng, rows, k, s):
    phi = torch.tensor(rng.uniform(0, 2 * np.pi, rows).astype(np.float32), device=device)
    omega = torch.tensor((2 * np.pi / 48000 * rng.uniform(50, 2000, rows)).astype(np.float32), device=device)
    amp = torch.tensor((rng.random((rows, k)) / k).astype(np.float32), device=device)
    g = torch.tensor(rng.standard_normal((rows, s)).astype(np.float32), device=device)
    return phi, omega, amp, g


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 6000])
@pytest.mark.parametrize("k", [64, 100], ids=["K64-template", "runtime-K"])
def test_kernel_variants_match_plain_on_cuda(cuda, rows, k):
    """Both variants of each kernel (the K = 64 template and the runtime-K
    instantiation) in both launch configurations (few rows, many rows)
    against the plain versions: the forward within 5e-4 of the plain
    float32 version.  The backward against the plain version in float64
    (on the CPU), each output relative to its largest magnitude: within
    1e-4, or no further off than twice the plain float32 version is.  A
    row's dphi and domega are sums of S terms that cancel (at R = 1 here
    Σ|dθ_i| is ~150 times |dphi|), where two float32 summation orders
    differ by more than 1e-4 while neither is more accurate."""
    rng = np.random.default_rng(rows + k)
    phi, omega, amp, g = _rows_on(cuda, rng, rows, k, 512)
    before = (_launched("oscillator_fwd"), _launched("oscillator_bwd"))
    y = osc.oscillator_bank(phi, omega, amp, 512)
    grads = osc.oscillator_bank_bwd(phi, omega, amp, g, 512)
    assert (_launched("oscillator_fwd"), _launched("oscillator_bwd")) == (before[0] + 1, before[1] + 1)
    y_plain = osc.oscillator_bank_plain(phi, omega, amp, 512)
    grads_plain = osc.oscillator_bank_bwd_plain(phi, omega, amp, g, 512)
    grads_64 = osc.oscillator_bank_bwd_plain(*(t.cpu().double() for t in (phi, omega, amp, g)), 512)
    torch.cuda.synchronize()
    assert float((y - y_plain).abs().max()) <= 5e-4
    for a, b, ref in zip(grads, grads_plain, grads_64):
        assert bool(torch.isfinite(a).all())
        scale = float(ref.abs().max())
        err = float((a.cpu().double() - ref).abs().max()) / scale
        plain_err = float((b.cpu().double() - ref).abs().max()) / scale
        assert err <= max(1e-4, 2.0 * plain_err), (err, plain_err)


@pytest.mark.cuda
def test_cuda_wrappers_take_float32_only(cuda):
    """float64 is for the plain versions on the CPU; on the card the
    wrappers raise rather than convert."""
    phi, omega, amp, g = (t.double() for t in _rows_on(cuda, np.random.default_rng(9), 3, 8, 64))
    with pytest.raises(TypeError):
        osc.oscillator_bank(phi, omega, amp, 64)
    with pytest.raises(TypeError):
        osc.oscillator_bank_bwd(phi, omega, amp, g, 64)


TINY = dict(hidden_size=32, n_harmonic=8, n_bands=9, sample_rate=16000, block_size=128, has_reverb=True)
TINY_FRAMES = 16
# graphed against eager steps on the card, each parameter leaf and each
# step's loss relative to its own magnitude: the same kernels on the same
# inputs
GRAPHED_REL = 1e-6


def _tiny_config(**train):
    return Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": TINY_FRAMES * 128, "block_size": 128},
        "model": {"name": "single-inst-decoder", "kwargs": dict(TINY)},
        "train": {"scales": [512, 128], "overlap": 0.75, "batch": 2, "lr": 1e-3, **train},
    })


def _tiny_data(device, n_items=6, seed=11):
    rng = np.random.default_rng(seed)
    t = np.arange(TINY_FRAMES * 128) / 16000
    f0 = rng.uniform(150, 400, (n_items, 1))
    return {
        "pitch": torch.tensor(np.repeat(f0, TINY_FRAMES, 1)[..., None].astype(np.float32), device=device),
        "loudness": torch.tensor(rng.standard_normal((n_items, TINY_FRAMES, 1)).astype(np.float32), device=device),
        "sig": torch.tensor((0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32), device=device),
    }


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 2])
def test_graphed_steps_equal_eager_steps_on_cuda(cuda, unroll):
    """4 steps as CUDA-graph replays of `unroll` captured steps against 4
    eager steps from the same state, batches and generator: the same
    per-step losses and parameters (GRAPHED_REL), the same generator state,
    the warm-up leaving no trace; the launches counted on capture and
    replay."""
    from ddsp_pytorch_tpu_torch.training import make_optimizer
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import (
        WARMUP_RUNS, make_train_multi_step_indexed, make_train_step, metrics_row,
    )

    cfg = _tiny_config()
    data = _tiny_data(cuda)
    idx2d = np.random.default_rng(3).integers(0, 6, (4, 2))
    base = init_params(DDSPDecoder(**TINY), torch.Generator().manual_seed(0)).to(cuda)

    def fresh():
        model = copy.deepcopy(base)
        tx = make_optimizer(cfg)
        state = TrainState(0, model, tx.init([p for _, p in model.named_parameters()]),
                           torch.Generator(cuda).manual_seed(5), -1.0, 1.5)
        return model, tx, state

    model_e, tx_e, state_e = fresh()
    step = make_train_step(model_e, tx_e, cfg)
    eager = torch.stack([
        metrics_row(step(state_e, {k: v.index_select(0, torch.as_tensor(i, device=cuda))
                                   for k, v in data.items()}))
        for i in idx2d
    ])
    model_g, tx_g, state_g = fresh()
    multi = make_train_multi_step_indexed(model_g, tx_g, cfg, 4, unroll)
    kernels.reset_counts()
    graphed = multi(state_g, data, idx2d)
    torch.cuda.synchronize()
    assert state_g.step == state_e.step == 4
    assert _rel(graphed[:, 0], eager[:, 0]) <= GRAPHED_REL
    for (name, a), b in zip(model_g.named_parameters(), model_e.parameters()):
        assert _rel(a.detach(), b.detach()) <= GRAPHED_REL, name
    assert torch.equal(state_g.generator.get_state(), state_e.generator.get_state())
    # a step: one launch of each oscillator and GRU kernel, the fused
    # loss's framing, loss-and-gradient and overlap-add once a scale (two)
    # and its sum once, and Adam's norm and update once
    per_step = {"oscillator_fwd": 1, "oscillator_bwd": 1, "gru_fwd": 1, "gru_bwd": 1,
                "stft_frame": 2, "stft_loss_grad": 2, "stft_rave_norms": 0, "stft_rave_loss_grad": 0,
                "stft_loss_sum": 1, "stft_overlap_add": 2, "adam_norm": 1, "adam_update": 1}
    assert multi.captured == {name: n * unroll for name, n in per_step.items()}
    assert multi.replays == 4 // unroll
    counts = kernels.counts()
    for name in kernels.MODEL_KERNELS:
        n = per_step[name]
        assert counts[name] == {"launches": WARMUP_RUNS * unroll * n, "captured": unroll * n, "replayed": 4 * n}
    more = multi(state_g, data, idx2d)  # the next call replays the same graph
    assert bool(torch.isfinite(more).all()) and multi.replays == 8 // unroll
    with pytest.raises(RuntimeError, match="captured for other"):
        multi(fresh()[2], data, idx2d)


@pytest.mark.cuda
def test_graphed_trainer_equals_eager_trainer_on_cuda(cuda, tmp_path):
    """Trainer.fit with steps_per_call 4 (graphed; with the device cache,
    and with the host loader's staged super-batches) against
    steps_per_call 1 (eager, host loader) on the card: the same losses and
    parameters (GRAPHED_REL), the same generator state."""
    from ddsp_pytorch_tpu_torch.data import Datamodule
    from ddsp_pytorch_tpu_torch.training.metrics import read_metrics

    cache = tmp_path / "cache"
    data = {k: v.cpu().numpy()[..., 0] if k != "sig" else v.cpu().numpy() for k, v in _tiny_data(cuda).items()}
    for part in ("train", "validation"):
        (cache / part).mkdir(parents=True)
        for name, key in (("signals", "sig"), ("pitchs", "pitch"), ("loudness", "loudness")):
            np.save(cache / part / f"{name}.npy", data[key])

    def fit(name, device_cache, **train):
        cfg = _tiny_config(steps=10, val_interval_epochs=2, checkpoint_every_steps=0, **train)
        cfg.preprocess.out_dir = str(cache)
        dm = Datamodule(cfg, device_cache=device_cache, device=cuda)
        dm.setup()
        trainer = Trainer(cfg, str(tmp_path / name), device=cuda)
        state = trainer.fit(dm)
        trainer.close()
        return trainer, state, [v for _, v in read_metrics(str(tmp_path / name), "loss")]

    _, eager, eager_losses = fit("eager", False)
    for device_cache in (True, False):
        trainer, graphed, graphed_losses = fit(f"graphed_{device_cache}", device_cache,
                                               steps_per_call=4, scan_unroll=2)
        assert trainer._multi_step.indexed == device_cache
        assert trainer._multi_step.replays == 4  # 8 steps in 2 calls; the last 2 run single
        assert graphed.step == eager.step == 10
        np.testing.assert_allclose(graphed_losses, eager_losses, rtol=GRAPHED_REL)
        for (name, a), b in zip(graphed.model.named_parameters(), eager.params()):
            assert _rel(a.detach(), b.detach()) <= GRAPHED_REL, name
        assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())


@pytest.mark.cuda
def test_host_batch_stager_on_cuda(cuda):
    """The pinned staging path gives what a pageable copy gives, reusing
    one buffer per key and shape."""
    from ddsp_pytorch_tpu_torch.training.train import HostBatchStager, to_device

    stager = HostBatchStager(cuda)
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = {"sig": rng.standard_normal((2, 256)).astype(np.float32),
                 "pitch": rng.standard_normal((2, 4, 1))}
        got, want = stager(batch), to_device(batch, cuda)
        for k in batch:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k])
    assert len(stager._pinned) == 2


def test_measurement_entry_points_need_a_card(no_cuda):
    from ddsp_pytorch_tpu_torch import bench_roofline, profile_serving

    for main, argv in ((bench_roofline.main, []), (profile_serving.main, ["--voices", "1,8"])):
        with pytest.raises(SystemExit, match="CUDA"):
            main(argv)


@pytest.mark.cuda
def test_roofline_probes_match_plain_on_cuda(cuda):
    """Both probe kernels against their plain versions on the script's
    input: the fma chain bit for bit (c rounds to 1, so one rounding of
    c·s − p equals two), the sin chain within 1e-6 (sinf from two
    libraries); each launch counted once; every block size the sweep
    times gives the default's output bit for bit."""
    x = roofline.probe_input(device=cuda)
    for name, fn, plain, atol in (("roofline_fma", roofline.fma_chain, roofline.fma_chain_plain, 0.0),
                                  ("roofline_sin", roofline.sin_chain, roofline.sin_chain_plain, 1e-6)):
        before = _launched(name)
        got = fn(x)
        assert _launched(name) == before + 1
        want = plain(x)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= atol
        for threads in roofline.BLOCK_SIZES:
            assert torch.equal(fn(x, threads=threads), got)


@pytest.mark.cuda
@pytest.mark.parametrize("include_reverb", [False, True], ids=["dry", "reverb"])
def test_voice_pool_on_cuda_matches_cpu(cuda, include_reverb):
    """A pool of 3 violin voices on the card against the same pool on the
    CPU (deterministic noise): 1e-4, and 1e-3 of the peak, as chip_smoke.py."""
    from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool

    pools = [VoicePool(make_streaming_synth(BUNDLE, batch=3, device=d, noise_deterministic=True,
                                            include_reverb=include_reverb)) for d in (cuda, "cpu")]
    slots = [[p.acquire() for _ in range(3)] for p in pools]
    assert slots[0] == slots[1]
    rng = np.random.default_rng(9)
    before = _launched("oscillator_fwd")
    err = peak = 0.0
    for _ in range(8):
        reqs = {s: (rng.uniform(200, 800, (1, 1)).astype(np.float32),
                    rng.uniform(-9, -6, (1, 1)).astype(np.float32)) for s in slots[0]}
        got, want = (p.step(reqs) for p in pools)
        err = max(err, max(float(np.abs(got[s] - want[s]).max()) for s in reqs))
        peak = max(peak, max(float(np.abs(got[s]).max()) for s in reqs))
    assert _launched("oscillator_fwd") == before + 8
    assert err <= 1e-4 and err <= 1e-3 * peak


@pytest.mark.cuda
def test_autoencoder_session_on_cuda_matches_cpu(cuda):
    sessions = [make_stream_session(AE_BUNDLE, device=d, noise_deterministic=True) for d in (cuda, "cpu")]
    t = np.arange(8 * 512) / 48000
    x = (0.3 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    pitch, loud = np.full(512, 330.0, np.float32), np.full(512, -7.0, np.float32)
    outs = [[s.step_samples(pitch, loud, x[i * 512:(i + 1) * 512]) for i in range(8)] for s in sessions]
    got, want = np.concatenate(outs[0]), np.concatenate(outs[1])
    peak = float(np.abs(got).max())
    assert peak > 1e-3
    assert float(np.abs(got - want).max()) <= min(1e-4, 1e-3 * peak)


@pytest.mark.cuda
def test_autoencoder_graphed_steps_equal_eager_steps_on_cuda(cuda):
    """The AE's train step with `mfcc` gathered inside the graph: 4 replayed
    steps against 4 eager ones (GRAPHED_REL), the oscillator's and the two
    GRUs' kernels captured."""
    from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder
    from ddsp_pytorch_tpu_torch.training import make_optimizer
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import (
        make_train_multi_step_indexed, make_train_step, metrics_row,
    )

    cfg = _tiny_config()
    cfg.model.name = "mfcc-autoencoder"
    data = _tiny_data(cuda)
    data["mfcc"] = torch.tensor(np.random.default_rng(2).standard_normal((6, TINY_FRAMES, 30)).astype(np.float32),
                                device=cuda)
    idx2d = np.random.default_rng(3).integers(0, 6, (4, 2))
    base = init_params(DDSPAutoencoder(**TINY), torch.Generator().manual_seed(0)).to(cuda)

    def fresh():
        model = copy.deepcopy(base)
        tx = make_optimizer(cfg)
        state = TrainState(0, model, tx.init([p for _, p in model.named_parameters()]),
                           torch.Generator(cuda).manual_seed(5), -1.0, 1.5)
        return model, tx, state

    model_e, tx_e, state_e = fresh()
    step = make_train_step(model_e, tx_e, cfg)
    eager = torch.stack([metrics_row(step(state_e, {k: v[torch.as_tensor(i, device=cuda)] for k, v in data.items()}))
                         for i in idx2d])
    model_g, tx_g, state_g = fresh()
    multi = make_train_multi_step_indexed(model_g, tx_g, cfg, 4, 2)
    graphed = multi(state_g, data, idx2d)
    assert _rel(graphed[:, 0], eager[:, 0]) <= GRAPHED_REL
    for (name, a), b in zip(model_g.named_parameters(), model_e.parameters()):
        assert _rel(a.detach(), b.detach()) <= GRAPHED_REL, name
    # a step holds one launch of each oscillator kernel, for the encoder's
    # GRU and the decoder's two of each GRU kernel, the fused loss's
    # kernels once a scale (two) but its sum once, and Adam's two once
    assert multi.captured == {"oscillator_fwd": 2, "oscillator_bwd": 2, "gru_fwd": 4, "gru_bwd": 4,
                              "stft_frame": 4, "stft_loss_grad": 4, "stft_rave_norms": 0,
                              "stft_rave_loss_grad": 0, "stft_loss_sum": 2, "stft_overlap_add": 4,
                              "adam_norm": 2, "adam_update": 2}


@pytest.mark.cuda
def test_features_on_cuda_match_cpu(cuda, tmp_path):
    """Loudness, pitch and the synthetic corpus on the card against the
    plain CPU path: loudness 1e-3, f0 1e-3 relative, the corpus's pitch
    bitwise and its audio within 1e-4 of the peak."""
    from ddsp_pytorch_tpu_torch.data import make_synthetic_dataset
    from ddsp_pytorch_tpu_torch.ops import extract_loudness, extract_pitch

    kw = dict(n_items=3, sample_rate=16000, signal_length=16384, block_size=256, n_harmonic=8,
              instrument="violin", mfcc_ref_db=0.0, partitions=("train",))
    kernels.reset_counts()
    gpu = make_synthetic_dataset(str(tmp_path / "gpu"), device=cuda, **kw)
    assert _launched("oscillator_fwd") == 1  # every item of the partition in one launch
    cpu = make_synthetic_dataset(str(tmp_path / "cpu"), device="cpu", **kw)
    np.testing.assert_array_equal(gpu["pitchs"], cpu["pitchs"])
    peak = float(np.abs(cpu["signals"]).max())
    assert float(np.abs(gpu["signals"] - cpu["signals"]).max()) <= 1e-4 * peak
    x = cpu["signals"]
    np.testing.assert_allclose(extract_loudness(x, 16000, 256, device=cuda).cpu().numpy(),
                               extract_loudness(x, 16000, 256, device="cpu").numpy(), atol=1e-3)
    np.testing.assert_allclose(extract_pitch(x, 16000, 256, device=cuda).cpu().numpy(),
                               extract_pitch(x, 16000, 256, device="cpu").numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_crepe_on_cuda_ignores_global_tf32(cuda):
    """The shipped CREPE on the card equals the CPU (salience within 1e-5,
    logits within 1e-4) with TF32 allowed globally for cuDNN and cuBLAS:
    the forward scopes both off itself.  The flags are restored."""
    from ddsp_pytorch_tpu_torch.models.crepe import load_crepe

    shipped = os.path.join(os.path.dirname(BUNDLE), "crepe_tiny.msgpack")
    frames = torch.tensor(np.random.default_rng(9).standard_normal((256, 1024)).astype(np.float32))
    with torch.no_grad():
        want = load_crepe(shipped, device="cpu")(frames)
        gpu = load_crepe(shipped, device=cuda)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = gpu(frames.to(cuda)).cpu()
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    assert float((got - want).abs().max()) <= 1e-4
    assert float((torch.sigmoid(got) - torch.sigmoid(want)).abs().max()) <= 1e-5


@pytest.mark.parametrize(
    "entry",
    ["train_oof-cli", "train_sigmund-cli", "train_crepe-cli", "train_crepe.train", "pitch_accuracy-cli",
     "pitch_accuracy-robustness", "tune_hybrid_pitch-cli", "train-segmented", "profiling.trace"],
)
def test_evidence_path_entry_points_raise_without_cuda(no_cuda, tmp_path, entry):
    """The out-of-family evidence path's entry points (the fixture corpus
    trained, scored and swept, CREPE trained, segmented and profiled runs)
    default to the GPU and raise without one, before writing anything."""
    from ddsp_pytorch_tpu_torch import pitch_accuracy, train, train_crepe, train_oof, train_sigmund, tune_hybrid_pitch
    from ddsp_pytorch_tpu_torch.training import profiling

    cfg = _wav_folder(tmp_path)
    cfg.to_yaml(str(tmp_path / "cfg.yaml"))
    root, out = str(tmp_path / "root"), str(tmp_path / "out")
    entries = {
        "train_oof-cli": lambda: train_oof.main(["--root", root, "--out", out]),
        "train_sigmund-cli": lambda: train_sigmund.main(["--root", root, "--out", out]),
        "train_crepe-cli": lambda: train_crepe.main(["--out", os.path.join(out, "c.msgpack")]),
        "train_crepe.train": lambda: train_crepe.train("micro", steps=1),
        "pitch_accuracy-cli": lambda: pitch_accuracy.main(["--out", os.path.join(out, "pa.json")]),
        "pitch_accuracy-robustness": lambda: pitch_accuracy.robustness_report(16000, 256, None, "tiny"),
        "tune_hybrid_pitch-cli": lambda: tune_hybrid_pitch.main(["--cache", root, "--out", out]),
        "train-segmented": lambda: train.main(["--config", str(tmp_path / "cfg.yaml"), "--root", root,
                                               "--segment-steps", "2"]),
        "profiling.trace": lambda: profiling.trace(os.path.join(out, "trace")).__enter__(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entries[entry]()
    assert not os.path.exists(root) and not os.path.exists(out)


@pytest.mark.cuda
def test_crepe_train_step_on_cuda_matches_cpu(cuda):
    """One train-mode CREPE step (micro, batch 8) on the card against the
    CPU from the same weights, draws and dropout masks: the loss and the
    updated batch statistics within 1e-5, every gradient leaf within 1e-4
    of its largest magnitude (cuDNN's convolution sums in other orders)."""
    from ddsp_pytorch_tpu_torch import train_crepe
    from ddsp_pytorch_tpu_torch.models.crepe import CREPE
    from ddsp_pytorch_tpu_torch.training.optim import Optimizer

    cpu_model = train_crepe.init_crepe(CREPE("micro"), torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    frames, f0 = train_crepe.synth_batch(train_crepe.draw_synth_inputs(8, torch.Generator().manual_seed(1)))
    target = train_crepe.f0_to_target(f0)
    gen = torch.Generator().manual_seed(2)
    masks = [torch.rand(s, generator=gen) < 0.75 for s in cpu_model.block_shapes(8)]
    results = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
        tx = Optimizer("adam", 2e-3)
        loss, grads, _ = train_crepe.train_step(model, tx, tx.init(list(model.parameters())), frames.to(dev),
                                                target.to(dev), 20.0, dropout_masks=[m.to(dev) for m in masks])
        results.append((float(loss), [g.cpu() for g in grads],
                        {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}))
    (want_loss, want_grads, want_stats), (loss, grads, stats) = results
    assert abs(loss - want_loss) <= 1e-5
    for g, w in zip(grads, want_grads):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    for k, v in want_stats.items():
        assert float((stats[k] - v).abs().max()) <= 1e-5, k


@pytest.mark.parametrize("entry", ["time_sharded_trajectory", "time_sharded_trajectory-cli",
                                   "train-cli-multihost", "Trainer-mesh"])
def test_parallel_entry_points_raise_without_cuda(no_cuda, tmp_path, entry):
    """The parallel layer's entry points default to the GPU and raise
    without one, before writing anything or joining a process group."""
    from ddsp_pytorch_tpu_torch import time_sharded_trajectory
    from ddsp_pytorch_tpu_torch import train as train_cli
    from ddsp_pytorch_tpu_torch.parallel import make_mesh

    cfg_path = os.path.join(os.path.dirname(BUNDLE), "..", "configs", "config_timesharded.yaml")
    entries = {
        "time_sharded_trajectory": lambda: time_sharded_trajectory.run_trajectories(
            cache_dir=str(tmp_path / "cache")),
        "time_sharded_trajectory-cli": lambda: time_sharded_trajectory.main(["--out", str(tmp_path / "r.json")]),
        "train-cli-multihost": lambda: train_cli.main(["--config", cfg_path, "--multihost", "--root",
                                                       str(tmp_path / "runs")]),
        "Trainer-mesh": lambda: Trainer(Config.from_yaml(cfg_path), str(tmp_path / "run"), mesh=make_mesh(1, 4)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entries[entry]()
    for written in ("cache", "r.json", "runs", "run"):
        assert not (tmp_path / written).exists(), written


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1536, 6144])
def test_kernels_at_sharded_row_counts_on_cuda(cuda, rows):
    """Both kernels at the time-sharded step's rows (16 × 96 a rank with one
    shard a rank, 4 × 16 × 96 with the shards stacked) against their plain
    versions, at test_kernel_variants_match_plain_on_cuda's bounds."""
    rng = np.random.default_rng(rows)
    phi, omega, amp, g = _rows_on(cuda, rng, rows, 64, 512)
    before = (_launched("oscillator_fwd"), _launched("oscillator_bwd"))
    y = osc.oscillator_bank(phi, omega, amp, 512)
    grads = osc.oscillator_bank_bwd(phi, omega, amp, g, 512)
    assert (_launched("oscillator_fwd"), _launched("oscillator_bwd")) == (before[0] + 1, before[1] + 1)
    y_plain = osc.oscillator_bank_plain(phi, omega, amp, 512)
    grads_plain = osc.oscillator_bank_bwd_plain(phi, omega, amp, g, 512)
    grads_64 = osc.oscillator_bank_bwd_plain(*(t.cpu().double() for t in (phi, omega, amp, g)), 512)
    torch.cuda.synchronize()
    assert float((y - y_plain).abs().max()) <= 5e-4
    for a, b, ref in zip(grads, grads_plain, grads_64):
        scale = float(ref.abs().max())
        err = float((a.cpu().double() - ref).abs().max()) / scale
        plain_err = float((b.cpu().double() - ref).abs().max()) / scale
        assert err <= max(1e-4, 2.0 * plain_err), (err, plain_err)


@pytest.mark.cuda
def test_time_sharded_step_on_cuda_matches_cpu(cuda):
    """The time-sharded step (data 2 × time 4 in process, 71 frames padded to
    80, reverb) on the card against the same step on the CPU, same weights,
    batch and noise: one launch of each kernel; the loss within 1e-4
    relative and the whole gradient within 2e-2 relative L2 (chip_smoke.py
    phase 5's bounds for a step on the card against the CPU)."""
    from ddsp_pytorch_tpu_torch.parallel import make_mesh
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import make_loss_and_grads

    cfg = Config.from_dict({
        "preprocess": {"sample_rate": 16000, "signal_length": 4544, "block_size": 64},
        "model": {"name": "single-inst-decoder", "kwargs": {
            "hidden_size": 32, "n_harmonic": 8, "n_bands": 9, "sample_rate": 16000, "block_size": 64,
            "has_reverb": True}},
        "train": {"scales": [512, 256], "overlap": 0.75, "batch": 4}})
    rng = np.random.default_rng(0)
    t = np.arange(4544) / 16000
    batch = {"sig": (0.3 * np.sin(2 * np.pi * 220 * t)[None] + 0.01 * rng.standard_normal((4, 4544))),
             "pitch": rng.uniform(150, 350, (4, 71, 1)), "loudness": rng.standard_normal((4, 71, 1)) - 4.0}
    noise = rng.uniform(-1, 1, (4, 71, 64))
    cpu_model = init_params(DDSPDecoder(**cfg.model.kwargs), torch.Generator().manual_seed(0))
    out = {}
    for dev, model in (("cpu", cpu_model), (cuda, copy.deepcopy(cpu_model).to(cuda))):
        tb = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}
        state = TrainState(0, model, {}, torch.Generator(dev), -4.0, 1.0)
        before = (_launched("oscillator_fwd"), _launched("oscillator_bwd"))
        loss, grads = make_loss_and_grads(model, cfg, make_mesh(2, 4))(
            state, tb, torch.tensor(noise, dtype=torch.float32, device=dev))
        launched = (_launched("oscillator_fwd") - before[0], _launched("oscillator_bwd") - before[1])
        out[str(dev)] = (float(loss), torch.cat([g.flatten().cpu().double() for g in grads]), launched)
    (loss_c, g_c, launched_c), (loss_g, g_g, launched_g) = out["cpu"], out[str(cuda)]
    assert launched_c == (0, 0) and launched_g == (1, 1)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    assert float((g_g - g_c).norm() / g_c.norm()) <= 2e-2
