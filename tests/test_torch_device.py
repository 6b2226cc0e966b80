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

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.export import load_bundle, make_streaming_synth
from ddsp_pytorch_tpu_torch.models import DDSPDecoder, init_params
from ddsp_pytorch_tpu_torch.ops import oscillator as osc
from ddsp_pytorch_tpu_torch.serve import StreamServer
from ddsp_pytorch_tpu_torch.training import Trainer
from ddsp_pytorch_tpu_torch.training.train import loss_and_grads

BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "pretrained", "ddsp_violin_bundle")


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
    ],
    ids=["make_streaming_synth", "explicit-cuda0", "load_bundle", "StreamServer"],
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
        before = osc.oscillator_bank.launches
        got = osc.oscillator_bank(phi, omega, amp, s)
        assert osc.oscillator_bank.launches == before + 1
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
    before = osc.oscillator_bank.launches
    for _ in range(4):
        got = gpu.step_samples(pitch, loud)
        want = cpu.step_samples(pitch, loud)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    assert osc.oscillator_bank.launches == before + 4


def test_trainer_default_device_raises_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Config(), str(tmp_path / "run"))


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
        before = osc.oscillator_bank_bwd.launches
        got = osc.oscillator_bank_bwd(phi, omega, amp, g, s)
        assert osc.oscillator_bank_bwd.launches == before + 1
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

    before = (osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
    gpu_loss, gpu_grads = step(gpu_model, cuda)
    assert (osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches) == (before[0] + 1, before[1] + 1)
    cpu_loss, cpu_grads = step(cpu_model, "cpu")
    names = [n for n, _ in cpu_model.named_parameters()]
    harm = dict(zip(names, gpu_grads))["harmonic_proj.weight"]
    assert float(harm.norm()) > 0
    assert abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    a, b = torch.cat([g.flatten() for g in gpu_grads]), torch.cat([g.flatten() for g in cpu_grads])
    assert float((a - b).norm() / b.norm()) <= 2e-2
    for name, ga, gb in zip(names, gpu_grads, cpu_grads):
        assert float((ga - gb).norm()) <= max(0.1 * float(gb.norm()), 1e-3 * float(b.norm())), name
