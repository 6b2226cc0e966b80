"""Entry points default to the GPU and never fall back to the CPU; on a
CUDA card, CUDA tensors go through the hand-written kernel.

The `cuda`-marked tests skip where torch.cuda.is_available() is False.  This
file imports no JAX, so on a card (where JAX is not installed) they run with

    DDSP_TEST_PLATFORM=cuda python -m pytest tests/test_torch_device.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.export import load_bundle, make_streaming_synth
from ddsp_pytorch_tpu_torch.ops import oscillator as osc
from ddsp_pytorch_tpu_torch.serve import StreamServer

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
