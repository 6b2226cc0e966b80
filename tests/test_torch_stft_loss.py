"""The train step's fused multiscale spectral loss (ops/stft_loss.py) and
its kernels' plain versions, against the plain path
(training/loss.py spectral_loss_from_signals).

On the CPU: `MultiscaleSpectralLoss` through the plain versions, pass for
pass as the kernels run (the reflect-indexed framing, rfft, the combined
loss-and-gradient with its C2R weighting, irfft, the gathered
overlap-add), equals the plain path in float64: the loss to LOSS_REL and
the reconstruction's gradient to GRAD_REL of its largest magnitude (the
same sums in other orders), over scales 128–4096, overlaps 0.75 and 0.5, a
hop that does not divide n, T just above n/2, an odd n, and bins where
|S_x| = |S_y| or |S| = 0.  The dispatch: the CPU, float64 and calls
without gradients take the plain path and never reach a kernel launcher.

The `cuda`-marked tests skip where torch.cuda.is_available() is False.
This file imports no JAX; on a card they run with

    DDSP_TEST_PLATFORM=cuda python -m pytest tests/test_torch_stft_loss.py -m cuda

Their tolerances, float32 on the card:
  * the framing kernel equals its plain version bit for bit (one product
    of the same two floats);
  * the loss-and-gradient and overlap-add kernels within KERNEL_REL of
    their plain versions' largest magnitude (hypotf, logf and FMA
    contraction against torch's elementwise kernels);
  * at the published shape (B 16 × 192 000, six scales), the fused loss and
    gradient against the CPU's float64 plain path: the loss within
    CARD_LOSS_REL; the gradient's 90th percentile of |g − g₆₄| no more than
    FUSED_OVER_PLAIN times the float32 plain path's.  Its 1/|S_y| weights
    make the float32 rounding of a few small bins dominate any norm of the
    error (a relative L2 of 4e-4 to 1e-2 on either path, their ratio 0.1
    to 2 from seed to seed), while the percentile reads 0.7–0.9 of the
    plain path's on every seed tried (CPU, float32);
  * bitwise where the kernels promise it: two calls, and a graph replay
    against eager.
"""

import types

import pytest
import torch

from ddsp_pytorch_tpu_torch.ops import kernels, stft, stft_loss
from ddsp_pytorch_tpu_torch.training import loss as loss_mod

LOSS_REL = 1e-12
GRAD_REL = 1e-10
KERNEL_REL = 1e-5
FUSED_OVER_PLAIN = 1.5
CARD_LOSS_REL = 1e-5
SCALES = (4096, 2048, 1024, 512, 256, 128)
CELL_BATCH, CELL_SAMPLES = 16, 192_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _signals(b, t, seed, dtype=torch.float64, device="cpu"):
    """A tone plus noise, target and reconstruction of one pitch apart."""
    g = torch.Generator().manual_seed(seed)
    n = torch.arange(t, dtype=torch.float64) / 16000.0
    f0 = 100.0 + 700.0 * torch.rand((b, 1), generator=g, dtype=torch.float64)
    x = 0.5 * torch.sin(2 * torch.pi * f0 * n) + 0.05 * torch.randn((b, t), generator=g, dtype=torch.float64)
    y = 0.4 * torch.sin(2 * torch.pi * 1.01 * f0 * n) + 0.05 * torch.randn((b, t), generator=g,
                                                                             dtype=torch.float64)
    return x.to(device, dtype), y.to(device, dtype)


def _loss_and_grad(fn, x, y, scales, overlap):
    yy = y.detach().clone().requires_grad_(True)
    loss = fn(x, yy, scales, overlap)
    (grad,) = torch.autograd.grad(loss, yy)
    return loss.detach(), grad


def _plain(x, y, scales, overlap):
    """(loss, gradient of y) of the plain path."""
    return _loss_and_grad(lambda *a: loss_mod.spectral_loss_from_signals(*a)[0], x, y, scales, overlap)


def _both(x, y, scales, overlap):
    """(loss, gradient of y) of the fused function and of the plain path."""
    return (_loss_and_grad(stft_loss.multiscale_spectral_loss, x, y, scales, overlap),
            _plain(x, y, scales, overlap))


def _error_q90(got, want):
    """The 90th percentile of |got − want| over want's RMS."""
    err = (got - want).abs().flatten() / want.pow(2).mean().sqrt()
    return float(torch.quantile(err, torch.tensor(0.9, dtype=err.dtype)))


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


# (B, T, scales, overlap): the published six scales; overlap 0.5; hops
# that do not divide n (0.7: 153 and 38); T just above n/2 for the reflect
# pad; an odd n (no Nyquist bin)
CASES = [
    (2, 9000, SCALES, 0.75),
    (2, 3000, (512, 256, 128), 0.5),
    (2, 3000, (512, 128), 0.7),
    (1, 65, (128,), 0.75),
    (1, 2049, (4096,), 0.75),
    (3, 300, (129,), 0.6),
]
IDS = [f"B{b}-T{t}-{'.'.join(map(str, s))}-ov{o}" for b, t, s, o in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_dataflow_equals_plain_path_float64(case):
    b, t, scales, overlap = case
    x, y = _signals(b, t, seed=t)
    (loss, grad), (want_loss, want_grad) = _both(x, y, scales, overlap)
    assert loss.dtype == torch.float64 and grad.shape == y.shape
    assert abs(float(loss - want_loss)) <= LOSS_REL * float(want_loss)
    assert _rel(grad, want_grad) <= GRAD_REL


def test_ties_and_silent_frames_float64():
    """Where target and reconstruction share frames every bin ties
    (|S_x| = |S_y|: sgn 0) and where both are silent |S| = 0: the gradient
    there is 0 on both paths; where only the reconstruction is silent its
    gradient is 0 too (Y/|Y| = 0)."""
    x, _ = _signals(2, 4096, seed=11)
    y = x.clone()
    y[:, 1000:2000] = _signals(2, 1000, seed=12)[1]
    y[:, 3000:] = 0.0
    x[:, 3300:] = 0.0
    (loss, grad), (want_loss, want_grad) = _both(x, y, (512, 256, 128), 0.75)
    assert abs(float(loss - want_loss)) <= LOSS_REL * float(want_loss)
    assert _rel(grad, want_grad) <= GRAD_REL
    assert float(grad[:, :500].abs().max()) == 0.0 == float(want_grad[:, :500].abs().max())
    assert float(stft_loss.multiscale_spectral_loss(x, x, (256,), 0.75)) == 0.0


@pytest.mark.parametrize("n, hop, t", [(128, 32, 1000), (129, 51, 300), (4096, 1024, 2049)])
def test_plain_framing_is_pad_unfold_and_window(n, hop, t):
    """The reflect-indexed frames equal F.pad(reflect) → unfold → × Hann ×
    n^-1/2, and the spectra their rfft (the plain STFT before its abs)."""
    x, y = _signals(2, t, seed=n)
    c = stft_loss.window_constant(n, torch.float64, torch.device("cpu"))
    frames = stft_loss.stft_frame(x, y, c, hop)
    pad = n // 2
    padded = torch.nn.functional.pad(torch.cat([x, y])[:, None], (pad, pad), mode="reflect")[:, 0]
    want = padded.unfold(-1, n, hop) * c
    assert frames.shape == (4, stft_loss.n_frames(t, n, hop), n)
    torch.testing.assert_close(frames, want, rtol=0, atol=0)
    mags = torch.fft.rfft(frames, dim=-1).abs().transpose(-1, -2)
    torch.testing.assert_close(mags[:2], stft(x, n, hop), rtol=1e-12, atol=1e-14)


def test_partials_sum_to_each_scales_loss():
    """The loss-and-gradient pass's partials, in the kernel's grid-stride
    blocks, sum to the scale's mean|ΔS| + mean|Δlog S|."""
    x, y = _signals(2, 5000, seed=3)
    n, hop = 256, 64
    c = stft_loss.window_constant(n, torch.float64, torch.device("cpu"))
    spec = torch.fft.rfft(stft_loss.stft_frame(x, y, c, hop), dim=-1)
    count = spec.numel() // 2
    partials = torch.full((stft_loss.loss_blocks(count),), float("nan"), dtype=torch.float64)
    stft_loss.stft_loss_grad(spec, n, partials)
    want = loss_mod.multiscale_spec_loss([stft(x, n, hop)], [stft(y, n, hop)])
    assert partials.shape[0] == min(-(-count // stft_loss.LOSS_THREADS), stft_loss.LOSS_MAX_BLOCKS) > 1
    assert abs(float(stft_loss.stft_loss_sum(partials, torch.float64)) - float(want)) <= LOSS_REL * float(want)


def _no_launch(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name} launched on a plain path")

    monkeypatch.setattr(kernels, "launcher", refuse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_cpu_takes_the_plain_path(monkeypatch, dtype):
    """On the CPU the train step's loss is the plain path's, bit for bit,
    and no stft_* kernel is counted, neither there nor through the fused
    loss's plain versions."""
    _no_launch(monkeypatch)
    stft_names = [name for name in kernels.KERNELS if name.startswith("stft_")]
    before = kernels.counts()
    x, y = _signals(2, 3000, seed=5, dtype=dtype)
    y.requires_grad_(True)
    loss = loss_mod.spectral_loss(x, y, (512, 256), 0.75)
    want = loss_mod.spectral_loss_from_signals(x, y, (512, 256), 0.75)[0]
    assert torch.equal(loss, want) and loss.requires_grad
    assert not loss_mod.fused_takes(x, y)
    stft_loss.multiscale_spectral_loss(x, y, (512, 256), 0.75).backward()  # plain versions
    stft_loss.multiscale_spectral_loss(x, y, (512, 256), 0.75, "rave").backward()
    after = kernels.counts()
    assert len(stft_names) == 6 and all(after[name] == before[name] for name in stft_names)


# (on the card, dtype, gradients enabled, target wants a gradient) → fused
@pytest.mark.parametrize("cuda_, dtype, grad, target_grad, takes", [
    (True, torch.float32, True, False, True),
    (True, torch.bfloat16, True, False, True),   # a bf16 model's signal, promoted
    (True, torch.float64, True, False, False),
    (False, torch.float32, True, False, False),
    (True, torch.float32, False, False, False),  # the eval step: no gradients
    (True, torch.float32, True, True, False),
])
def test_fused_takes(cuda_, dtype, grad, target_grad, takes):
    rec = types.SimpleNamespace(is_cuda=cuda_, dtype=dtype)
    target = types.SimpleNamespace(requires_grad=target_grad)
    with torch.set_grad_enabled(grad):
        assert loss_mod.fused_takes(target, rec) is takes


def test_wrappers_raise_on_what_they_do_not_take():
    x, y = _signals(2, 600, seed=6)
    c = stft_loss.window_constant(256, torch.float64, torch.device("cpu"))
    with pytest.raises(ValueError, match="n/2 < T"):
        stft_loss.stft_frame(x[:, :128], y[:, :128], c, 64)
    with pytest.raises(ValueError, match="hop"):
        stft_loss.stft_frame(x, y, c, 0)
    with pytest.raises(TypeError, match="float64"):
        stft_loss.stft_frame(x, y.float(), c, 64)
    with pytest.raises(ValueError, match="contiguous"):
        stft_loss.stft_frame(x.T.contiguous().T, y, c, 64)
    spec = torch.fft.rfft(stft_loss.stft_frame(x, y, c, 64), dim=-1)
    with pytest.raises(ValueError, match="partials"):
        stft_loss.stft_loss_grad(spec, 256, torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="complex spec"):
        stft_loss.stft_loss_grad(spec.real.contiguous(), 256, torch.zeros(1, dtype=torch.float64))
    gframes = torch.zeros((2, 7, 256), dtype=torch.float64)
    with pytest.raises(ValueError, match="frames"):
        stft_loss.stft_overlap_add(gframes, c, torch.ones((), dtype=torch.float64), 600, 64)
    with pytest.raises(ValueError, match="differ"):
        stft_loss.multiscale_spectral_loss(x, y[:1], (256,), 0.75)
    with pytest.raises(ValueError, match="no hop"):
        stft_loss.multiscale_spectral_loss(x, y, (256,), 1.0)


# ------------------------------------------------------------------ card
def _cell_signals(device, seed=0):
    x, y = _signals(CELL_BATCH, CELL_SAMPLES, seed, dtype=torch.float32)
    return x.to(device), y.to(device)


@pytest.mark.cuda
def test_kernels_match_their_plain_versions_on_cuda(cuda):
    """Each kernel against its plain version in float32 on the card at the
    cell's shape, every scale."""
    x, y = _cell_signals(cuda)
    go = torch.full((), 0.75, device=cuda)
    out = plain_out = None
    for n in SCALES:
        hop = stft_loss.hop_length(n, 0.75)
        c = stft_loss.window_constant(n, torch.float32, cuda)
        frames = stft_loss.stft_frame(x, y, c, hop)
        assert torch.equal(frames, stft_loss.stft_frame_plain(x, y, c, hop)), n
        spec = torch.fft.rfft(frames, dim=-1)
        count = spec.numel() // 2
        partials = torch.empty(stft_loss.loss_blocks(count), dtype=torch.float64, device=cuda)
        plain_partials = torch.empty_like(partials)
        grad = stft_loss.stft_loss_grad(spec, n, partials)
        want = stft_loss.stft_loss_grad_plain(spec, n, plain_partials)
        assert _rel(torch.view_as_real(grad), torch.view_as_real(want)) <= KERNEL_REL, n
        assert float(partials.sum()) == pytest.approx(float(plain_partials.sum()), rel=KERNEL_REL)
        gframes = torch.fft.irfft(grad, n=n, dim=-1, norm="forward")
        out = stft_loss.stft_overlap_add(gframes, c, go, CELL_SAMPLES, hop, out)
        plain_out = stft_loss.stft_overlap_add_plain(gframes, c, go, CELL_SAMPLES, hop, plain_out)
        assert _rel(out, plain_out) <= KERNEL_REL, n
    loss = stft_loss.stft_loss_sum(partials, torch.float32)
    assert float(loss) == pytest.approx(float(partials.sum()), rel=1e-7)
    assert kernels.counts()["stft_frame"]["launches"] >= len(SCALES)


@pytest.mark.cuda
def test_fused_loss_matches_plain_path_at_the_cells_shape_on_cuda(cuda):
    """The fused loss and gradient against the float64 plain path on the
    CPU, the gradient no further off than FUSED_OVER_PLAIN times the
    float32 plain path on the card (its 90th percentile)."""
    x, y = _cell_signals(cuda, seed=1)
    (loss, grad), (plain_loss, plain_grad) = _both(x, y, SCALES, 0.75)
    want_loss, want_grad = _plain(x.cpu().double(), y.cpu().double(), SCALES, 0.75)

    assert abs(float(loss) - float(want_loss)) <= CARD_LOSS_REL * float(want_loss)
    fused_q, plain_q = (_error_q90(g.cpu().double(), want_grad) for g in (grad, plain_grad))
    assert fused_q <= FUSED_OVER_PLAIN * plain_q, (fused_q, plain_q)


@pytest.mark.cuda
def test_fused_loss_repeats_bit_for_bit_and_in_a_graph_on_cuda(cuda):
    x, y = _cell_signals(cuda, seed=2)
    yy = y.clone().requires_grad_(True)

    def step():
        loss = stft_loss.multiscale_spectral_loss(x, yy, SCALES, 0.75)
        (grad,) = torch.autograd.grad(loss, yy)
        return loss.detach(), grad

    first, second = step(), step()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = step()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graphed[0], first[0]) and torch.equal(graphed[1], first[1])
