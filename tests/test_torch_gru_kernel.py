"""The GRU recurrence's kernels (ops/gru.py) and their plain versions.

On the CPU: `GRU.forward` without a compute dtype is `gru_recurrence`,
whose CPU path is the plain forward (the one float loop), and the plain
forward's saved planes are the gates and states they name (float32 and
float64); the plain backward, through `GRURecurrence`, matches autograd
through the loop in float64 to 1e-12 of each gradient's largest magnitude
(the same chain rule, summed in another order); the CPU and bf16 paths
never reach a kernel launcher.

The `cuda`-marked tests skip where torch.cuda.is_available() is False.
This file imports no JAX; on a card they run with

    DDSP_TEST_PLATFORM=cuda python -m pytest tests/test_torch_gru_kernel.py -m cuda

Their tolerances:
  * kernel against the plain version in float32 on the card, outputs and
    saved activations: KERNEL_ATOL absolute (every value is a gate in
    [0, 1], a tanh or an h in [−1, 1], or hp_n of order 1).  The two sum
    each frame's 512-term product in other orders (cuBLAS's against the
    kernel's fixed one), ~1e-7 a frame, and the recurrence carries the
    difference on through 375 frames;
  * the kernel's gradients against the float64 loop on the CPU: GRAD_REL
    of each gradient's largest magnitude, float32 rounding summed over
    B·F = 6000 rows for dW_hh;
  * bitwise where the kernels promise it: two launches, a graph replay
    against eager, eight-frame blocks of the recurrence with a carried
    state against one pass.
"""

import pytest
import torch

from ddsp_pytorch_tpu_torch.models.decoder import GRU, init_params
from ddsp_pytorch_tpu_torch.ops import gru, kernels

KERNEL_ATOL = 2e-5
GRAD_REL = 1e-4
BACKWARD_REL = 1e-12


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


def _gru(in_size, hidden, seed, dtype=torch.float32, device="cpu", compute_dtype=None):
    """A GRU with init_params's weights and small random biases."""
    model = GRU(in_size, hidden, compute_dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed + 1)
        model.bias_ih.copy_(0.1 * torch.randn(model.bias_ih.shape, generator=g))
        model.bias_hh.copy_(0.1 * torch.randn(model.bias_hh.shape, generator=g))
    return model.to(device=device, dtype=dtype)


def _inputs(b, f, in_size, hidden, seed, h0_given, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, f, in_size), generator=g, dtype=torch.float64)
    h0 = 0.5 * torch.randn((b, hidden), generator=g, dtype=torch.float64) if h0_given else None
    return x.to(device, dtype), None if h0 is None else h0.to(device, dtype)


# (B, F, H, input size, initial state given, final-state cotangent given)
CASES = [
    (1, 1, 8, 30, False, False), (1, 7, 8, 16, True, True), (1, 40, 64, 30, True, False),
    (1, 7, 64, 128, False, True), (3, 1, 8, 16, True, True), (3, 7, 8, 30, False, False),
    (3, 40, 8, 16, True, True), (3, 1, 64, 30, False, True), (3, 7, 64, 128, True, False),
    (3, 40, 64, 30, False, True), (16, 1, 8, 30, True, False), (16, 7, 8, 16, False, True),
    (16, 40, 8, 30, True, True), (16, 1, 64, 128, True, True), (16, 7, 64, 30, False, False),
    (16, 40, 64, 128, False, False), (1, 1, 64, 128, True, False), (3, 40, 64, 128, True, True),
    (16, 7, 64, 128, True, True), (16, 40, 8, 16, False, True),
]
IDS = [f"B{b}-F{f}-H{h}-in{i}-{'h0' if s else 'zero'}-{'dfinal' if d else 'nofinal'}"
       for b, f, h, i, s, d in CASES]


def _launched(name: str) -> int:
    return kernels.counts()[name]["launches"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_equals_loop(case):
    """On the CPU, in float32 and float64, gru_recurrence (what GRU.forward
    calls without a compute dtype) is the plain forward without its saved
    planes, with and without autograd, bit for bit; the saved planes are the
    gates and states they name."""
    b, f, hidden, in_size, h0_given, _ = case
    for dtype in (torch.float32, torch.float64):
        model = _gru(in_size, hidden, seed=b * 100 + f, dtype=dtype)
        x, h0 = _inputs(b, f, in_size, hidden, seed=f + hidden, h0_given=h0_given, dtype=dtype)
        x_proj = x @ model.weight_ih.T + model.bias_ih
        tracked_out, tracked_h = gru.gru_recurrence(x_proj, model.weight_hh, model.bias_hh, h0)
        assert tracked_out.requires_grad and tracked_h.requires_grad
        with torch.no_grad():
            want_out, want_h = gru.gru_recurrence(x_proj, model.weight_hh, model.bias_hh, h0)
            model_out, model_h = model(x, h0)
            out, h, saved = gru.gru_fwd_plain(x_proj, model.weight_hh, model.bias_hh, h0)
        assert torch.equal(out, want_out) and torch.equal(h, want_h), dtype
        assert torch.equal(tracked_out.detach(), out) and torch.equal(tracked_h.detach(), h), dtype
        assert torch.equal(model_out, out) and torch.equal(model_h, h), dtype
        assert gru.gru_fwd_plain(x_proj, model.weight_hh, model.bias_hh, h0, save=False)[2] is None
        assert saved.shape == (len(gru.SAVED), b, f, hidden)
        r, z, n, _, h_prev = saved.unbind(0)
        assert torch.equal(h_prev[:, 1:], out[:, :-1])
        assert torch.equal(h_prev[:, 0], h0 if h0 is not None else torch.zeros_like(h))
        assert torch.equal((1.0 - z) * n + z * h_prev, out)
        assert bool(((r > 0) & (r < 1) & (z > 0) & (z < 1)).all())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case):
    """In float64, GRURecurrence (the plain forward and the hand-derived
    plain backward, then dW_hh and db_hh as one product and one sum) gives
    the gradients of x, W_ih, b_ih, W_hh, b_hh and the initial state that
    autograd gives through GRU.forward's loop, to 1e-12 relative."""
    b, f, hidden, in_size, h0_given, dfinal_given = case
    model = _gru(in_size, hidden, seed=b + f, dtype=torch.float64)
    x, h0 = _inputs(b, f, in_size, hidden, seed=b * f + 1, h0_given=h0_given, dtype=torch.float64)
    g = torch.Generator().manual_seed(hidden + in_size)
    dout = torch.randn((b, f, hidden), generator=g, dtype=torch.float64)
    dfinal = torch.randn((b, hidden), generator=g, dtype=torch.float64) if dfinal_given else None

    def grads(run):
        xx = x.clone().requires_grad_(True)
        hh = h0.clone().requires_grad_(True) if h0 is not None else None
        out, h = run(xx, hh)
        loss = (out * dout).sum() + ((h * dfinal).sum() if dfinal is not None else 0.0)
        leaves = [xx, model.weight_ih, model.bias_ih, model.weight_hh, model.bias_hh]
        leaves += [hh] if hh is not None else []
        return torch.autograd.grad(loss, leaves)

    def recurrence(xx, hh):
        x_proj = xx @ model.weight_ih.T + model.bias_ih
        return gru.GRURecurrence.apply(x_proj, model.weight_hh, model.bias_hh, hh)

    want = grads(model)
    got = grads(recurrence)
    names = ["x", "weight_ih", "bias_ih", "weight_hh", "bias_hh", "h0"]
    for name, a, w in zip(names, got, want):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= BACKWARD_REL * max(scale, 1e-300), name


def test_plain_backward_is_gru_bwd_on_the_cpu():
    """gru_bwd on CPU tensors is the plain version, and its last carry is
    the initial state's cotangent of the forward's graph."""
    model = _gru(16, 8, seed=3, dtype=torch.float64)
    x, h0 = _inputs(3, 5, 16, 8, seed=4, h0_given=True, dtype=torch.float64)
    x_proj = (x @ model.weight_ih.T + model.bias_ih).detach()
    out, h, saved = gru.gru_fwd(x_proj, model.weight_hh.detach(), model.bias_hh.detach(), h0)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    dxp, dhp, dh0 = gru.gru_bwd(dout, None, saved, model.weight_hh.detach())
    want = gru.gru_bwd_plain(dout, None, saved, model.weight_hh.detach())
    for a, w in zip((dxp, dhp, dh0), want):
        assert torch.equal(a, w)
    hh = h0.clone().requires_grad_(True)
    o, _ = gru.gru_fwd_plain(x_proj, model.weight_hh.detach(), model.bias_hh.detach(), hh)[:2]
    (want_dh0,) = torch.autograd.grad((o * dout).sum(), hh)
    assert float((dh0 - want_dh0).abs().max()) <= BACKWARD_REL * float(want_dh0.abs().max())


def test_wrappers_raise_on_what_they_do_not_take():
    """Shapes, types and layouts the wrappers refuse, on the CPU."""
    x_proj = torch.zeros((2, 3, 24))
    w_hh, b_hh = torch.zeros((24, 8)), torch.zeros(24)
    with pytest.raises(ValueError):
        gru.gru_fwd(x_proj[..., :21], w_hh, b_hh)
    with pytest.raises(ValueError):
        gru.gru_fwd(x_proj[:, :0], w_hh, b_hh)
    with pytest.raises(ValueError):
        gru.gru_fwd(x_proj, w_hh, b_hh, torch.zeros((3, 8)))
    with pytest.raises(TypeError):
        gru.gru_fwd(x_proj, w_hh.double(), b_hh)
    with pytest.raises(TypeError):
        gru.gru_fwd(x_proj.half(), w_hh.half(), b_hh.half())
    with pytest.raises(ValueError):
        gru.gru_fwd(x_proj.transpose(0, 1).contiguous().transpose(0, 1), w_hh, b_hh)
    saved = torch.zeros((5, 2, 3, 8))
    with pytest.raises(ValueError):
        gru.gru_bwd(torch.zeros((2, 3, 8)), None, saved[:4], w_hh)
    with pytest.raises(ValueError):
        gru.gru_bwd(torch.zeros((2, 3, 8)), torch.zeros((2, 7)), saved, w_hh)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["float32", "bf16"])
def test_cpu_and_bf16_paths_take_the_loop(monkeypatch, compute_dtype):
    """On the CPU (float32 and the bf16 compute dtype) GRU.forward and its
    backward run the loop: no kernel launcher is asked for and no launch
    is counted, and kernel_takes refuses CPU tensors, float32 and
    float64."""
    def refuse(name):
        raise AssertionError(f"kernel launcher asked for {name}")

    monkeypatch.setattr(kernels, "launcher", refuse)
    before = kernels.counts()
    model = _gru(30, 64, seed=1, compute_dtype=compute_dtype)
    x, h0 = _inputs(2, 5, 30, 64, seed=2, h0_given=True)
    out, h = model(x, h0)
    (out.float().sum() + h.float().sum()).backward()
    assert model.weight_hh.grad is not None and bool(torch.isfinite(model.weight_hh.grad).all())
    assert kernels.counts() == before
    x_proj = torch.zeros((1, 1, 3 * 64))
    assert not gru.kernel_takes(x_proj, 64)
    assert not gru.kernel_takes(x_proj.double(), 64)


@pytest.mark.parametrize("b, f, hidden, takes", [
    (16, 375, 512, True), (1, 1, 512, True), (1, 8, 512, True), (128, 1, 512, True),
    (129, 1, 512, False), (1024, 1, 512, False), (256, 2, 512, True), (512, 8, 512, True),
    (513, 375, 512, False), (16, 375, 576, False), (16, 375, 32, True),
])
def test_kernel_takes_by_shape(b, f, hidden, takes):
    """The dispatch rule on a float32 CUDA projection (B, F, 3H), by shape
    alone: H ≤ 512 and B ≤ min(128·F, 512)."""
    class CudaProjection:  # what kernel_takes reads of a CUDA tensor
        is_cuda, dtype, shape = True, torch.float32, (b, f, 3 * hidden)

    assert gru.kernel_takes(CudaProjection(), hidden) is takes


# ---------------------------------------------------------------- the card


def _kernel_vs_plain(device, b, f, in_size, hidden=512, seed=0):
    model = _gru(in_size, hidden, seed, device=device)
    x, h0 = _inputs(b, f, in_size, hidden, seed + 1, h0_given=True, device=device)
    with torch.no_grad():
        x_proj = x @ model.weight_ih.T + model.bias_ih
        got = gru.gru_fwd(x_proj, model.weight_hh, model.bias_hh, h0)
        want = gru.gru_fwd_plain(x_proj, model.weight_hh, model.bias_hh, h0)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("b, f, in_size", [(16, 375, 30), (16, 375, 1024), (16, 375, 1536),
                                           (1, 1, 1024), (1, 8, 1024), (1024, 1, 1024)])
def test_kernel_matches_plain_on_cuda(cuda, b, f, in_size):
    """The forward kernel against the plain version on the card, float32:
    outputs, final state and every saved plane within KERNEL_ATOL."""
    before = _launched("gru_fwd")
    (out, h, saved), (want_out, want_h, want_saved) = _kernel_vs_plain(cuda, b, f, in_size)
    assert _launched("gru_fwd") == before + 1
    assert float((out - want_out).abs().max()) <= KERNEL_ATOL
    assert torch.equal(h, out[:, -1])
    assert float((h - want_h).abs().max()) <= KERNEL_ATOL
    for name, a, w in zip(gru.SAVED, saved, want_saved):
        assert float((a - w).abs().max()) <= KERNEL_ATOL, name


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_and_in_a_graph_on_cuda(cuda):
    """Two launches of each kernel agree bit for bit, and a CUDA graph of
    forward and backward replays to eager's bits."""
    model = _gru(1024, 512, seed=4, device=cuda)
    x, h0 = _inputs(16, 375, 1024, 512, seed=5, h0_given=True, device=cuda)
    dout = torch.randn((16, 375, 512), generator=torch.Generator().manual_seed(6)).to(cuda)
    x_proj = (x @ model.weight_ih.T + model.bias_ih).detach()
    w_hh, b_hh = model.weight_hh.detach(), model.bias_hh.detach()

    def both():
        out, h, saved = gru.gru_fwd(x_proj, w_hh, b_hh, h0)
        return (out, h, saved, *gru.gru_bwd(dout, h, saved, w_hh))

    first, second = both(), both()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, first):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_blocks_with_carried_state_equal_one_pass_on_cuda(cuda):
    """The recurrence over a clip of 376 frames in blocks of eight with the
    state carried equals one pass over the whole clip, bit for bit: each
    frame's sums are in an order fixed by H alone.  The input projection is
    computed once for the clip and sliced: cuBLAS's product before the
    kernel may sum in another order for another number of rows."""
    model = _gru(1024, 512, seed=7, device=cuda)
    x, _ = _inputs(1, 376, 1024, 512, seed=8, h0_given=False, device=cuda)
    with torch.no_grad():
        x_proj = x @ model.weight_ih.T + model.bias_ih
        w_hh, b_hh = model.weight_hh, model.bias_hh
        whole, h_whole = gru.gru_recurrence(x_proj, w_hh, b_hh)
        state, blocks = None, []
        for i in range(0, 376, 8):
            out, state = gru.gru_recurrence(x_proj[:, i:i + 8].contiguous(), w_hh, b_hh, state)
            blocks.append(out)
    assert torch.equal(torch.cat(blocks, dim=1), whole)
    assert torch.equal(state, h_whole)


@pytest.mark.cuda
@pytest.mark.parametrize("in_size", [30, 1024])
def test_kernel_gradients_match_float64_loop_on_cuda(cuda, in_size):
    """GRU's gradients through the kernels on the card (float32) against
    autograd through the loop in float64 on the CPU: x, W_ih, b_ih, W_hh,
    b_hh and the initial state within GRAD_REL of each one's largest
    magnitude."""
    model64 = _gru(in_size, 512, seed=9, dtype=torch.float64)
    model32 = _gru(in_size, 512, seed=9, device=cuda)
    x, h0 = _inputs(16, 375, in_size, 512, seed=10, h0_given=True, dtype=torch.float64)
    g = torch.Generator().manual_seed(11)
    dout = torch.randn((16, 375, 512), generator=g, dtype=torch.float64)
    dfinal = torch.randn((16, 512), generator=g, dtype=torch.float64)

    def grads(model, device, dtype):
        xx = x.to(device, dtype).requires_grad_(True)
        hh = h0.to(device, dtype).requires_grad_(True)
        out, h = model(xx, hh)
        loss = (out * dout.to(device, dtype)).sum() + (h * dfinal.to(device, dtype)).sum()
        return torch.autograd.grad(loss, [xx, *model.parameters(), hh])

    before = (_launched("gru_fwd"), _launched("gru_bwd"))
    got = grads(model32, cuda, torch.float32)
    assert (_launched("gru_fwd"), _launched("gru_bwd")) == (before[0] + 1, before[1] + 1)
    want = grads(model64, "cpu", torch.float64)
    for name, a, w in zip(["x", "weight_ih", "weight_hh", "bias_ih", "bias_hh", "h0"], got, want):
        err = float((a.cpu().double() - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()), (name, err)
