"""`Optimizer.apply_`, the train steps' one optimizer call, and the Adam
kernel behind it on the card (ops/adam.py, ops/kernels/adam.cu).

On the CPU: the plain in-place path against `update` followed by the
guard's copies, as training/train.py wrote them before the kernel, bit for
bit; which path a step takes; and the kernel's leaf table, checked by the
pure-Python model of its block → (leaf, chunk) search.

The `cuda`-marked tests hold the kernel against that plain path on the
card, eager and replayed from a captured graph; they skip where
torch.cuda.is_available() is False.  This file imports no JAX:

    DDSP_TEST_PLATFORM=cuda python -m pytest tests/test_torch_optim.py -m cuda
"""

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch.ops import adam, kernels
from ddsp_pytorch_tpu_torch.training.optim import LinearSchedule, Optimizer, global_norm, tree_leaves

# the cases of a step: (optimizer, learning rate, clip, the step whose loss is NaN)
CASES = {
    "adam": ("adam", 1e-3, None, None),
    "adam-nan-at-step-3": ("adam", 1e-3, None, 3),
    "adam-linear-schedule": ("adam", LinearSchedule(1e-3, 1e-4, 3), None, None),
    "adam-clip-triggers": ("adam", 1e-3, 0.5, None),
    "adam-clip-does-not-trigger": ("adam", 1e-3, 1e6, None),
    "sgd": ("sgd", 0.1, None, None),
    "sgd-schedule-clip-nan": ("sgd", LinearSchedule(0.1, 0.0, 4), 1.0, 2),
}
SHAPES = [(), (1,), (3,), (4, 5), (1025,), (7, 3, 2)]
STEPS = 5


def _leaves(shapes, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g, dtype=torch.float64).to(device, dtype) for s in shapes]


def _reference_step(tx, params, grads, state, loss):
    """training/train.py's `_update_in_place` before the kernel: `update`,
    then every tensor written through the guard's torch.where."""
    updates, new = tx.update(grads, state)
    finite = torch.isfinite(loss)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.copy_(torch.where(finite, p + u, p))
        for old, value in zip(tree_leaves(state), tree_leaves(new)):
            old.copy_(torch.where(finite, value, old))
    return {"loss": loss, "grad_norm": global_norm(grads),
            "update_skipped": torch.logical_not(finite).to(torch.int32)}


def _run(case, step_fn, shapes=SHAPES, dtype=torch.float32, device="cpu", steps=STEPS):
    name, lr, clip, nan_at = CASES[case]
    tx = Optimizer(name, lr, clip)
    params = _leaves(shapes, 0, dtype, device)
    state = tx.init(params)
    held = [id(t) for t in params + tree_leaves(state)]
    rows = []
    for k in range(1, steps + 1):
        grads = [0.3 * g for g in _leaves(shapes, k, dtype, device)]
        loss = torch.tensor(float("nan") if k == nan_at else 1.0 / k, dtype=dtype, device=device)
        rows.append(step_fn(tx, params, grads, state, loss))
    assert [id(t) for t in params + tree_leaves(state)] == held  # the same tensors, written in place
    return params, state, rows


@pytest.mark.parametrize("case", list(CASES))
def test_plain_apply_is_update_and_copies_bitwise(case):
    """apply_ on the CPU is `update` and the guard's copies, bit for bit,
    over 5 steps: parameters, every state tensor (the counts included)
    and the metrics."""
    got_p, got_s, got_rows = _run(case, lambda tx, p, g, s, loss: tx.apply_(p, g, s, loss))
    want_p, want_s, want_rows = _run(case, _reference_step)
    for a, b in zip(got_p + tree_leaves(got_s), want_p + tree_leaves(want_s)):
        assert torch.equal(a, b)
    for got, want in zip(got_rows, want_rows):
        assert got.keys() == want.keys()
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, equal_nan=True, msg=k)
    skipped = [int(r["update_skipped"]) for r in got_rows]
    assert skipped == [int(k == CASES[case][3]) for k in range(1, STEPS + 1)]
    if CASES[case][0] == "adam":
        assert int(got_s["count"]) == STEPS - sum(skipped)


def test_plain_apply_without_a_loss_has_no_guard():
    """CREPE's call (no loss): every step applies, in place, nothing
    returned."""
    def unguarded(tx, p, g, s, loss):
        assert tx.apply_(p, g, s) == {}
        return None

    def reference(tx, p, g, s, loss):
        return _reference_step(tx, p, g, s, torch.ones(()))

    got_p, got_s, _ = _run("adam", unguarded)
    want_p, want_s, _ = _run("adam", reference)
    for a, b in zip(got_p + tree_leaves(got_s), want_p + tree_leaves(want_s)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,dtype", [("adam", torch.float32), ("adam", torch.float64), ("sgd", torch.float32)],
                         ids=["cpu-float32", "cpu-float64", "sgd"])
def test_the_cpu_float64_and_sgd_take_the_plain_path(monkeypatch, name, dtype):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(adam, "adam_", refuse)
    tx = Optimizer(name, 1e-3)
    params = _leaves(SHAPES, 0, dtype)
    state = tx.init(params)
    before = kernels.counts()
    metrics = tx.apply_(params, [torch.ones_like(p) for p in params], state, torch.ones((), dtype=dtype))
    assert int(metrics["update_skipped"]) == 0 and kernels.counts() == before


# leaf sizes of the kernel's table: a 0-d leaf, 1, 3, 1 025 and 2^20 + 7
# elements, an empty leaf, the decoder's 47 leaves, and more leaves than
# one launch carries
TABLE_SETS = {
    "edges": [1, 1, 3, 1025, 2**20 + 7, 0],
    "forty-seven-leaves": [1536, 786432, 1536, 512, 1] * 9 + [1, 1],
    "more-than-one-launch": [3, adam.CHUNK + 1, 1] * 67 + [5],
    "two-full-launches": [1] * (2 * adam.MAX_LEAVES),
}


@pytest.mark.parametrize("sizes", list(TABLE_SETS))
def test_every_element_is_one_blocks(sizes):
    """Over the launches of `plan`, the kernel's search (block_leaf) maps
    each block to one (leaf, chunk) and every element of every non-empty
    leaf to exactly one block; the partials run on across launches."""
    numels = TABLE_SETS[sizes]
    launches = adam.plan(numels)
    assert len(launches) == -(-sum(n > 0 for n in numels) // adam.MAX_LEAVES)
    covered = {i: np.zeros(n, np.int32) for i, n in enumerate(numels)}
    partial = 0
    for leaves, first, partial0 in launches:
        assert len(leaves) <= adam.MAX_LEAVES and partial0 == partial and first[0] == 0
        for block in range(first[-1]):
            pos, chunk = adam.block_leaf(first, block)
            start = chunk * adam.CHUNK
            assert 0 <= start < numels[leaves[pos]]
            covered[leaves[pos]][start:start + adam.CHUNK] += 1
        partial += first[-1]
    for i, n in enumerate(numels):
        assert np.all(covered[i] == 1), i
    assert [i for launch in launches for i in launch[0]] == [i for i, n in enumerate(numels) if n > 0]


@pytest.mark.parametrize("sizes", ["edges", "more-than-one-launch"])
def test_the_table_is_the_kernels_layout(sizes):
    """`pack` writes adam.cu's `Leaves`: the four pointers and the element
    count of each leaf, then the first blocks, the leaves and the first
    partial."""
    numels = TABLE_SETS[sizes]
    tensors = [[torch.zeros(n) for n in numels] for _ in range(4)]
    for launch in adam.plan(numels):
        leaves, first, partial0 = launch
        buf = adam.pack(launch, *tensors)
        assert buf.nbytes == adam.TABLE_BYTES
        words = buf[:8 * adam.TABLE_INT64].view(np.int64).reshape(5, adam.MAX_LEAVES)
        ints = buf[8 * adam.TABLE_INT64:].view(np.int32)
        for j, i in enumerate(leaves):
            assert list(words[:, j]) == [t[i].data_ptr() for t in tensors] + [numels[i]]
        assert list(ints[:len(first)]) == first
        assert (ints[adam.MAX_LEAVES + 1], ints[adam.MAX_LEAVES + 2]) == (len(leaves), partial0)


def test_the_trainer_step_calls_apply(monkeypatch):
    """training/train.py's update is the one apply_ call, with the loss."""
    from ddsp_pytorch_tpu_torch.training import train

    calls = []

    class Seen(Optimizer):
        def apply_(self, params, grads, state, loss=None):
            calls.append(loss)
            return super().apply_(params, grads, state, loss)

    class State:
        def __init__(self, params, opt_state):
            self._params, self.opt_state, self.step = params, opt_state, 0

        def params(self):
            return self._params

    tx = Seen("adam", 1e-3)
    params = _leaves(SHAPES, 0)
    state = State(params, tx.init(params))
    loss = torch.tensor(2.0)
    metrics = train.apply_gradient_update(state, tx, loss, [torch.ones_like(p) for p in params])
    assert calls == [loss] and state.step == 1 and int(metrics["update_skipped"]) == 0


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _model_shapes(which: str):
    from ddsp_pytorch_tpu_torch.models import load_model
    from ddsp_pytorch_tpu_torch.models.crepe import CREPE

    if which == "crepe":
        model = CREPE("full")
    else:
        model = load_model(which, {"hidden_size": 512, "n_harmonic": 64, "n_bands": 65, "sample_rate": 48000,
                                   "block_size": 512, "has_reverb": True})
    return [tuple(p.shape) for p in model.parameters()]


LEAF_SETS = {
    "decoder": lambda: _model_shapes("single-inst-decoder"),
    "crepe": lambda: _model_shapes("crepe"),
    "odd": lambda: [(), (1,), (3,), (1025,), (2**20 + 7,), (0,), (5, 3)],
    "many": lambda: [(3,), (adam.CHUNK + 1,), (1,)] * 67 + [(5,)],
}


def _gap(xs, ys) -> float:
    """‖x − y‖ / ‖y‖ over all the leaves at once, in float64."""
    num = sum(float((a.double() - b.double()).pow(2).sum()) for a, b in zip(xs, ys))
    return (num / max(sum(float(b.double().pow(2).sum()) for b in ys), 1e-300)) ** 0.5


def _card_run(device, shapes, case, step_fn, steps=10, nan_at=None, loss_value=float("nan")):
    name, lr, clip, _ = CASES[case]
    tx = Optimizer(name, lr, clip)
    params = _leaves(shapes, 0, device=device)
    state = tx.init(params)
    grads_seq = [[0.3 * g for g in _leaves(shapes, k, device=device)] for k in range(1, steps + 1)]
    rows = []
    for k, grads in enumerate(grads_seq, 1):
        loss = torch.tensor(loss_value if k == nan_at else 1.0 / k, device=device)
        rows.append(step_fn(tx, params, grads, state, loss))
    torch.cuda.synchronize(device)
    return params, state, rows


# The norm: the kernel sums in float64 in a fixed order, the plain path in
# float32, each leaf in torch's order and the leaves one after another;
# they differ by up to 1.9e-7 relative (measured on the card over these
# leaf sets).  A triggered clip divides every gradient by that norm, so the
# two paths' clipped gradients differ by as much; after 10 steps the
# moments and the parameters' change, over all the leaves, differ by at
# most CLIP_GAP relative in L2.  Without a triggered clip the two paths are
# equal bit for bit.
NORM_GAP = 1e-6
CLIP_GAP = {"p_change": 1e-5, "mu": 1e-6, "nu": 1e-6}


def _assert_kernel_equals_plain(got, want, case, p0):
    (gp, gs, grows), (wp, ws, wrows) = got, want
    if CASES[case][2] == 0.5:
        gaps = {"p_change": _gap([a.double() - q.double() for a, q in zip(gp, p0)],
                                 [b.double() - q.double() for b, q in zip(wp, p0)]),
                "mu": _gap(gs["mu"], ws["mu"]), "nu": _gap(gs["nu"], ws["nu"])}
        assert all(gaps[k] <= CLIP_GAP[k] for k in gaps), gaps
        assert torch.equal(gs["count"], ws["count"])
    else:
        for a, b in zip(gp + tree_leaves(gs), wp + tree_leaves(ws)):
            assert torch.equal(a, b)
    for got_row, want_row in zip(grows, wrows):
        assert torch.equal(got_row["update_skipped"], want_row["update_skipped"])
        assert torch.equal(got_row["loss"], want_row["loss"])
        assert abs(float(got_row["grad_norm"]) - float(want_row["grad_norm"])) <= NORM_GAP * float(
            want_row["grad_norm"])


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_set", list(LEAF_SETS))
@pytest.mark.parametrize("case", ["adam", "adam-linear-schedule", "adam-clip-triggers",
                                  "adam-clip-does-not-trigger"])
def test_kernel_equals_the_plain_path_on_the_card(cuda, leaf_set, case):
    """10 eager steps of the kernel against `update` and the copies on the
    card: bit for bit (a triggered clip: within CLIP_GAP), 2 launches a
    step (norm and update) for every MAX_LEAVES leaves."""
    shapes = LEAF_SETS[leaf_set]()
    kernels.reset_counts()
    got = _card_run(cuda, shapes, case, lambda tx, p, g, s, loss: tx.apply_(p, g, s, loss))
    counts = kernels.counts()
    want = _card_run(cuda, shapes, case, _reference_step)
    _assert_kernel_equals_plain(got, want, case, _leaves(shapes, 0, device=cuda))
    per_pass = len(adam.plan([int(np.prod(s)) for s in shapes]))
    assert counts["adam_norm"]["launches"] == counts["adam_update"]["launches"] == 10 * per_pass


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_set", ["decoder", "odd"])
def test_kernel_replayed_from_a_captured_graph_equals_eager_plain(cuda, leaf_set):
    """The step captured once and replayed 10 times, fed new gradients and
    losses through its static buffers, equals 10 plain steps bit for bit;
    the capture records 2 launches."""
    shapes = LEAF_SETS[leaf_set]()
    tx = Optimizer("adam", 1e-3)
    params = _leaves(shapes, 0, device=cuda)
    state = tx.init(params)
    grads = [torch.zeros_like(p) for p in params]
    loss = torch.ones((), device=cuda)
    norm = torch.zeros((), device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    saved = [t.clone() for t in params + tree_leaves(state)]
    with torch.cuda.stream(side):  # warm-up: the workspace, outside the graph's pool
        tx.apply_(params, grads, state, loss)
    torch.cuda.current_stream(cuda).wait_stream(side)
    for t, s in zip(params + tree_leaves(state), saved):
        t.copy_(s)
    before = kernels.counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        norm.copy_(tx.apply_(params, grads, state, loss)["grad_norm"])
    after = kernels.counts()
    assert {k: after[k]["captured"] - before[k]["captured"] for k in kernels.OPTIMIZER_KERNELS} == \
        {"adam_norm": 1, "adam_update": 1}

    def replay(tx_, p, g, s, step_loss):
        for dst, src in zip(grads, g):
            dst.copy_(src)
        loss.copy_(step_loss)
        graph.replay()
        return {"loss": step_loss, "grad_norm": norm.clone(),
                "update_skipped": torch.logical_not(torch.isfinite(step_loss)).to(torch.int32)}

    grads_seq = [[0.3 * g for g in _leaves(shapes, k, device=cuda)] for k in range(1, 11)]
    rows = [replay(tx, params, gs, state, torch.tensor(1.0 / k, device=cuda)) for k, gs in enumerate(grads_seq, 1)]
    torch.cuda.synchronize(cuda)
    want = _card_run(cuda, shapes, "adam", _reference_step)
    _assert_kernel_equals_plain((params, state, rows), want, "adam", None)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("nan"), float("inf")], ids=["nan", "inf"])
@pytest.mark.parametrize("case", ["adam", "adam-linear-schedule", "adam-clip-triggers"])
def test_the_guard_writes_nothing_on_the_card(cuda, bad, case):
    """A non-finite loss at step 3 leaves p, mu, nu, count and
    schedule_count bitwise as step 2 left them, and reports the skip."""
    shapes = LEAF_SETS["odd"]()
    snaps = {}

    def step(tx, p, g, s, loss):
        metrics = tx.apply_(p, g, s, loss)
        if not torch.isfinite(loss):
            snaps["after"] = [t.clone() for t in p + tree_leaves(s)]
        else:
            snaps["before"] = [t.clone() for t in p + tree_leaves(s)]
        return metrics

    _, state, rows = _card_run(cuda, shapes, case, step, steps=3, nan_at=3, loss_value=bad)
    for a, b in zip(snaps["after"], snaps["before"]):
        assert torch.equal(a, b)
    assert [int(r["update_skipped"]) for r in rows] == [0, 0, 1]
    assert int(state["count"]) == 2 and int(state.get("schedule_count", torch.tensor(2))) == 2
    assert torch.isfinite(rows[2]["grad_norm"])


@pytest.mark.cuda
def test_the_counts_are_not_raced(cuda):
    """2 000 blocks a step read Adam's count and the schedule's while the
    last block writes them: after 50 steps both read 50."""
    tx = Optimizer("adam", LinearSchedule(1e-3, 1e-4, 20))
    params = [torch.zeros(2000 * adam.CHUNK, device=cuda)]
    state = tx.init(params)
    grads = [torch.ones_like(params[0])]
    loss = torch.ones((), device=cuda)
    assert adam.plan([params[0].numel()])[0][1][-1] == 2000
    for _ in range(50):
        tx.apply_(params, grads, state, loss)
    assert int(state["count"]) == 50 and int(state["schedule_count"]) == 50


@pytest.mark.cuda
def test_crepe_step_takes_the_kernel_without_a_norm(cuda):
    """CREPE's trainer (no loss given): one update launch a step and no
    norm pass, shown in its metrics."""
    from ddsp_pytorch_tpu_torch.train_crepe import CrepeTrainer

    trainer = CrepeTrainer("micro", 8, device=cuda)
    for _ in range(3):
        trainer.step()
    assert trainer.metrics["kernel_launches/adam_update"] == 3
    assert trainer.metrics["kernel_launches/adam_norm"] == 0
