"""Train step, multi-step, eval step and the Trainer loop.

Port of ddsp_pytorch_tpu/training/train.py:60-218 and the Trainer of
:220-905: the epoch loop sized to reach `steps`, loudness
normalized by the frozen dataset stats, the multiscale spectral loss of the
model's signal against the target, the optimizer update behind a NaN
guard, `steps_per_call` optimizer steps per call, per-step metrics fetched
once per flush, validation every `val_interval_epochs`, the best
mean-train-loss params every `log_interval_epochs`, full-state checkpoints
every `checkpoint_every_steps`, exact resume from the newest one, and a
preemption-safe `fit` (SIGTERM/SIGINT → checkpoint → return).

Both model families train: the single-inst-decoder, and the
mfcc-autoencoder, whose batches carry `mfcc` (B, F, n_mfcc) beside the
decoder's keys; every step, gather and static buffer below is generic over
the batch's keys.  RAVE v1 (models/rave.py) trains through the same
Trainer and MultiStep on batches of raw crops ({sig} alone).  What differs
between the models the model answers itself (models/decoder.py
`DDSPTraining`, models/rave.py `RAVE`): whether batches carry features,
the step marks' phases, the initial weights, each step's random draw
(DDSP's noise, RAVE's latent ε, drawn from the state's generator in step
order), the step's loss and gradients and the eval outputs.  The harmonic branch runs through `ops.OscillatorBank`,
so on the card a step launches the hand-written forward kernel once and the
backward kernel once.  On the card a call of `steps_per_call` steps replays a CUDA graph
of `scan_unroll` whole steps (forward, backward, Adam and the NaN guard,
both kernels inside), the counterpart of the JAX package's lax.scan.
Validation and the per-log-epoch eval write the target and the
reconstruction as wavs and, where matplotlib imports, the reconstruction
report as a figure (train.py:857-900).

Under a ('data', 'time') mesh (parallel/mesh.py; train.py:236-410) the step
is the time-sharded one where time > 1 (training/time_sharded.py), and the
data-parallel one across processes where time = 1: each rank takes its
rows, and its gradients and loss are averaged over the ranks in one
all_reduce inside the step (parallel/sharding.GradientReducer), so the
MultiStep graph holds it on NCCL.  On an in-process mesh with time = 1 the
whole batch is this process's and the step is the unsharded one.  The
noise of a step is drawn for the global batch from the state's generator,
as one process on that batch draws it, and each rank takes its rows.  Only
rank 0 logs and writes (`_is_primary`); checkpoints are written by rank 0
and restored by every rank.
"""

from __future__ import annotations

import math
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.models import load_model
from ddsp_pytorch_tpu_torch.models.decoder import matmul_precision
from ddsp_pytorch_tpu_torch.ops import kernels, mean_std_loudness
from ddsp_pytorch_tpu_torch.parallel.mesh import Mesh
from ddsp_pytorch_tpu_torch.parallel.sharding import GradientReducer, replicate_state
from ddsp_pytorch_tpu_torch.training import profiling
from ddsp_pytorch_tpu_torch.training.loss import spectral_loss
from ddsp_pytorch_tpu_torch.training.metrics import MetricsWriter
from ddsp_pytorch_tpu_torch.training.optim import Optimizer, make_optimizer, tree_leaves
from ddsp_pytorch_tpu_torch.training.reports import reconstruction_report
from ddsp_pytorch_tpu_torch.training.state import Checkpointer, TrainState
from ddsp_pytorch_tpu_torch.training.time_sharded import (
    make_time_sharded_loss_and_grads,
    validate_time_sharding,
)
from ddsp_pytorch_tpu_torch.utils.plots import pyplot

# the columns of a step's metrics row
METRIC_KEYS = ("loss", "grad_norm", "update_skipped")
# eager runs of the step bodies before a capture: they build the kernels,
# the cuFFT plans and the cuBLAS workspaces, which capture cannot
WARMUP_RUNS = 2


def _normalize_loudness(batch, mean, std):
    batch = dict(batch)
    batch["loudness"] = (batch["loudness"] - mean) / std
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) → float32 tensors on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in batch.items()}


class HostBatchStager:
    """Host (numpy) batches → float32 tensors on a CUDA device, through one
    pinned staging buffer per key and shape and a non-blocking copy.  The
    next staging first waits for the previous copies (an event), so a
    buffer is never rewritten while the device reads it.  Tensors already
    on the device pass through."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self._copied: Optional[torch.cuda.Event] = None

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        if self._copied is not None:
            self._copied.synchronize()
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device, torch.float32)
                continue
            v = np.asarray(v)
            buf = self._pinned.get((k, v.shape))
            if buf is None:
                buf = torch.empty(v.shape, dtype=torch.float32).pin_memory()
                self._pinned[(k, v.shape)] = buf
            buf.numpy()[...] = v
            out[k] = buf.to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return out


def loss_and_grads(
    model,
    batch: Dict[str, torch.Tensor],
    mean_loudness: float,
    std_loudness: float,
    scales,
    overlap: float,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """The train step's loss and the gradient of every parameter, in
    `model.named_parameters()` order (train.py:119-131).  The filtered
    noise is `noise` (B, F, block) if given, else drawn from `generator`.
    A bf16 model's parameters are cast inside this call (models/decoder.py),
    so a captured step never reads a stale copy; its backward runs in the
    models' matmul precision as its forward does.  The loss is
    training/loss.py `spectral_loss`'s: on the card, the fused kernels."""
    model_batch = _normalize_loudness(batch, mean_loudness, std_loudness)
    with matmul_precision():
        out = model(model_batch, noise=noise, generator=generator)
        loss = spectral_loss(batch["sig"], out["signal"], scales, overlap)
        profiling.mark(3)
        params = [p for _, p in model.named_parameters()]
        grads = torch.autograd.grad(loss, params)
        profiling.mark(6)
    return loss.detach(), list(grads)


def _update_in_place(state: TrainState, tx: Optimizer, loss, grads) -> Dict[str, torch.Tensor]:
    """The optimizer update behind the NaN guard, written into the existing
    parameter and optimizer-state tensors (a captured step reads and writes
    fixed addresses).  Returns the step's metrics as 0-d device tensors."""
    return tx.apply_(state.params(), grads, state.opt_state, loss)


def apply_gradient_update(state: TrainState, tx: Optimizer, loss, grads) -> Dict[str, torch.Tensor]:
    """Optimizer update behind the NaN guard (train.py:66-106), in place.

    A non-finite loss leaves the parameters and the optimizer state (Adam's
    count included) as they were, and the step still advances so the data
    order stays deterministic.  The choice is made on the device
    (torch.where, or the card's Adam kernel reading the loss), so the step
    does not wait for the loss.  Returns the step's metrics as 0-d device
    tensors."""
    metrics = _update_in_place(state, tx, loss, grads)
    state.step += 1
    return metrics


def metrics_row(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A step's metrics as a float32 (3,) row in METRIC_KEYS order."""
    return torch.stack([metrics[k].to(torch.float32) for k in METRIC_KEYS])


def make_loss_and_grads(model, config: Config, mesh: Optional[Mesh] = None) -> Callable:
    """fn(state, batch, noise) → (loss, grads) of the step under `mesh`,
    noise being the global batch's (B · mesh.data_procs, F, S) draw: the
    time-sharded step where mesh.time > 1; across processes the
    data-parallel step (this rank's rows, the loss and gradients averaged
    over the ranks); else the unsharded step, the model's own
    `loss_and_grads` (RAVE's, with its draw ε, is tested unsharded only)."""
    if mesh is not None and mesh.time > 1:
        return make_time_sharded_loss_and_grads(model, config, mesh)
    scales = tuple(config.train.scales)
    overlap = config.train.overlap
    reducer = None if mesh is None or mesh.in_process else GradientReducer(mesh, mean=True)

    def fn(state: TrainState, batch, noise):
        if mesh is not None:
            noise = mesh.data_rows(noise)
        loss, grads = model.loss_and_grads(state, batch, noise, scales, overlap)
        if reducer is not None:
            grads, loss = reducer(grads, loss)
        return loss, grads

    return fn


def draw_noise(model, generator: torch.Generator, batch, rows: int = 1) -> torch.Tensor:
    """A step's draw for the (B · rows)-item batch from `generator`: DDSP's
    (B · rows, F, block) noise, RAVE's ε."""
    return model.draw(model.draw_shape(batch["sig"].shape[0] * rows, batch), generator)


def make_train_step(model, tx: Optimizer, config: Config, mesh: Optional[Mesh] = None) -> Callable:
    """train_step(state, batch, noise=None) → metrics: one optimizer step
    in place (train.py:109-134), under `mesh` as make_loss_and_grads says.
    The noise is drawn from the state's generator on the device unless
    `noise` (the global batch's) is injected."""
    fn = make_loss_and_grads(model, config, mesh)
    rows = 1 if mesh is None else mesh.data_procs

    def train_step(state: TrainState, batch, noise: Optional[torch.Tensor] = None):
        if noise is None:
            noise = draw_noise(model, state.generator, batch, rows)
        loss, grads = fn(state, batch, noise)
        return apply_gradient_update(state, tx, loss, grads)

    return train_step


def refuse_gloo_capture(model, mesh: Optional[Mesh]) -> None:
    """Raise where a MultiStep would have to capture gloo collectives in a
    CUDA graph (the model on the card, a mesh across gloo processes)."""
    if (mesh is not None and not mesh.in_process and next(model.parameters()).is_cuda
            and torch.distributed.get_backend(mesh.group) == "gloo"):
        raise RuntimeError(
            "MultiStep: gloo collectives cannot be captured in a CUDA graph; "
            "train with steps_per_call 1 on gloo, or use NCCL"
        )


class MultiStep:
    """`n_steps` optimizer steps in one call (train.py:137-196), on batches
of any keys (the autoencoder's carry `mfcc`).

    Each step is the single train step with its noise drawn from the
    state's generator before the step (`ops.uniform_noise`, the draw the
    model makes itself), so a call trains exactly what `n_steps` single
    steps train.  Returns the steps' metrics as an (n_steps, 3) float32
    tensor on the device, rows in METRIC_KEYS order.

    On the CPU the steps run one after another.  On a CUDA device the call
    replays a CUDA graph holding `unroll` whole steps (forward, backward,
    the optimizer update and the NaN guard, both oscillator kernels
    inside), n_steps / unroll times.  Before each replay the steps' inputs
    are copied into the graph's static buffers and their noise is drawn
    eagerly into its noise buffer, so the graph holds no random draw and
    the generator advances as in eager steps.  The graph is captured at the
    first call, after WARMUP_RUNS eager runs of its bodies on a side stream
    whose updates are undone; it is bound to that call's parameter,
    optimizer-state and data tensors, and a call with others raises.
    Nothing falls back to eager steps: a failed capture or replay raises.

    Launch counts: a replay launches what the capture recorded
    (`captured`, per kernel), and adds that to the kernel wrapper's
    `replayed` count.

    Tracing (training/profiling.py): each call leaves a `profiling.calls()`
    record; each replay's input copy, noise draw and graph launch are host
    spans (`multistep.load`, `multistep.noise`, `multistep.launch`); the
    step bodies stamp the step marks (the model's `phases`), captured into the graph as timing
    events, so each record holds the device ms of the step's phases in the
    call's last replay; `graph_nodes` is the captured graph's node count
    over `unroll`, counted once at capture.

    RAVE's step draws ε where DDSP's draws noise (the model's `draw`), and
    writes BatchNorm's running statistics inside the graph; the warm-up
    runs before the capture undo them too.

    Under a mesh each step is make_loss_and_grads(mesh)'s; on an in-process
    mesh and on NCCL its collectives are captured with it.  A gloo group
    cannot be captured, so a MultiStep on the card across gloo processes
    raises rather than run eager steps.  The time-sharded step reaches no
    mark inside the model or the loss, so its phases read None; across
    data-parallel processes the gradients' all_reduce lies between marks 6
    and 7, so the optimizer's phase reads None.
    """

    def __init__(self, model, tx: Optimizer, config: Config, n_steps: int,
                 unroll: int = 1, indexed: bool = False, mesh: Optional[Mesh] = None):
        refuse_gloo_capture(model, mesh)
        if n_steps < 1 or unroll < 1:
            raise ValueError(f"need steps_per_call ≥ 1 and scan_unroll ≥ 1, got {n_steps}, {unroll}")
        if n_steps % unroll:
            raise ValueError(
                f"train.scan_unroll={unroll} must divide train.steps_per_call={n_steps}"
            )
        self.model = model
        self.tx = tx
        self.phases = model.phases
        self.n_steps = n_steps
        self.unroll = unroll
        self.indexed = indexed
        self._loss_and_grads = make_loss_and_grads(model, config, mesh)
        self._rows = 1 if mesh is None else mesh.data_procs
        data_parallel = mesh is not None and not mesh.in_process and mesh.time == 1
        self._unbounded = ("optimizer",) if data_parallel else ()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured: Dict[str, int] = {}
        self.warmup_s: Optional[float] = None  # the eager warm-up runs before the capture
        self.capture_s: Optional[float] = None  # capture and instantiation
        self.pool_bytes: Optional[int] = None  # device memory the capture reserved
        self.graph_nodes: Optional[float] = None  # the graph's nodes over unroll
        self.replays = 0
        self._bound = None
        self._marks: Optional[profiling.StepMarks] = None

    # ----------------------------------------------------------- one step
    def _body(self, state: TrainState, batch, noise) -> torch.Tensor:
        loss, grads = self._loss_and_grads(state, batch, noise)
        return metrics_row(_update_in_place(state, self.tx, loss, grads))

    def _draw_noise(self, state: TrainState, shape) -> torch.Tensor:
        return self.model.draw(shape, state.generator)

    def __call__(self, state: TrainState, *inputs) -> torch.Tensor:
        """inputs: `batches` ({key: (n_steps, B, ...)} on the device), or
        `data, idx2d` for the indexed variant (the device-resident cache and
        the (n_steps, B) item indices of each step's batch)."""
        if self.indexed:
            data, idx2d = inputs
            idx = torch.as_tensor(np.asarray(idx2d, np.int64)).to(data["sig"].device)
            lead, batch_rows = idx.shape

            def take(j):
                return {k: v.index_select(0, idx[j]) for k, v in data.items()}

            def load(rows):
                self._idx.copy_(idx[rows])
        else:
            (data,) = inputs
            lead, batch_rows = data["sig"].shape[:2]

            def take(j):  # a fresh tensor per step on the CPU, as a single step receives
                return {k: v[j].clone() for k, v in data.items()}

            def load(rows):
                for k, v in data.items():
                    self._batch[k].copy_(v[rows])
        if lead != self.n_steps:
            raise ValueError(
                f"super-batch has a leading axis of {lead}, expected steps_per_call={self.n_steps}"
            )
        noise_shape = self.model.draw_shape(batch_rows * self._rows, data)
        device = next(self.model.parameters()).device
        with profiling.call(self.n_steps) as rec:
            if device.type != "cpu":
                return self._replay(state, data, load, noise_shape, rec)
            rec.marks = profiling.StepMarks(self.n_steps, device, self._unbounded, self.phases)
            rows = []
            with profiling.marking(rec.marks) as marks:
                for j in range(self.n_steps):
                    batch, noise = take(j), self._draw_noise(state, noise_shape)
                    marks.step = j
                    profiling.mark(0)
                    rows.append(self._body(state, batch, noise))
                    profiling.mark(marks.n_marks - 1)
                    state.step += 1
            return torch.stack(rows)

    # ------------------------------------------------------------- graph
    def _bind(self, state: TrainState, data, noise_shape) -> None:
        """Allocate the static buffers at the first call; later calls must
        bring the same state tensors, data (indexed) and shapes."""
        tensors = state.params() + tree_leaves(state.opt_state)
        key = (tensors, data if self.indexed else None, state.mean_loudness, state.std_loudness,
               noise_shape)
        if self._bound is not None:
            bound = self._bound
            same = (len(bound[0]) == len(tensors) and all(a is b for a, b in zip(bound[0], tensors))
                    and (not self.indexed or all(bound[1][k] is data[k] for k in data))
                    and bound[2:] == key[2:])
            if not same:
                raise RuntimeError(
                    "MultiStep: the CUDA graph was captured for other state or data "
                    "tensors, loudness stats or shapes; build a new MultiStep"
                )
            return
        device = tensors[0].device
        u = self.unroll
        self._noise = torch.zeros((u, *noise_shape), dtype=self.model.dtype, device=device)
        self._metrics = torch.zeros((u, len(METRIC_KEYS)), dtype=torch.float32, device=device)
        self._marks = profiling.StepMarks(u, device, self._unbounded, self.phases)
        if self.indexed:
            self._data = data
            self._idx = torch.zeros((u, noise_shape[0]), dtype=torch.int64, device=device)
        else:
            self._batch = {k: torch.zeros((u, *v.shape[1:]), dtype=v.dtype, device=device)
                           for k, v in data.items()}
        self._bound = key

    def _bodies(self, state: TrainState) -> None:
        """`unroll` steps on the static buffers: what the graph holds."""
        for u in range(self.unroll):
            self._marks.step = u
            profiling.mark(0)
            if self.indexed:
                batch = {k: v.index_select(0, self._idx[u]) for k, v in self._data.items()}
            else:
                batch = {k: v[u] for k, v in self._batch.items()}
            self._metrics[u].copy_(self._body(state, batch, self._noise[u]))
            profiling.mark(self._marks.n_marks - 1)

    def _capture(self, state: TrainState) -> None:
        device = self._metrics.device
        tensors = state.params() + tree_leaves(state.opt_state) + list(self.model.buffers())
        saved = [t.detach().clone() for t in tensors]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), profiling.marking(self._marks):
            for _ in range(WARMUP_RUNS):
                self._bodies(state)
        current.wait_stream(side)
        with torch.no_grad():  # the warm-up must not train
            for t, s in zip(tensors, saved):
                t.copy_(s)
        del saved
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()  # as torch.cuda.graph does, before the pool is counted
        before = kernels.counts()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # keeps the graph whose nodes are counted
        t0 = time.perf_counter()
        with torch.cuda.graph(graph), profiling.marking(self._marks):
            self._bodies(state)
        graph.instantiate()
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph_nodes = profiling.graph_nodes(graph) / self.unroll
        after = kernels.counts()
        self.captured = {name: after[name]["captured"] - before[name]["captured"]
                         for name in kernels.MODEL_KERNELS}
        self.graph = graph

    def _replay(self, state: TrainState, data, load, noise_shape,
                rec: profiling.CallRecord) -> torch.Tensor:
        """n_steps / unroll replays; `load(rows)` copies those steps' inputs
        into the static buffers.  `rec`: the call's record."""
        self._bind(state, data, noise_shape)
        u = self.unroll
        out = torch.empty((self.n_steps, len(METRIC_KEYS)), dtype=torch.float32,
                          device=self._metrics.device)
        for r in range(self.n_steps // u):
            rec.replay = r
            rows = slice(r * u, (r + 1) * u)
            with profiling.annotate("multistep.load"):
                load(rows)
            with profiling.annotate("multistep.noise"):
                for i in range(u):  # in step order, as eager steps draw
                    self._noise[i].copy_(self._draw_noise(state, noise_shape))
            if self.graph is None:
                self._capture(state)
            with profiling.annotate("multistep.launch"):
                self.graph.replay()
            self.replays += 1
            kernels.count_replayed(self.captured)
            out[rows].copy_(self._metrics)
            state.step += u
        rec.marks, rec.graph_nodes = self._marks, self.graph_nodes
        return out


def make_train_multi_step(model, tx: Optimizer, config: Config, n_steps: int,
                          unroll: int = 1, mesh: Optional[Mesh] = None) -> MultiStep:
    """multi_step(state, batches) → (n_steps, 3) metrics: `n_steps` steps
    from an (n_steps, B, ...) super-batch on the device (train.py:137-163)."""
    return MultiStep(model, tx, config, n_steps, unroll, indexed=False, mesh=mesh)


def make_train_multi_step_indexed(model, tx: Optimizer, config: Config, n_steps: int,
                                  unroll: int = 1, mesh: Optional[Mesh] = None) -> MultiStep:
    """multi_step(state, data, idx2d) → (n_steps, 3) metrics: `n_steps`
    steps whose batches are gathered from the device-resident cache `data`
    inside the step, from the (n_steps, B) indices (train.py:166-196)."""
    return MultiStep(model, tx, config, n_steps, unroll, indexed=True, mesh=mesh)


def make_eval_step(model, config: Config) -> Callable:
    """eval_step(state, batch, generator) → the model's `eval_outputs`
    without gradients: its outputs plus the loss, the target `sig` and the
    reconstruction `rec` (DDSP's also both multiscale spectrograms,
    `sig_stft` and `rec_stft`; train.py:198-217), what validation and the
    media reports read.  The noise is injected, or drawn from `generator`."""
    scales = tuple(config.train.scales)
    overlap = config.train.overlap

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
        return model.eval_outputs(state, batch, scales, overlap, noise=noise, generator=generator)

    return eval_step


class Trainer:
    """The training loop: logging, validation, checkpoints, exact resume
    and preemption (train.py:220-905).  `mesh` (parallel/mesh.py) selects
    the data-parallel or time-sharded step (train.py:236-305); without one
    the Trainer trains unsharded, whatever config.mesh says, as the JAX
    Trainer does with mesh=None.  `eval_forwards` counts the model forwards
    it ran outside the train steps (validation and the per-log-epoch eval);
    `_multi_step` is the last fit's MultiStep (None when steps_per_call is
    1).  `use_tensorboard` mirrors the metrics to TensorBoard where it
    imports (training/metrics.py); `fit` closes that writer when it returns.

    Across processes each rank gets its rows from the Datamodule (built
    with the same mesh), every rank calls `fit`, and a preemption signal
    must reach every rank (as torchrun forwards it), since the checkpoint
    it triggers ends in a barrier."""

    def __init__(self, config: Config, run_dir: str, *, device="cuda", mesh: Optional[Mesh] = None,
                 use_tensorboard: bool = True):
        if mesh is not None:
            if config.train.batch % mesh.data:
                raise ValueError(f"train.batch={config.train.batch} does not divide over "
                                 f"mesh data={mesh.data}")
            if mesh.time > 1:
                validate_time_sharding(config, mesh)
        self.mesh = mesh
        self._is_primary = mesh is None or mesh.is_primary
        self._spc = max(1, config.train.steps_per_call)
        self._unroll = max(1, config.train.scan_unroll)
        if self._spc % self._unroll:
            raise ValueError(
                f"train.scan_unroll={self._unroll} must divide "
                f"train.steps_per_call={self._spc}"
            )
        self.config = config
        self.run_dir = run_dir
        self.device = resolve_device(device)
        os.makedirs(run_dir, exist_ok=True)
        self.model = load_model(config.model.name, config.model.kwargs).to(self.device)
        self.tx = make_optimizer(config)
        if self._spc > 1:
            refuse_gloo_capture(self.model, mesh)
        self.metrics = MetricsWriter(run_dir, use_tensorboard=use_tensorboard, enabled=self._is_primary)
        self.checkpointer = Checkpointer(run_dir, max_to_keep=config.train.keep_checkpoints,
                                         mesh=mesh)
        self._train_step = make_train_step(self.model, self.tx, config, mesh)
        self._eval_step = make_eval_step(self.model, config)
        self._multi_step: Optional[MultiStep] = None
        if self.device.type == "cuda":
            self._to_device = HostBatchStager(self.device)
        else:
            self._to_device = lambda batch: to_device(batch, self.device)
        self.eval_forwards = 0

    # ------------------------------------------------------------ state
    def init_state(self, mean_loudness=0.0, std_loudness=1.0) -> TrainState:
        """Fresh weights (flax's initializers) and optimizer state; the
        generator that drew the weights then draws the noise."""
        generator = torch.Generator(self.device).manual_seed(self.config.train.seed)
        self.model.init_weights(generator)
        state = TrainState(
            step=0,
            model=self.model,
            opt_state=self.tx.init([p for _, p in self.model.named_parameters()]),
            generator=generator,
            mean_loudness=float(mean_loudness),
            std_loudness=float(std_loudness),
        )
        return state if self.mesh is None else replicate_state(state, self.mesh)

    def resume_or_init(self, mean_loudness=0.0, std_loudness=1.0):
        """(state, resumed): the newest checkpoint if there is one, else a
        fresh state."""
        state = self.init_state(mean_loudness, std_loudness)
        restored = self.checkpointer.restore(state)
        return (state, False) if restored is None else (restored, True)

    def _loudness_stats(self, train_loader):
        """The config's stats; else those frozen in the run's config when
        there is a checkpoint to resume (a resumed run must not change its
        normalization); else computed over the train loader."""
        cfg = self.config
        mean_l, std_l = cfg.data.mean_loudness, cfg.data.std_loudness
        frozen = os.path.join(self.run_dir, "config.yaml")
        if (mean_l is None or std_l is None) and os.path.exists(frozen) \
                and self.checkpointer.latest_step() is not None:
            fcfg = Config.from_yaml(frozen)
            mean_l, std_l = fcfg.data.mean_loudness, fcfg.data.std_loudness
        if mean_l is None or std_l is None:
            if self.mesh is not None and not self.mesh.in_process:
                # each rank's loader holds its rows only: every rank takes the
                # stats of the whole dataset, unshuffled at the global batch
                # (train.py:652-668), so all normalize alike
                from ddsp_pytorch_tpu_torch.data.dataset import DataLoader

                mean_l, std_l = mean_std_loudness(
                    DataLoader(train_loader.dataset, cfg.train.batch, shuffle=False))
            elif hasattr(train_loader, "loudness_stats"):
                mean_l, std_l = train_loader.loudness_stats()
            else:
                mean_l, std_l = mean_std_loudness(train_loader)
        return mean_l, std_l

    # ------------------------------------------------------------ calls
    def _run_single(self, state: TrainState, batch, loader) -> torch.Tensor:
        """One step on a host batch or, from a device-resident loader, on
        the batch of item indices `batch`.  Returns its (1, 3) metrics."""
        if hasattr(loader, "take"):
            batch = loader.take(batch)
        return metrics_row(self._train_step(state, self._to_device(batch)))[None]

    def _run_multi(self, state: TrainState, batches, loader) -> torch.Tensor:
        """One call of steps_per_call steps on the buffered host batches or
        item indices.  Returns their (steps_per_call, 3) metrics."""
        if hasattr(loader, "take_stacked"):
            return self._multi_step(state, loader.device_data, np.stack(batches))
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        return self._multi_step(state, self._to_device(stacked))

    # -------------------------------------------------------------- loop
    def fit(self, datamodule, total_steps: Optional[int] = None) -> TrainState:
        """Train to `total_steps` (default train.steps), resuming from the
        newest checkpoint in the run directory.

        Preemption-safe (train.py:421-447): SIGTERM and SIGINT set a flag;
        at the next call boundary the loop flushes the metrics, checkpoints
        the full state and returns, and `fit` again resumes exactly.  The
        previous handlers are restored on return."""
        preempted = {"flag": False}

        def on_signal(signum, frame):
            preempted["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass
        try:
            return self._fit(datamodule, total_steps, preempted)
        finally:
            self.metrics.end_tensorboard()
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    def _fit(self, datamodule, total_steps, preempted) -> TrainState:
        cfg = self.config
        if total_steps is None:
            total_steps = cfg.train.steps
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        device_indexed = hasattr(train_loader, "take_stacked")
        if device_indexed and train_loader.device != self.device:
            raise ValueError(
                f"the device-resident loader is on {train_loader.device}, the trainer on {self.device}"
            )

        features = self.model.needs_features  # raw crops have no loudness to normalise
        mean_l, std_l = self._loudness_stats(train_loader) if features else (None, None)
        cfg.data.mean_loudness, cfg.data.std_loudness = mean_l, std_l
        if self.mesh is not None:
            self.mesh.barrier()  # every rank has read the frozen config before rank 0 rewrites it
        if self._is_primary:
            cfg.to_yaml(os.path.join(self.run_dir, "config.yaml"))

        state, resumed = self.resume_or_init(*((mean_l, std_l) if features else (0.0, 1.0)))
        start_step = state.step if resumed else 0
        # a captured graph is bound to this fit's state tensors
        self._multi_step = None
        if self._spc > 1:
            make = make_train_multi_step_indexed if device_indexed else make_train_multi_step
            self._multi_step = make(self.model, self.tx, cfg, self._spc, self._unroll, self.mesh)
        steps_per_epoch = max(1, len(train_loader))
        n_epochs = math.ceil(total_steps / steps_per_epoch)
        start_epoch = start_step // steps_per_epoch
        meta = self.checkpointer.best_meta()
        best_loss = meta["loss"] if meta is not None else float("inf")
        sample = next(iter(train_loader))  # the batch of the per-log-epoch eval

        pending = []  # (first step, (n, 3) metrics rows on the device) not yet written
        mean_loss, n_elem = 0.0, 0
        flush_every = max(1, cfg.train.metrics_flush_steps)
        last_flush = state.step
        t_last, s_last = time.perf_counter(), state.step

        def flush():
            nonlocal mean_loss, n_elem, last_flush
            last_flush = state.step
            if not pending:
                return
            values = torch.cat([rows for _, rows in pending]).tolist()
            steps = [first + i for first, rows in pending for i in range(rows.shape[0])]
            for step, (loss, grad_norm, skipped) in zip(steps, values):
                self.metrics.add_scalar("loss", loss, step)
                self.metrics.add_scalar("grad_norm", grad_norm, step)
                self.metrics.add_scalar("update_skipped", int(skipped), step)
                n_elem += 1
                mean_loss += (loss - mean_loss) / n_elem
            pending.clear()

        def run_single(batch):
            pending.append((state.step + 1, self._run_single(state, batch, train_loader)))

        def run_multi(batches):
            pending.append((state.step + 1, self._run_multi(state, batches, train_loader)))

        def housekeeping(prev_step) -> bool:
            """Flush, checkpoint and throughput; True: stop now."""
            nonlocal t_last, s_last
            if state.step - last_flush >= flush_every:
                flush()
            if preempted["flag"]:
                flush()
                self.checkpointer.save(state)
                return True
            every = cfg.train.checkpoint_every_steps
            if every > 0 and state.step // every > prev_step // every:
                self.checkpointer.save(state)
            if state.step - s_last >= 100:
                now = time.perf_counter()
                self.metrics.add_scalar("steps_per_s", (state.step - s_last) / max(now - t_last, 1e-9),
                                        state.step)
                t_last, s_last = now, state.step
            return state.step >= total_steps

        kernels_before = kernels.counts()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t_start, mono_start = time.perf_counter(), time.monotonic()
        buf = []  # batches (or index arrays) awaiting a full call
        for epoch in range(start_epoch, n_epochs):
            train_loader.set_epoch(epoch)
            # a resume mid-epoch skips the batches already trained, so the
            # step → batch mapping matches an uninterrupted run
            skip = start_step % steps_per_epoch if epoch == start_epoch else 0
            source = train_loader.index_batches() if device_indexed else train_loader
            stop = False
            for batch_index, batch in enumerate(source):
                if batch_index < skip:
                    continue
                prev_step = state.step
                if (self._multi_step is not None and state.step + self._spc <= total_steps
                        and not preempted["flag"]):
                    buf.append(batch)
                    if len(buf) < self._spc:
                        continue
                    run_multi(buf)
                    buf.clear()
                else:
                    for b in buf:  # switching to single steps: drain in order
                        run_single(b)
                    buf.clear()
                    run_single(batch)
                stop = housekeeping(prev_step)
                if stop:
                    break
            # buf carries across epochs: with steps_per_call above the
            # epoch's steps a call fills over several epochs, so validation
            # may lag the data stream by up to steps_per_call − 1 batches
            if stop and preempted["flag"]:
                return state
            if state.step - last_flush >= flush_every:
                flush()
            if cfg.train.val_interval_epochs > 0 and epoch % cfg.train.val_interval_epochs == 0:
                self._run_validation(state, val_loader)
            if cfg.train.log_interval_epochs > 0 and epoch % cfg.train.log_interval_epochs == 0:
                flush()
                if n_elem > 0 and mean_loss < best_loss:
                    best_loss = mean_loss
                    self.checkpointer.save_best(self.model.state_dict(), state.step, mean_loss)
                mean_loss, n_elem = 0.0, 0
                self._log_eval(state, sample)
            if state.step >= total_steps:
                break

        if buf and not preempted["flag"] and state.step < total_steps:
            # the final partial call: the epochs are spent, so the leftover
            # batches run as single steps
            prev_step = state.step
            for b in buf:
                run_single(b)
                if state.step >= total_steps:
                    break
            buf.clear()
            housekeeping(prev_step)

        flush()
        if state.step > start_step:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            window = time.perf_counter() - t_start
            self.metrics.add_scalar("train_window_s", window, state.step)
            self.metrics.add_scalar(
                "train_window_steps_per_s", (state.step - start_step) / max(window, 1e-9), state.step
            )
            self._log_window_costs(state.step, kernels_before, mono_start)
        self.checkpointer.save(state)
        return state

    def _log_window_costs(self, step: int, kernels_before: dict, since: float) -> None:
        """What the train window spent besides steps: the CUDA graph's eager
        warm-up runs and its capture (seconds each) and its nodes a step,
        the peak of allocated device memory, each of the models' kernels'
        launches in the window (`kernels_before`: the count table at its
        start), eager (single steps and a capture's warm-up runs) and
        replayed in graphs.  From the window's MultiStep
        calls (their records since `since`, training/profiling.py): the
        median ms a step of each phase of the step (`step_phase_ms/<phase>`:
        the device's on a card, the host's on the CPU) and of the graph
        launch on the host (`host_launch_ms`)."""
        if self._multi_step is not None and self._multi_step.capture_s is not None:
            self.metrics.add_scalar("graph_warmup_s", self._multi_step.warmup_s, step)
            self.metrics.add_scalar("graph_capture_s", self._multi_step.capture_s, step)
            self.metrics.add_scalar("graph_nodes", self._multi_step.graph_nodes, step)
        records = [c for c in profiling.calls() if c.start >= since]
        for phase in self.model.phases:
            ms = [c.phase_ms[phase] for c in records if c.phase_ms and c.phase_ms[phase] is not None]
            if ms:
                self.metrics.add_scalar(f"step_phase_ms/{phase}", float(np.median(ms)), step)
        launch = [c.host_ms["multistep.launch"] / c.steps for c in records if "multistep.launch" in c.host_ms]
        if launch:
            self.metrics.add_scalar("host_launch_ms", float(np.median(launch)), step)
        if self.device.type == "cuda":
            self.metrics.add_scalar("max_memory_allocated_bytes", torch.cuda.max_memory_allocated(self.device),
                                    step)
        now = kernels.counts()
        for name in kernels.MODEL_KERNELS:
            for kind in ("launches", "replayed"):
                self.metrics.add_scalar(f"kernel_{kind}/{name}",
                                        now[name][kind] - kernels_before[name][kind], step)

    def _eval(self, state, batch, seed: int):
        """The eval step on this rank's rows, its noise drawn for the global
        batch as one process on that batch draws it; under a mesh across
        processes the loss is the mean over the ranks (the global batch's,
        the ranks holding equal rows)."""
        self.eval_forwards += 1
        batch = self._to_device(batch)
        generator = torch.Generator(self.device).manual_seed(seed)
        if self.mesh is None:
            return self._eval_step(state, batch, generator)
        noise = self.mesh.data_rows(draw_noise(self.model, generator, batch, self.mesh.data_procs))
        out = self._eval_step(state, batch, noise=noise)
        out["loss"] = self.mesh.mean(out["loss"])
        return out

    def _run_validation(self, state, val_loader) -> None:
        losses, out = [], None
        for batch in val_loader:
            out = self._eval(state, batch, 0)
            losses.append(float(out["loss"]))
        if losses:
            self.metrics.add_scalar("loss/val", float(np.mean(losses)), state.step)
            self._report(out, state.step, "val")

    def _log_eval(self, state, sample_batch) -> None:
        out = self._eval(state, sample_batch, 1)
        self.metrics.add_scalar("loss/train", float(out["loss"]), state.step)
        for key in (k for k in out if k.startswith("loss/")):  # RAVE's terms
            self.metrics.add_scalar(f"{key}/train", float(out[key]), state.step)
        reverb = getattr(self.model, "reverb", None)
        if reverb is not None:
            self.metrics.add_scalar("reverb_decay", float(reverb.decay.detach()), state.step)
            self.metrics.add_scalar("reverb_wet", float(reverb.wet.detach()), state.step)
        self._report(out, state.step, "train")

    def _report(self, out, step: int, stage: str) -> None:
        """The first item's target and reconstruction as wavs, and the
        reconstruction report as a figure where matplotlib imports; rank 0
        only."""
        if not self._is_primary:
            return
        sr = self.config.preprocess.sample_rate
        self.metrics.add_audio(f"sig/{stage}", out["sig"][0], step, sr)
        self.metrics.add_audio(f"rec/{stage}", out["rec"][0], step, sr)
        if not self.model.needs_features:  # the figure plots the controls read from the features
            return
        try:
            plt = pyplot()
        except ImportError:  # no matplotlib: the wavs are the report
            return
        fig = reconstruction_report(out, self.config)
        self.metrics.add_figure(f"reconstruction/{stage}", fig, step)
        plt.close(fig)

    def close(self) -> None:
        self.metrics.close()
