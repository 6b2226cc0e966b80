"""The port's tracing: the profiler capture, the host span, the call record
and the step marks of the graphed train step.

  * `trace(log_dir, device)`: a torch.profiler capture of the block, with
    the CUDA activity when the device is a card, written to `log_dir` as a
    Chrome trace (chrome://tracing, Perfetto); `device_kernels(prof)`: a
    capture's CUDA kernels and their busy time;
  * `annotate(name)`: the program's host span.  Its duration, from two
    reads of `time.monotonic_ns()`, always goes to the current call's
    record and to `spans()`; while a torch profiler records, the span is
    also a range of that name among the profiler's host operations (a
    `cpu_op`: a `record_function` range is a user annotation, which the
    profiler mirrors onto the device's timeline over the kernels launched
    inside it, and over a graph launch that covers the replay's idle
    gaps);
  * the call record: `call(steps)` opens the record of one `MultiStep`
    call (training/train.py) or one CREPE step (train_crepe.py
    `CrepeTrainer`); `calls()` returns the last MAX_CALLS of them, oldest
    first, and `reset()` clears them.  A record holds the call's start and
    end (`time.monotonic()`), its steps, the host ms of each span name
    inside it, the device ms a step of each phase of its last replay (the
    phases of its marks) and the captured graph's nodes a step;
  * the step marks: `mark(i)` and `mark_on_grad(i, tensors)` stamp mark i
    of the step in progress while a step path runs its bodies
    (`marking(marks)`), and do nothing else anywhere: a `None` check,
    no hook registered.  On a card a mark is a CUDA timing event recorded
    on the current stream (`external=True`, so under stream capture it is
    an event-record node that every replay records again); on the CPU it
    is the host clock.

`MultiStep`'s mark i (`PHASES`) sits at (0) the step's start, (1) the NN's
controls ready, (2) the signal ready, (3) the loss ready, (4) the signal's
gradient ready, (5) the gradients of the NN's outputs ready, (6) every
parameter's gradient returned, (7) the update and the metrics row written;
the CREPE step's (`CREPE_PHASES`) at (0) its start, (1) the batch
synthesized, (2) the loss ready, (3) the gradients returned, (4) the update
written; RAVE's phase-1 step in `MultiStep` (`RAVE_PHASES`) at (0) its
start, (1) the bands analysed, encoded and the latent drawn, (2) the
generator's bands ready, (3) the loss ready (both distances with their
fused gradients, the synthesis bank, the loudness and the KL), (4) every
trained leaf's gradient returned, (5) the update and the metrics row
written.  Phase i lies between marks i and i + 1.  The times of a call's
last replay (an eager step's own) are read, without waiting, when the next
call starts or `calls()` is asked, and only if the card has finished them
by then (a caller that pulled the call's metrics or loss has); else that
call's phases stay None.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from ddsp_pytorch_tpu_torch import resolve_device

TRACE_FILE = "trace.json"
PHASES = ("nn_fwd", "synth_fwd", "loss_fwd", "loss_bwd", "synth_bwd", "nn_bwd", "optimizer")
N_MARKS = len(PHASES) + 1
CREPE_PHASES = ("synth", "forward", "backward", "optimizer")
RAVE_PHASES = ("encode", "decode", "loss", "backward", "optimizer")
MAX_CALLS = 4096
MAX_SPANS = 8192


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block on the host and, for a CUDA `device`, on the card;
    on exit write log_dir/trace.json.  Yields the profiler."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def device_kernels(prof):
    """(the CUDA kernel events of a torch.profiler trace, their busy time in
    ms: the union of their intervals)."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return kernels, busy_us / 1e3


# ------------------------------------------------------------ step marks
class StepMarks:
    """The marks of `steps` consecutive steps on `device`: a CUDA timing
    event per mark and step on a card, host-clock stamps on the CPU.
    `phases` names the spans between consecutive marks (len(phases) + 1
    marks a step; `MultiStep`'s are `PHASES`); `step` is the step whose
    marks are being stamped; `unbounded` names the phases this step path
    cannot bound (read as None)."""

    def __init__(self, steps: int, device: torch.device, unbounded: Sequence[str] = (),
                 phases: Sequence[str] = PHASES):
        self.cuda = device.type == "cuda"
        self.steps = steps
        self.phases = tuple(phases)
        self.n_marks = len(self.phases) + 1
        self.unbounded = frozenset(unbounded)
        self.step = 0
        if self.cuda:
            self._events = [[torch.cuda.Event(enable_timing=True, external=True)
                             for _ in range(self.n_marks)] for _ in range(steps)]
        # host stamps; on a card they say which marks the capture recorded
        self._ns: List[List[Optional[int]]] = []
        self.reset()

    def reset(self) -> None:
        """Forget which marks were stamped: the next run of the bodies
        stamps them anew (on a card, the capture: what every replay
        records)."""
        self._ns = [[None] * self.n_marks for _ in range(self.steps)]

    def mark(self, i: int, step: Optional[int] = None) -> None:
        s = self.step if step is None else step
        self._ns[s][i] = time.perf_counter_ns()
        if self.cuda:
            self._events[s][i].record()

    def on_grad(self, i: int, tensors) -> None:
        """Mark i once every tensor of `tensors` that needs a gradient has
        received it (a hook on each; the last to fire marks)."""
        needs = [t for t in tensors if t.requires_grad]
        left, step = [len(needs)], self.step

        def hook(_grad):
            left[0] -= 1
            if left[0] == 0:
                self.mark(i, step)

        for t in needs:
            t.register_hook(hook)

    def ready(self) -> bool:
        """True once the card has passed every recorded mark (never waits)."""
        if not self.cuda:
            return True
        return all(self._events[s][i].query() for s in range(self.steps) for i in range(self.n_marks)
                   if self._ns[s][i] is not None)

    def phase_ms(self) -> Dict[str, Optional[float]]:
        """ms a step of each phase, the mean over the steps; None where a
        step lacks one of the phase's marks, or the path cannot bound it.
        On a card call only when `ready()`."""
        out: Dict[str, Optional[float]] = {}
        for k, phase in enumerate(self.phases):
            if phase in self.unbounded or any(row[k] is None or row[k + 1] is None for row in self._ns):
                out[phase] = None
                continue
            if self.cuda:
                total = sum(ev[k].elapsed_time(ev[k + 1]) for ev in self._events)
            else:
                total = sum(row[k + 1] - row[k] for row in self._ns) / 1e6
            out[phase] = total / self.steps
        return out


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The top-level nodes of a captured graph built with `keep_graph=True`
    (`cudaGraphGetNodes` on `raw_cuda_graph()`, through the libcudart that
    torch loaded, found by its soname)."""
    lib = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    get_nodes = lib.cudaGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = get_nodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed with CUDA error {err}")
    return count.value


_marks: Optional[StepMarks] = None  # the marks of the MultiStep running its bodies


@contextlib.contextmanager
def marking(marks: StepMarks):
    """Stamp `marks` at every mark inside the block (a MultiStep's step
    bodies: warm-up, capture, the CPU loop)."""
    global _marks
    marks.reset()
    _marks = marks
    try:
        yield marks
    finally:
        _marks = None


def mark(i: int) -> None:
    """Mark i of the step in progress; nothing outside `marking`."""
    if _marks is not None:
        _marks.mark(i)


def mark_on_grad(i: int, *tensors: torch.Tensor) -> None:
    """Mark i when the last of `tensors` to receive its gradient has it;
    outside `marking`, nothing (no hook is registered)."""
    if _marks is not None:
        _marks.on_grad(i, tensors)


# ------------------------------------------------------------ call record
@dataclass
class CallRecord:
    """One MultiStep call.  `start`/`end`: `time.monotonic()`;
    `host_ms`: the summed ms of each span name inside the call;
    `phase_ms`: device ms a step of each phase of the last replay (None
    until read, or where it could not be read); `graph_nodes`: the
    captured graph's nodes a step (None on the CPU)."""

    index: int
    start: float
    steps: int
    end: Optional[float] = None
    host_ms: Dict[str, float] = field(default_factory=dict)
    phase_ms: Optional[Dict[str, Optional[float]]] = None
    graph_nodes: Optional[float] = None
    replay: int = 0  # the replay in progress: the parent of the spans inside
    marks: Optional[StepMarks] = field(default=None, repr=False)


_calls: Deque[CallRecord] = deque(maxlen=MAX_CALLS)
# (name, call index or None, replay, start_ns, end_ns) on time.monotonic_ns()
_spans: Deque[Tuple[str, Optional[int], int, int, int]] = deque(maxlen=MAX_SPANS)
_counter = itertools.count()
_current: Optional[CallRecord] = None
_pending: Optional[CallRecord] = None  # a card call whose marks are not read yet


def _read_pending(drop: bool) -> None:
    """Read the pending call's phases if the card is past them; else leave
    them for later, or with `drop` give up (its events are recorded again
    by the next replay)."""
    global _pending
    rec = _pending
    if rec is None:
        return
    if rec.marks.ready():
        rec.phase_ms = rec.marks.phase_ms()
    elif not drop:
        return
    rec.marks, _pending = None, None


@contextlib.contextmanager
def call(steps: int):
    """The record of one call of `steps` steps, appended to `calls()` when
    the block ends.  The caller may set `marks` (stamped by the block's
    last bodies) and `graph_nodes` on the yielded record."""
    global _current, _pending
    _read_pending(drop=True)
    rec = CallRecord(index=next(_counter), start=time.monotonic(), steps=steps)
    _current = rec
    try:
        yield rec
    finally:
        _current = None
    rec.end = time.monotonic()
    _calls.append(rec)
    if rec.marks is not None:
        _pending = rec
        _read_pending(drop=not rec.marks.cuda)


def calls() -> List[CallRecord]:
    """The recorded calls, oldest first (the last call's phases read if
    the card is past them)."""
    _read_pending(drop=False)
    return list(_calls)


def spans() -> List[Tuple[str, Optional[int], int, int, int]]:
    """The last MAX_SPANS spans: (name, call index, replay, start_ns,
    end_ns) on `time.monotonic_ns()`; the call index is None outside a
    call."""
    return list(_spans)


def reset() -> None:
    """Forget every recorded call and span."""
    global _pending
    _calls.clear()
    _spans.clear()
    _pending = None


class annotate:
    """The program's host span `name`: its duration goes to the current
    call's record (`host_ms`) and to `spans()`; while a torch profiler
    records, it is also a host range of the profiler's (module
    docstring)."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        rec = _current
        if rec is None:
            _spans.append((self.name, None, 0, self._t0, t1))
        else:
            _spans.append((self.name, rec.index, rec.replay, self._t0, t1))
            rec.host_ms[self.name] = rec.host_ms.get(self.name, 0.0) + (t1 - self._t0) / 1e6
        return False
