"""Tracing and profiling hooks (port of ddsp_pytorch_tpu/training/profiling.py).

  * `trace(log_dir, device)`: a torch.profiler capture of the block, with
    the CUDA activity when the device is a card, written to `log_dir` as a
    Chrome trace (chrome://tracing, Perfetto);
  * `annotate(name)`: a labelled host region inside a trace
    (torch.profiler.record_function);
  * `StepTimer`: rolling steps/s and samples/s from wall-clock marks.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from ddsp_pytorch_tpu_torch import resolve_device

TRACE_FILE = "trace.json"


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


def annotate(name: str):
    """Label a host-side region inside a profiler trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling steps/s and samples/s (a window of `horizon` marks)."""

    def __init__(self, samples_per_step: int = 0, horizon: int = 50):
        self.samples_per_step = samples_per_step
        self.horizon = horizon
        self._marks = []

    def mark(self) -> None:
        now = time.perf_counter()
        self._marks.append(now)
        if len(self._marks) > self.horizon:
            self._marks.pop(0)

    @property
    def steps_per_s(self) -> Optional[float]:
        if len(self._marks) < 2:
            return None
        span = self._marks[-1] - self._marks[0]
        return (len(self._marks) - 1) / span if span > 0 else None

    @property
    def samples_per_s(self) -> Optional[float]:
        sps = self.steps_per_s
        return None if sps is None else sps * self.samples_per_step
