"""The traced window: a torch.profiler trace of the card, reduced to the
device's busy time, kernel times by name and the longest idle gaps."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Tuple

import torch

TOP = 10


def union_s(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is not None and e <= end:
            continue
        total += e - (s if end is None else max(s, end))
        end = e
    return total / 1e9


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """Profile the card between `start()` and `stop()`.  `device` holds
    (name, start_ns, end_ns) of every device operation, `host` the host's
    torch operations, `t_start`/`t_stop` the window on the monotonic clock
    and `window_s` its length.  The events are read from the profiler at
    their first use, not in stop(): reading them holds the interpreter
    lock for a while, which a server's threads must not wait on inside the
    window."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = self._events = None
        self.t_start = self.t_stop = None
        self.start_s = 0.0  # how long start() took

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        t = time.monotonic()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.t_start = time.monotonic()
        self.start_s = self.t_start - t
        self._events = None

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_stop = time.monotonic()
        self._prof.__exit__(None, None, None)

    def _read(self):
        if self._events is None:
            cuda = torch.autograd.DeviceType.CUDA
            device_ops, host_ops = [], []
            for e in self._prof.profiler.kineto_results.events():
                rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                (device_ops if e.device_type() == cuda else host_ops).append(rec)
            self._events = (device_ops, host_ops)
        return self._events

    @property
    def device_ops(self):
        return self._read()[0]

    @property
    def host_ops(self):
        return self._read()[1]

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def kernels(self, needle: str = "") -> list:
        """Device kernels (not copies or sets) whose name contains `needle`."""
        return [op for op in self.device_ops
                if needle in op[0] and not op[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device_ops])

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps between them, each named by the host's torch
        operation in progress at the gap's middle (the innermost one)."""
        by_name = defaultdict(int)
        for name, s, e in self.device_ops:
            by_name[name[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = merged([(s, e) for _, s, e in self.device_ops])
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)[:TOP]
        named = []
        for length, s, e in gaps:
            mid = (s + e) // 2
            inside = [(hs, name) for name, hs, he in self.host_ops if hs <= mid <= he]
            what = max(inside)[1] if inside else "no torch operation (Python, sockets, waits)"
            named.append([f"host: {what}"[:160], length / 1e9])
        return {"device_ops": [[n, v / 1e9] for n, v in ops], "idle_gaps": named}
