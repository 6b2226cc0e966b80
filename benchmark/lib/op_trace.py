"""Device kernels matched to the host operators that launched them.

A kernel is tied to its launch as torch's own profiler ties it: the
kernel's linked correlation id is the id of the host operator in progress
on the launching thread (a host event whose own link is 0).  The operators
that enclose that one on its thread, by time, launched it too; so a kernel
counts for an operator name when an operator of that name is, or encloses,
its launching operator.  Kernel names are never read: cuDNN's change with
the algorithm it picks.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, List, Tuple

import torch

from benchmark.lib.trace import Trace


def launched_by(events: Iterable, names) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of each device kernel (not a copy or a set)
    launched inside a host operator named in `names`."""
    events = list(events)
    cuda = torch.autograd.DeviceType.CUDA
    ops = {e.correlation_id(): (e.start_thread_id(), e.start_ns()) for e in events
           if e.device_type() != cuda and e.linked_correlation_id() == 0}
    spans = defaultdict(list)  # thread → sorted (start, end) of the named operators
    for e in events:
        if e.device_type() != cuda and e.linked_correlation_id() == 0 and e.name() in names:
            spans[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for v in spans.values():
        v.sort()
    out = []
    for k in events:
        if k.device_type() != cuda or k.name().startswith(("Memcpy", "Memset")):
            continue
        launch = ops.get(k.linked_correlation_id())
        if launch is not None and _encloses(spans.get(launch[0], []), launch[1]):
            out.append((k.name(), k.start_ns(), k.start_ns() + k.duration_ns()))
    return out


def _encloses(sorted_spans, t) -> bool:
    """Whether one of the sorted, non-overlapping (start, end) spans holds t."""
    i = bisect.bisect_right(sorted_spans, (t, float("inf")))
    return i > 0 and sorted_spans[i - 1][0] <= t <= sorted_spans[i - 1][1]


class OpTrace(Trace):
    """A `Trace` that also finds the kernels named host operators launched."""

    def launched_by(self, names) -> List[Tuple[str, int, int]]:
        return launched_by(self._prof.profiler.kineto_results.events(), names)
