"""The program's record of its MultiStep calls (training/profiling.py), as
the readers of the step's phases, the launch span and the graph's nodes
take it: the calls after the traced one, a value a step from each, their
median."""

from __future__ import annotations

import statistics


def after_trace(run) -> list:
    """The records of the calls that started at or after the traced call's
    end: the window's untraced calls after it.  [] without a trace, off a
    card, or where the program keeps no call record."""
    if run.trace is None or run.trace.device.type != "cuda":
        return []
    from ddsp_pytorch_tpu_torch.training import profiling

    calls = getattr(profiling, "calls", None)
    if calls is None:
        return []
    return [c for c in calls() if c.start >= run.trace.t_stop]


def median(run, value):
    """The median over after_trace(run) of value(record), records where it
    is None left out; None where none is left."""
    values = [v for v in map(value, after_trace(run)) if v is not None]
    return float(statistics.median(values)) if values else None


def phase_ms(record, *phases):
    """The device ms a step of `phases` summed, from the call's last
    replay; None where one of them was not read."""
    ms = record.phase_ms
    if not ms or any(ms.get(p) is None for p in phases):
        return None
    return sum(ms[p] for p in phases)
