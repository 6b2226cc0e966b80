"""Helpers the per-layer readers (benchmark/metrics/) share."""

from __future__ import annotations

from benchmark.lib import flops


def roofline_pct(run, needle: str, rows: int, cost) -> float | None:
    """Share (%) of the bound of `rows` rows that the mean traced launch of
    the kernels named like `needle` reached; None where none ran."""
    if run.trace is None:
        return None
    launches = run.trace.kernels(needle)
    if not launches:
        return None
    mean_s = sum(e - s for _, s, e in launches) / len(launches) / 1e9
    m = run.cfg["model"]
    bound, _ = flops.bound_s(*cost(rows, m["n_harmonic"], m["block_size"]))
    return 100.0 * bound / mean_s


def idle_pct(run) -> float | None:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

