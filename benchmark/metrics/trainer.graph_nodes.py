"""Nodes a step of the MultiStep's CUDA graph: `cudaGraphGetNodes` on the
captured graph over its steps, counted once at capture
(training/profiling.py); the median over the window's calls after the
traced one."""

from benchmark.lib.calls import median


def read(run):
    return median(run, lambda r: r.graph_nodes)
