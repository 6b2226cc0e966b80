"""Host ms a step in `graph.replay()` (the CUDA graph's launch): the
`multistep.launch` span's ms in a call over its steps
(training/profiling.py); the median over the window's calls after the
traced one."""

from benchmark.lib.calls import median


def read(run):
    return median(run, lambda r: r.host_ms["multistep.launch"] / r.steps
                  if "multistep.launch" in r.host_ms else None)
