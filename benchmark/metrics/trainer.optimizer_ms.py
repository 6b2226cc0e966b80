"""Device ms a step of Adam, the NaN guard and the metrics row inside the
real train step: the step-mark phase `optimizer` (training/profiling.py);
the median over the window's calls after the traced one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "optimizer"))
