"""Device ms a step of the multiscale spectral loss, forward and backward,
inside the real train step: the step-mark phases `loss_fwd` + `loss_bwd`
(training/profiling.py); the median over the window's calls after the
traced one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "loss_fwd", "loss_bwd"))
