"""Device ms a step of RAVE's phase-1 loss: both distances with their
fused gradients, the PQMF syntheses, the loudness and the KL term, the
step-mark phase `loss` (training/profiling.py `RAVE_PHASES`); the median
over the window's calls after the traced one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "loss"))
