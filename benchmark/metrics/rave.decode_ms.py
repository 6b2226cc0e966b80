"""Device ms a step of RAVE's generator (the latent to the bands, no
noise in phase 1): the step-mark phase `decode` (training/profiling.py
`RAVE_PHASES`); the median over the window's calls after the traced
one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "decode"))
