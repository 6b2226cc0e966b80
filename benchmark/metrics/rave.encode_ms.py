"""Device ms a step of RAVE's phase-1 step from its start to the latent:
the PQMF analysis, the encoder and the reparameterisation, the step-mark
phase `encode` (training/profiling.py `RAVE_PHASES`); the median over the
window's calls after the traced one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "encode"))
