"""Device ms a step of RAVE's backward (`autograd.grad` over the trained
leaves): the step-mark phase `backward` of a RAVE step (training/
profiling.py `RAVE_PHASES`; CREPE's step has a phase of that name too, so
a record without RAVE's `encode` phase is not read); the median over the
window's calls after the traced one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "backward") if "encode" in (r.phase_ms or {}) else None)
