"""Device ms a step of the NN's forward (the encoder's too) inside the
real train step: the step-mark phase `nn_fwd`, from events captured in the
MultiStep graph (training/profiling.py); the median over the window's
calls after the traced one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "nn_fwd"))
